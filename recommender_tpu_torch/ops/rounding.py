"""Stochastic rounding f32 → bf16 for low-precision parameter updates.

Port of ``recommender_tpu/ops/rounding.py``. bf16 is the upper 16 bits of
f32, so truncation is round-down: add a uniform 16-bit integer to the f32
bit pattern, then clear the low 16 bits. The carry promotes the value to
the next bf16 with probability (x - down) / (up - down), so E[sr(x)] = x;
bf16-exact values are untouched. Non-finite values bypass the add.

Keys are two uint32 words held on the host as a tuple of Python ints —
the words of a JAX threefry key (``jax.random.key_data(key)``).
``prng_key`` and ``fold_in`` below reproduce ``jax.random.PRNGKey`` and
``jax.random.fold_in`` for the default threefry2x32 implementation, so the
port draws the same rounding noise as the JAX package for the same seed,
step and leaf (``tests/test_torch_rounding.py`` pins it bitwise). They run
in pure Python: a key costs 20 rounds of 32-bit arithmetic per derivation.

Device arithmetic: torch's uint32 supports few operations and int32 ``>>``
is arithmetic, so the murmur3 finalizer runs in int64 and masks to 32 bits
after every operation. Products are split into 16-bit halves so that no
int64 intermediate overflows.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

Key = tuple[int, int]


# ------------------------------------------------------------ threefry keys
def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 (20 rounds) of one counter pair, as jax lowers it."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """Words of ``jax.random.PRNGKey(seed)`` (threefry, 32-bit seed)."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside the 32-bit range")
    return 0, seed


def fold_in(key: Key, data: int) -> Key:
    """Words of ``jax.random.fold_in(key, data)``."""
    return _threefry2x32(key, 0, int(data) & _M32)


# ------------------------------------------------------------- device noise
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) without overflow."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_noise_u16(shape, key: Key, device=None, offset: int = 0) -> torch.Tensor:
    """Uniform 16-bit noise (int64 values in [0, 2^16)): the murmur3
    finalizer over (element index ⊕ key words), deterministic per
    (key, element index). Same bits as the JAX function for the same key
    words. The element indices start at ``offset``: a row shard of a
    table passes its first element's index in the whole table, so it draws
    the whole table's noise for its elements, as a row-sharded array does
    under JAX."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    k0, k1 = key
    x = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x = (_mul32(x, 0x9E3779B9) + k0) & _M32
    x = x ^ k1
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x & 0xFFFF).reshape(shape)


def stochastic_round_to(x: torch.Tensor, dtype, key: Key, offset: int = 0) -> torch.Tensor:
    """Round ``x`` to ``dtype`` stochastically (unbiased); identity cast for
    f32/f64 targets. Only bfloat16 is supported as a low-precision target
    (it is the truncation of f32; f16 is not). ``offset``: the flat index
    of ``x``'s first element in the array it is a row shard of."""
    if dtype != torch.bfloat16:
        if dtype in (torch.float32, torch.float64):
            return x.to(dtype)
        raise ValueError(f"stochastic_round_to: unsupported target {dtype}")
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64) & _M32
    noise = _hash_noise_u16(x.shape, key, device=x.device, offset=offset)
    hi = ((bits + noise) & _M32) >> 16
    # Non-finite values bypass the add. The result is assembled as bf16 bits
    # rather than cast, because torch's f32→bf16 cast writes NaN as 0xFFFF
    # where XLA keeps the sign over the canonical quiet NaN 0x7FC0.
    top = bits >> 16
    hi = torch.where(torch.isinf(x), top, hi)
    hi = torch.where(torch.isnan(x), (top & 0x8000) | 0x7FC0, hi)
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)  # signed 16-bit pattern
    return hi.to(torch.int16).view(torch.bfloat16)


def is_low_precision(dtype) -> bool:
    """True for floating dtypes narrower than f32 (SR-apply candidates)."""
    return dtype.is_floating_point and dtype.itemsize < 4
