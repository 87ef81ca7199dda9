"""Stochastic rounding of f32 values to bf16, as the configuration states
it for a bf16 table's writes (moments and parameters).

The algorithm of the JAX package's ``ops/rounding.py``, written again:
a uniform 16-bit number is added to the f32 bit pattern and the low 16
bits are cleared, so ``x`` rounds up with probability (x - down) / (up -
down). The 16 bits are the murmur3 finalizer of (element index, key),
and keys are threefry-2x32 words derived as ``jax.random.PRNGKey`` and
``fold_in`` derive them, so for the same seed, step and leaf the noise is
the same bits as the configuration's rounding draws.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(key: tuple[int, int], x0: int, x1: int) -> tuple[int, int]:
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


def prng_key(seed: int) -> tuple[int, int]:
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside the 32-bit range")
    return 0, int(seed)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return _threefry2x32(key, 0, int(data) & _M32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def noise_u16(n: int, key: tuple[int, int], device) -> torch.Tensor:
    """16 uniform bits (int64 in [0, 2^16)) for elements 0 .. n-1."""
    k0, k1 = key
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul32(x, 0x9E3779B9) + k0) & _M32
    x = x ^ k1
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x & 0xFFFF


def round_bf16(x: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """``x`` (f32, finite) stochastically rounded to bf16, returned as f32
    values."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64) & _M32
    bits = ((bits + noise_u16(x.numel(), key, x.device).view(x.shape)) & 0xFFFF0000)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)
