"""Stochastic rounding and its keys: the port against the JAX package,
bit for bit. Given the same two key words, the murmur3 noise, the bf16
truncation and the non-finite bypass are integer arithmetic, so nothing
here has a tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.ops import rounding as jax_rounding
from recommender_tpu_torch.ops import rounding


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 3])
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert rounding.prng_key(seed) == _words(key)
    for data in (0, 1, 2, 0x5EED, 1000, 2**31 - 1, 2**32 - 1):
        assert rounding.fold_in(rounding.prng_key(seed), data) == _words(
            jax.random.fold_in(key, data)
        ), data
    # nested derivations, as the Trainer and Adam chain them
    k = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 17)
    ours = rounding.fold_in(rounding.fold_in(rounding.prng_key(seed), 0x5EED), 17)
    assert ours == _words(k)


@pytest.mark.parametrize("shape", [(1,), (1000,), (37, 16), (4, 5, 6)])
def test_hash_noise_bitwise(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    ref = np.asarray(jax_rounding._hash_noise_u16(shape, key))
    ours = rounding._hash_noise_u16(shape, _words(key)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


def _sr_inputs() -> np.ndarray:
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * np.float32(3.0)
    x[:1024] *= np.float32(1e-30)  # denormal-adjacent magnitudes
    special = np.array(
        [
            0x7F800000, 0xFF800000,  # ±inf
            0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA12345,  # NaNs
            0x7F7FFFFF, 0xFF7FFFFF,  # ±max finite: may carry into ±inf
            0x3F800000, 0xC0200000, 0x3E200000, 0x00000000, 0x80000000,  # bf16-exact
        ],
        np.uint32,
    ).view(np.float32)
    return np.concatenate([special, x])


@pytest.mark.parametrize("leaf", [0, 1, 12])
def test_stochastic_round_bitwise(leaf):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5), leaf)
    x = _sr_inputs()
    ref = np.asarray(jax_rounding.stochastic_round_to(x, jnp.bfloat16, key)).view(np.uint16)
    ours = rounding.stochastic_round_to(torch.from_numpy(x), torch.bfloat16, _words(key))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(ours), ref)


def test_stochastic_round_keeps_exact_values():
    x = torch.tensor([0.0, 1.0, -2.5, 0.15625, 3.0e38], dtype=torch.float32)
    x = x.to(torch.bfloat16).to(torch.float32)  # bf16-exact
    for s in range(5):
        r = rounding.stochastic_round_to(x, torch.bfloat16, rounding.prng_key(s))
        assert torch.equal(r.to(torch.float32), x)


def test_stochastic_round_unbiased_sub_ulp():
    ulp = 2.0**-7  # bf16 ulp at 1.0
    x = torch.full((4096,), 1.0 + ulp / 4, dtype=torch.float32)
    r = rounding.stochastic_round_to(x, torch.bfloat16, rounding.prng_key(0)).float()
    assert set(r.unique().tolist()) <= {1.0, 1.0 + ulp}
    assert abs(float((r > 1.0).float().mean()) - 0.25) < 0.03  # 3σ ≈ 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_f32_target_is_identity_cast(dtype):
    x = torch.tensor([1.0000001, -3.7, float("inf")], dtype=torch.float32)
    r = rounding.stochastic_round_to(x, dtype, rounding.prng_key(0))
    assert r.dtype == dtype
    assert torch.equal(r, x.to(dtype))


def test_unsupported_target_raises():
    with pytest.raises(ValueError):
        rounding.stochastic_round_to(torch.ones(2), torch.float16, (0, 0))


def test_is_low_precision():
    assert rounding.is_low_precision(torch.bfloat16)
    assert rounding.is_low_precision(torch.float16)
    assert not rounding.is_low_precision(torch.float32)
    assert not rounding.is_low_precision(torch.int8)
