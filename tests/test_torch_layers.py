"""The port's layers against the JAX package's, from converted params.

Tolerances:
* f32 compute: ≤ 1e-5 — the same f32 operations, summed in other orders.
* bf16 compute (the MLP default): ≤ 2e-2 abs — each layer rounds its
  inputs, weights and outputs to bf16 (relative 2^-8); the two frameworks
  may round a product to neighbouring bf16 values.
* DotInteraction: both sides round the inputs to bf16 and accumulate the
  products in f32, so only the f32 summation order differs: ≤ 1e-5 rel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from recommender_tpu.nn import interactions as jax_inter
from recommender_tpu.nn import losses as jax_losses
from recommender_tpu.nn.mlp import MLP as JaxMLP
from recommender_tpu_torch.convert import load_flax_params
from recommender_tpu_torch.nn import interactions, losses
from recommender_tpu_torch.nn.mlp import MLP


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize(
    "compute,final,atol",
    [
        ("float32", None, 1e-5),
        ("float32", "sigmoid", 1e-5),
        ("bfloat16", "relu", 2e-2),
        ("bfloat16", "sigmoid", 2e-2),
    ],
)
def test_mlp_matches_flax(compute, final, atol):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 13)).astype(np.float32)
    units = (32, 16, 8)
    jfinal = {None: None, "relu": jax.nn.relu, "sigmoid": jax.nn.sigmoid}[final]
    tfinal = {None: None, "relu": F.relu, "sigmoid": torch.sigmoid}[final]
    jm = JaxMLP(units, final_activation=jfinal, compute_dtype=jnp.dtype(compute))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    tm = MLP(13, units, final_activation=tfinal, compute_dtype=getattr(torch, compute))
    load_flax_params(tm, _np_tree(params))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


def test_mlp_init_matches_flax_statistics():
    """lecun-normal kernels (truncated at 2σ), zero biases; the RNG streams
    differ, so compare the distributions."""
    tm = MLP(512, (256,), generator=torch.Generator().manual_seed(0))
    w = tm.Dense_0.weight.detach().numpy()
    jw = np.asarray(
        JaxMLP((256,)).init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))["params"]["Dense_0"]["kernel"]
    )
    std = np.sqrt(1.0 / 512)
    for arr in (w, jw):
        assert abs(arr.std() / std - 1.0) < 0.02
        assert np.abs(arr).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert not tm.Dense_0.bias.detach().any()


@pytest.mark.parametrize("self_int", [False, True])
@pytest.mark.parametrize("skip", [True, False])
def test_dot_interaction_matches_jax(self_int, skip):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 27, 16)).astype(np.float32)
    layer = jax_inter.DotInteraction(self_interaction=self_int, skip_gather=skip)
    want = np.asarray(layer.apply({}, jnp.asarray(x)))
    got = interactions.DotInteraction(self_interaction=self_int, skip_gather=skip)(
        torch.from_numpy(x)
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fm_cross_matches_jax():
    x = np.random.default_rng(2).normal(size=(16, 5, 8)).astype(np.float32)
    want = np.asarray(jax_inter.fm_cross(jnp.asarray(x)))
    got = interactions.fm_cross(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bce_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(256,)) * 4).astype(np.float32)
    labels = (rng.random(256) < 0.5).astype(np.float32)
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    probs[:4] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # the EPS clip
    for ours, ref, arg in (
        (losses.binary_cross_entropy, jax_losses.binary_cross_entropy, probs),
        (losses.bce_with_logits, jax_losses.bce_with_logits, logits),
    ):
        want = np.asarray(ref(jnp.asarray(arg), jnp.asarray(labels)))
        got = ours(torch.from_numpy(arg), torch.from_numpy(labels)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
