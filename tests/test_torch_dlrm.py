"""DLRM end to end against the JAX package, from a converted JAX init:
the converter, forward probabilities, loss and per-parameter gradients
(f32 table), and the embedding init distribution.

Gradient tolerance: the MLPs compute in bf16 (the JAX dtype policy), and
a bias gradient is a bf16 sum over the batch that the two frameworks
round at different points, so each leaf's gradient agrees to 2e-2 of
that leaf's largest entry (measured: ≤ 1.3e-2 for bias leaves; the kernel
and table leaves agree far closer).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.embedding.table import Embedding as JaxEmbedding
from recommender_tpu.models.dlrm import DLRM as JaxDLRM
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu_torch.convert import (
    flax_to_state_dict,
    jax_leaf_order,
    load_flax_params,
)
from recommender_tpu_torch.core.mesh import Mesh
from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.models import DLRM, make_ctr_task

SMALL = dict(embed_dim=8, bottom_units=(32, 16, 8), top_units=(32, 16, 1))


@functools.lru_cache(maxsize=None)
def _jax_dlrm(vocab, table_dtype="float32"):
    """(flax model, params, batch); cached across tests (init is a jit)."""
    model = JaxDLRM(vocab_size=vocab, embed_param_dtype=jnp.dtype(table_dtype), **SMALL)
    batch = SyntheticCTR(vocab_size=vocab, seed=0).sample(256, 1)
    params, _ = jax_init_model(model, {k: v[:8] for k, v in batch.items()})
    return model, params, batch


def _path_name(path) -> str:
    keys = [p.key for p in path]
    leaf = "weight" if keys[-1] == "kernel" else keys[-1]
    return ".".join(keys[:-1] + [leaf])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_converter_maps_every_leaf(table_dtype):
    _, params, _ = _jax_dlrm(1000, table_dtype)
    state = flax_to_state_dict(jax.tree.map(np.asarray, params))
    model = DLRM(1000, embed_param_dtype=getattr(torch, table_dtype), **SMALL)
    assert set(state) == set(model.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = _path_name(path)
        want = np.asarray(leaf.astype(jnp.float32))
        if path[-1].key == "kernel":
            want = want.T
        got = state[name]
        assert got.dtype == getattr(torch, str(leaf.dtype)), name
        np.testing.assert_array_equal(got.float().numpy(), want)
    # the port's leaf order is JAX's flatten order (it keys stochastic rounding)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    names = [n for n, _ in jax_leaf_order(model)]
    assert names == [_path_name(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


def test_load_rejects_mismatched_params():
    _, params, _ = _jax_dlrm(1000)
    model = DLRM(400, **SMALL)  # table shape differs
    with pytest.raises(ValueError):
        load_flax_params(model, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_dlrm_forward_and_loss_match_jax(table_dtype):
    jm, params, batch = _jax_dlrm(1000, table_dtype)
    want = np.asarray(jm.apply({"params": params}, batch))
    model = DLRM(1000, embed_param_dtype=getattr(torch, table_dtype), **SMALL)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb)
    assert got.dtype == torch.float32 and got.shape == (256,)
    # same f32/bf16 operations in the same order: measured bit-equal; 1e-6
    # allows for a different CPU GEMM blocking
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    jloss, _ = jax_make_ctr_task(jm)
    per_ex, _, _ = jloss(params, {}, batch, None, True)
    loss_fn, _ = make_ctr_task(model)
    with torch.no_grad():
        ours, aux = loss_fn(tb, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(per_ex), rtol=0, atol=1e-5)
    assert abs(float(aux["prob_mean"]) - float(want.mean())) < 1e-6


def test_dlrm_gradients_match_jax():
    jm, params, batch = _jax_dlrm(1000)
    jloss, _ = jax_make_ctr_task(jm)

    def scalar(p):
        per_ex, _, _ = jloss(p, {}, batch, None, True)
        return jnp.mean(per_ex)

    grads = jax.grad(scalar)(params)
    model = DLRM(1000, **SMALL)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    loss_fn, _ = make_ctr_task(model)
    per_ex, _ = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, True)
    per_ex.mean().backward()
    named = dict(model.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = _path_name(path)
        got = named[name].grad.numpy()
        want = np.asarray(g)
        if path[-1].key == "kernel":
            want = want.T
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want).max() <= 2e-2 * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_init_bound_and_std(dtype):
    """U(-√(3/D), √(3/D)) — 0.612 at D = 8 — with std √(1/D); the JAX init
    has the same statistics (the RNG streams differ)."""
    V, D = 20000, 8
    bound = np.sqrt(3.0 / D)
    ours = Embedding(V, D, param_dtype=dtype, generator=torch.Generator().manual_seed(0))
    assert ours.embedding.dtype == dtype
    t = ours.embedding.detach().float().numpy()
    jt = np.asarray(
        JaxEmbedding(V, D).init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]["embedding"]
    )
    assert abs(np.abs(jt).max() - 0.6124) < 1e-3
    for arr in (t, jt):
        assert np.abs(arr).max() <= bound * (1 + 2**-8)
        assert abs(arr.std() / np.sqrt(1.0 / D) - 1.0) < 0.01
        assert abs(arr.mean()) < 0.01


def test_unported_options_raise():
    # row-sharded tables and their exchanges are ported (tests/test_torch_sharded.py);
    # without a mesh a partitioned table is whole, as over one device in JAX
    assert Embedding(10, 4, partition="model").embedding.shape == (10, 4)
    assert not Embedding(10, 4, partition="model", lookup_mode="a2a").sharded
    with pytest.raises(ValueError, match="lookup_mode"):
        Embedding(10, 4, lookup_mode="ring")
    with pytest.raises(ValueError, match="not divisible"):
        Embedding(10, 4, partition="model", mesh=Mesh(1, 4))
    # a dedup plan is ported (tests/test_torch_dedup.py); one for other ids is refused
    plan = {k: torch.zeros(3, dtype=torch.int32) for k in ("perm", "slot", "uniq")}
    with pytest.raises(ValueError):
        Embedding(10, 4)(torch.zeros(2, dtype=torch.int32), dedup_plan=plan)
    with pytest.raises(ValueError):
        DLRM(10, embed_dim=8, bottom_units=(32, 16))
