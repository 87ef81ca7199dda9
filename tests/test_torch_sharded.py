"""The port's row-sharded embedding exchanges against the JAX package.

Port ranks are CPU processes over gloo (``torch_dist_workers.spawn``); the
JAX side runs the same tables, ids and weights on meshes of the
8-virtual-device CPU platform (``tests/conftest.py``). Each rank's rows of
a batch are its data coordinate's contiguous share, as JAX's batch
sharding lays them out.

Tolerances: lookup outputs within 1e-6 (a gather and a sum with zeros);
table gradients within 1e-5 of each one's largest entry (K1 sums each
row's cotangents in f32, in the port's sorted order). On a data axis the
port's table gradient is the data group's average, as the Trainer's local
mean loss wants it, where JAX's is the gradient of the global sum: the test
scales by the data size. Overflow counts equal exactly. One DLRM step at
(2, 2) from a converted JAX init: loss within 1e-5; the table's gradient
within 1e-2 of its largest entry (the MLPs compute in bf16 in both, and
round at different points; ``tests/test_torch_dlrm.py`` holds 2e-2); the
updated table within 1e-5 wherever that gradient is resolved (over 1e-2 of
the largest):
the first Adam step moves an element by lr times the sign of its gradient,
so where the gradient is a rounding error the sign is too, and there the
two tables may differ by up to 2 lr. bf16 + SR at model 2: bit for bit
against one rank.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from recommender_tpu.core.mesh import MeshSpec as JaxMeshSpec
from recommender_tpu.core.mesh import make_mesh as jax_make_mesh
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from recommender_tpu.embedding import sharded as jax_sharded
from recommender_tpu.models.dlrm import DLRM as JaxDLRM
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.parallel.partitioning import param_shardings
from recommender_tpu_torch.core.mesh import make_mesh
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.embedding import sharded
from recommender_tpu_torch.models import DLRM, make_ctr_task


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, D = 64, 8


def _jax_mesh(spec):
    return jax_make_mesh(JaxMeshSpec(*spec), devices=jax.devices()[:spec[0] * spec[1]])


def _inputs(seed=1, rows=8, skew=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    hi = V // 4 if skew else V
    ids = rng.integers(0, hi, size=(rows, 6)).astype(np.int32)
    w = rng.normal(size=(rows, 6, D)).astype(np.float32)
    return table, ids, w


def _jax_lookup(spec, table, ids, w, mode, capacity):
    mesh = _jax_mesh(spec)
    tbl = jax_sharded.shard_table(jnp.asarray(table), mesh)

    def f(tb):
        if mode == "a2a":
            out, dropped = jax_sharded.all_to_all_lookup(
                tb, jnp.asarray(ids), mesh, capacity_factor=capacity, return_overflow=True)
        else:
            out, dropped = jax_sharded.sharded_lookup(tb, jnp.asarray(ids), mesh), 0
        return jnp.sum(out * jnp.asarray(w)), (out, dropped)

    (_, (out, dropped)), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(tbl)
    return np.asarray(out), np.asarray(grad), int(dropped)


def _assemble(ranks, spec, key):
    """The whole-table array of per-shard ``key`` (data rank 0's shards)."""
    return np.concatenate([r[key] for r in ranks[:spec[1]]])


@pytest.mark.parametrize("spec", [(1, 2), (1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_lookup_and_table_gradient_match_jax(tmp_path, mode, spec):
    table, ids, w = _inputs()
    capacity = float(spec[1])  # lossless
    ranks = W.spawn(W.lookup, spec[0] * spec[1], tmp_path, spec, table, ids, w, mode, capacity)
    want_out, want_grad, _ = _jax_lookup(spec, table, ids, w, mode, capacity)
    out = np.concatenate([ranks[d * spec[1]]["out"] for d in range(spec[0])])
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, table[ids], rtol=0, atol=1e-6)
    for i, r in enumerate(ranks):  # every rank of a model group serves the same vectors
        np.testing.assert_array_equal(r["out"], ranks[i // spec[1] * spec[1]]["out"])
    grad = _assemble(ranks, spec, "grad") * spec[0]
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())
    for i, r in enumerate(ranks):  # the data group averaged its shard's gradient
        np.testing.assert_array_equal(r["grad"], ranks[i % spec[1]]["grad"])


@pytest.mark.parametrize("spec", [(1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_overflow_count_matches_jax_at_a_skewed_batch(tmp_path, spec):
    """Every id in shard 0's rows: at the fair share half of them overflow,
    and the count sums every routing rank's drops over the mesh, as JAX's."""
    table, ids, w = _inputs(skew=True)
    ranks = W.spawn(W.lookup, spec[0] * spec[1], tmp_path, spec, table, ids, w, "a2a", 1.0)
    _, _, want = _jax_lookup(spec, table, ids, w, "a2a", 1.0)
    assert want > 0
    assert [r["dropped"] for r in ranks] == [want] * len(ranks)
    frac = sharded.a2a_overflow_fraction(ids[:8 // spec[0]], spec[1], V, 1.0)
    assert frac == jax_sharded.a2a_overflow_fraction(ids[:8 // spec[0]], spec[1], V, 1.0)
    assert want == round(frac * ids.size // spec[0]) * spec[0] * spec[1]
    out = np.concatenate([ranks[d * spec[1]]["out"] for d in range(spec[0])])
    dropped_rows = (out == 0).all(-1)
    assert dropped_rows.sum() == want // spec[1]
    np.testing.assert_array_equal(out[~dropped_rows], table[ids][~dropped_rows])


def test_sort_coalesced_lookup_gathers_in_any_order(tmp_path):
    table, ids, w = _inputs()
    ranks = W.spawn(W.lookup, 2, tmp_path, (1, 2), table, ids, w, "sorted", 2.0)
    np.testing.assert_array_equal(ranks[0]["out"], table[ids])
    want = np.zeros_like(table)
    np.add.at(want, ids.reshape(-1), w.reshape(-1, D))
    np.testing.assert_allclose(_assemble(ranks, (1, 2), "grad"), want, rtol=0, atol=1e-5)
    one = sharded.sort_coalesced_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(one.numpy(), table[ids])


def _jax_dlrm(spec, batch, lr):
    """JAX's converted-from init, its one-step loss and updated table at
    ``spec`` through the psum exchange, and the table's gradient."""
    mesh = _jax_mesh(spec)
    model = JaxDLRM(**W.DLRM_KW, partition="model", lookup_mode="psum", mesh=mesh)
    loss_fn, _ = jax_make_ctr_task(model)
    variables = model.init(jax.random.PRNGKey(0), batch)
    tr = JaxTrainer(loss_fn, JaxTrainConfig(learning_rate=lr), mesh=mesh,
                    param_shardings=param_shardings(variables["params"], mesh))
    state = tr.init_state(lambda: jax_init_model(model, batch))
    params = jax.tree.map(np.asarray, nn.unbox(state.params))
    plain_loss, _ = jax_make_ctr_task(JaxDLRM(**W.DLRM_KW))
    grad = jax.grad(lambda p: jnp.mean(plain_loss(p, {}, batch, None, True)[0]))(params)
    state, metrics = tr._train_step(state, tr.put_batch(batch), jax.random.PRNGKey(0))
    table = np.asarray(nn.unbox(state.params)["embedding"]["embedding"])
    return params, float(metrics["loss"]), table, np.asarray(grad["embedding"]["embedding"])


def test_dlrm_step_at_2x2_psum_matches_jax(tmp_path):
    batch = JaxSyntheticCTR(vocab_size=V, seed=0).sample(32, seed=1)
    lr = 1e-3
    params, want_loss, want_table, want_grad = _jax_dlrm((2, 2), batch, lr)
    ranks = W.spawn(W.dlrm_step, 4, tmp_path, (2, 2), params, batch, "psum", "float32", 1, lr)
    assert abs(ranks[0]["losses"][0] - want_loss) <= 1e-5
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    grad = np.concatenate([ranks[j]["grads"]["embedding.embedding"] for j in range(2)])
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-2 * scale)
    table = np.concatenate([ranks[j]["params"]["embedding.embedding"] for j in range(2)])
    resolved = np.abs(want_grad) > 1e-2 * scale
    np.testing.assert_allclose(table[resolved], want_table[resolved], rtol=0, atol=1e-5)
    np.testing.assert_allclose(table, want_table, rtol=0, atol=2 * lr + 1e-5)
    # the data group averaged the shard's gradient and took one update
    np.testing.assert_array_equal(ranks[2]["params"]["embedding.embedding"],
                                  ranks[0]["params"]["embedding.embedding"])


@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_bf16_sr_at_model_2_equals_one_rank_bit_for_bit(tmp_path, mode):
    """bf16 table + stochastic rounding through the exchange: the shard draws
    the whole table's noise (its element offset), K1 sums the shard's ids in
    the whole table's sorted positions (psum), so three steps at model 2
    equal one rank's bit for bit; the dense params stay equal across the
    model group. (a2a serves the same vectors; K1 sums each row's two
    half-weighted copies, exact here.)"""
    batch = JaxSyntheticCTR(vocab_size=V, seed=0).sample(32, seed=1)
    mesh = make_mesh()
    model = DLRM(**W.DLRM_KW, embed_param_dtype=torch.bfloat16)
    torch.manual_seed(0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loss_fn, _ = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=1e-2), device="cpu", mesh=mesh)
    state = tr.init_state(lambda: model)
    losses = []
    for _ in range(3):
        state, m = tr.train_step(state, tr.put_batch(batch))
        losses.append(float(m["loss"]))
    flax_like = _as_flax_tree(params)
    ranks = W.spawn(W.dlrm_step, 2, tmp_path, (1, 2), flax_like, batch, mode, "bfloat16", 3, 1e-2)
    for r in ranks:
        assert r["losses"] == losses
        for name, value in r["params"].items():
            if name != "embedding.embedding":
                np.testing.assert_array_equal(value, ranks[0]["params"][name])
    table = np.concatenate([r["params"]["embedding.embedding"] for r in ranks])
    np.testing.assert_array_equal(table, model.embedding.embedding.detach().float().numpy())


def _as_flax_tree(state_dict):
    """A port ``state_dict`` as the flax tree ``load_flax_params`` reads."""
    tree = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        arr = t.numpy() if t.dtype != torch.bfloat16 else t.view(torch.int16).numpy().view(
            jnp.bfloat16)
        if leaf == "weight":
            leaf, arr = "kernel", arr.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def test_shard_table_and_divisibility():
    t = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(sharded.shard_table(t, make_mesh()), t)
    with pytest.raises(ValueError, match="not divisible"):
        from recommender_tpu_torch.core.mesh import Mesh

        sharded.shard_rows(7, Mesh(1, 2))
    assert sharded.a2a_capacity(48, 2, 2.0) == 48
    assert sharded.a2a_capacity(48, 4, 1.25) == 15


@pytest.mark.parametrize("chunk_rows", [5, 64, None], ids=["5_rows", "64_rows", "default"])
def test_init_rows_keeps_a_shards_rows_of_the_whole_draw(monkeypatch, chunk_rows):
    """A shard's init is its rows of the whole table's, drawn in chunks of
    rows that need not line up with the shard; on the CPU the chunks' draws
    are one ``uniform_`` over the whole table."""
    from recommender_tpu_torch.embedding import table as table_mod

    if chunk_rows is not None:
        monkeypatch.setattr(table_mod, "INIT_CHUNK_ELEMENTS", chunk_rows * D)
    bound = (3.0 / D) ** 0.5
    whole = table_mod.init_rows(torch.empty(V, D), V, 0, torch.Generator().manual_seed(3))
    want = torch.empty(V, D).uniform_(-bound, bound, generator=torch.Generator().manual_seed(3))
    assert torch.equal(whole, want)
    for lo, rows in ((0, 32), (32, 32), (16, 16), (40, 24)):
        part = table_mod.init_rows(torch.empty(rows, D), V, lo, torch.Generator().manual_seed(3))
        assert torch.equal(part, whole[lo:lo + rows])
    half = table_mod.init_rows(torch.empty(V // 2, D, dtype=torch.bfloat16), V, V // 2,
                               torch.Generator().manual_seed(3))
    assert torch.equal(half, whole[V // 2:].to(torch.bfloat16))
