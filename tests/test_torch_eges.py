"""The graph-embedding family and per-path update scales against the JAX
package on the CPU, from one converted JAX init: ``DeepWalk``, ``GES`` and
``EGES`` logits, ``get_hidden`` and gradients (and JAX's zero-weight EGES ==
GES check), ``make_skipgram_task``, ``link_prediction_auc``, ``AdamSR``
with ``lr_scales`` against JAX's ``make_optimizer`` chain, and 20
``Trainer`` steps of EGES with ``lr_scales`` against the JAX Trainer.

A 200-node community graph (``tests/test_eges.py``'s), D 16, cat vocab 9,
brand vocab 50, batch 128 with 5 negatives.

Tolerances: the models are f32 end to end, so logits and ``get_hidden``
within 1e-5 of their largest magnitude and each gradient within 1e-4 of
its own (``GRAD_TOL``, as ``tests/test_torch_ctr.py``); the task's
per-example losses within 1e-5 relative; link-prediction AUC within 1e-6
(exact: the same scores up to f32 roundoff, ranked) and 1e-3 (the
histogram). ``AdamSR`` with ``lr_scales``: bit for bit on bf16 leaves (the
stochastic-rounding chain), and f32 leaves within 1e-6 abs, as
``tests/test_torch_ctr.py`` holds unscaled steps (measured ≤ 1.2e-7, up to
3 f32 ulps after 5 steps: JAX's jitted Adam rounds its moment math in
another order).
Trainer: per-step losses within 1e-3 abs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommender_tpu.core.optim import apply_updates_sr as jax_apply_updates_sr
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.core.train import make_optimizer as jax_make_optimizer
from recommender_tpu.models.eges import EGES as JaxEGES
from recommender_tpu.models.eges import GES as JaxGES
from recommender_tpu.models.eges import DeepWalk as JaxDeepWalk
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import link_prediction_auc as jax_link_prediction_auc
from recommender_tpu.models.tasks import make_skipgram_task as jax_make_skipgram_task
from recommender_tpu_torch.convert import flax_to_state_dict, jax_leaf_order, load_flax_params
from recommender_tpu_torch.core.optim import AdamSR, path_scales
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.graph import WeightedGraph, skipgram_batches
from recommender_tpu_torch.models import (
    EGES,
    GES,
    DeepWalk,
    init_model,
    link_prediction_auc,
    make_skipgram_task,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, BATCH, NEG, CATS, BRANDS = 16, 128, 5, 9, 50
GRAD_TOL = 1e-4
SCALES = {"cat_embedding": 0.5, "brand_embedding": 0.5}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@functools.lru_cache(maxsize=None)
def _graph():
    """``tests/test_eges.py::_community_graph``, with side info: the cat is
    the community (+1), the brand uniform."""
    rng = np.random.default_rng(0)
    num_nodes, num_comm = 200, CATS - 1
    comm = rng.integers(0, num_comm, size=num_nodes)
    by_comm = [np.where(comm == c)[0] for c in range(num_comm)]
    src, dst = [], []
    for v in range(1, num_nodes):
        pool = by_comm[comm[v]]
        for _ in range(12):
            if rng.random() < 0.9 and len(pool) > 1:
                u = int(rng.choice(pool))
            else:
                u = int(rng.integers(1, num_nodes))
            if u != v and u != 0:
                src += [v, u]
                dst += [u, v]
    side = {"cat": (comm + 1).astype(np.int32),
            "brand": rng.integers(1, BRANDS, num_nodes).astype(np.int32)}
    side["cat"][0] = 0
    return WeightedGraph.from_edges(src, dst, num_nodes=num_nodes), side, comm


@functools.lru_cache(maxsize=None)
def _batches(n: int, with_side: bool):
    g, side, _ = _graph()
    it = skipgram_batches(g, walk_length=8, window=3, num_negatives=NEG, batch_size=BATCH,
                          walks_per_round=64, side_info=side if with_side else None, seed=0)
    return [next(it) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _triples():
    """Held-out intra-community pairs against uniform negatives
    (``tests/test_eges.py``'s link-prediction set), with side info."""
    g, side, comm = _graph()
    rng = np.random.default_rng(1)
    qs, ps, ns = [], [], []
    for _ in range(600):
        pool = np.where(comm == rng.integers(0, CATS - 1))[0]
        pool = pool[pool > 0]
        if len(pool) < 2:
            continue
        a, b = rng.choice(pool, 2, replace=False)
        qs.append(a)
        ps.append(b)
        ns.append(rng.integers(1, g.num_nodes))
    out = {"query": np.array(qs, np.int32), "pos": np.array(ps, np.int32),
           "neg": np.array(ns, np.int32)}
    for role in ("query", "pos", "neg"):
        for name, arr in side.items():
            out[f"{role}_{name}"] = arr[out[role]]
    return out


MODELS = {"BGE": (JaxDeepWalk, DeepWalk), "GES": (JaxGES, GES), "EGES": (JaxEGES, EGES)}


def _kw(kind):
    g = _graph()[0]
    if kind == "BGE":
        return dict(vocab_size=g.num_nodes, embed_dim=D)
    return dict(vocab_size=g.num_nodes, cat_vocab=CATS, brand_vocab=BRANDS, embed_dim=D)


def _port(kind, params):
    return load_flax_params(MODELS[kind][1](**_kw(kind)), params)


@functools.lru_cache(maxsize=None)
def _jax_case(kind):
    """JAX model, init, batch, logits, hidden, per-example loss and the
    gradients of the mean loss."""
    model = MODELS[kind][0](**_kw(kind))
    batch = _batches(1, kind != "BGE")[0]
    params = jax_init_model(model, batch)[0]
    loss_fn, eval_fn = jax_make_skipgram_task(model)

    def mean_loss(p):
        per_ex, _, _ = loss_fn(p, {}, batch, None, True)
        return jnp.mean(per_ex), per_ex

    (_, per_ex), grads = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(params)
    logits = model.apply({"params": params}, batch)
    hidden = model.apply({"params": params}, batch, method=model.get_hidden)
    scores, labels = eval_fn(params, {}, batch)
    return (model, _np_tree(params), batch, np.asarray(logits), np.asarray(hidden),
            np.asarray(per_ex), _np_tree(grads), (np.asarray(scores), np.asarray(labels)))


@pytest.mark.parametrize("kind", ["BGE", "GES", "EGES"])
def test_logits_hidden_and_grads_match_jax(kind):
    _, params, batch, want_logits, want_hidden, want_per_ex, want_grads, _ = _jax_case(kind)
    model = _port(kind, params)
    tb = _torch_batch(batch)
    logits = model(tb)
    assert logits.shape == (BATCH, 1 + NEG) and logits.dtype == torch.float32
    assert _rel_err(logits.detach().numpy(), want_logits) <= 1e-5
    assert _rel_err(model.get_hidden(tb).detach().numpy(), want_hidden) <= 1e-5
    loss_fn, _ = make_skipgram_task(model)
    per_ex, aux = loss_fn(tb, True)
    assert aux == {} and per_ex.shape == (BATCH,)
    assert _rel_err(per_ex.detach().numpy(), want_per_ex) <= 1e-5
    per_ex.mean().backward()
    want = flax_to_state_dict(want_grads)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert _rel_err(got[name], w.numpy()) <= GRAD_TOL, name
    if kind == "EGES":
        assert model.weight_embedding.embedding.shape == (_graph()[0].num_nodes, 3)


@pytest.mark.parametrize("kind", ["BGE", "GES", "EGES"])
def test_converter_and_leaf_order(kind):
    params = _jax_case(kind)[1]
    model = _port(kind, params)
    names = [".".join(p.key for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [n for n, _ in jax_leaf_order(model)] == names
    again = init_model(_port(kind, params), seed=3)
    for name, p in again.named_parameters():
        assert not torch.equal(p, dict(model.named_parameters())[name]), name


def test_eges_with_zero_weights_equals_ges():
    """``tests/test_eges.py``: with an all-zero weight table the softmax
    weights are uniform, so EGES's hidden is GES's mean."""
    params = _jax_case("EGES")[1]
    ges_params = {k: v for k, v in params.items() if k != "weight_embedding"}
    eges = _port("EGES", params)
    with torch.no_grad():
        eges.weight_embedding.embedding.zero_()
    ges = _port("GES", ges_params)
    tb = _torch_batch(_jax_case("EGES")[2])
    np.testing.assert_allclose(eges.get_hidden(tb).detach().numpy(),
                               ges.get_hidden(tb).detach().numpy(), rtol=1e-4, atol=1e-6)


def test_skipgram_eval_is_flat():
    """The eval returns flattened [B·(1+k)] scores and labels, which
    ``Trainer.evaluate`` takes as they are."""
    _, params, batch, *_, (want_scores, want_labels) = _jax_case("EGES")
    model = _port("EGES", params)
    _, eval_fn = make_skipgram_task(model)
    scores, labels = eval_fn(_torch_batch(batch))
    assert scores.shape == labels.shape == (BATCH * (1 + NEG),)
    assert _rel_err(scores.detach().numpy(), want_scores) <= 1e-5
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    loss_fn, eval_fn = make_skipgram_task(model)
    trainer = Trainer(loss_fn, TrainConfig(), eval_fn, device="cpu")
    ev = trainer.evaluate(trainer.init_state(lambda: model), iter(_batches(2, True)))
    assert ev["eval_batches"] == 2 and 0.0 < ev["eval_auc"] < 1.0


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind", ["BGE", "EGES"])
def test_link_prediction_auc_matches_jax(kind, exact):
    jax_model, params, *_ = _jax_case(kind)
    triples = _triples()
    want = jax_link_prediction_auc(jax_model, params, triples, batch_size=256, exact=exact)
    got = link_prediction_auc(_port(kind, params), triples, batch_size=256, exact=exact)
    assert isinstance(got, float)
    assert abs(got - want) <= (1e-6 if exact else 1e-3)


# ------------------------------------------------------------- lr_scales
def test_path_scales_match_whole_components():
    names = ["cat_embedding.embedding", "concat_embedding.embedding", "id_embedding.table",
             "tower.Dense_0.bias", "tower.Dense_1.bias"]
    scales = {"cat_embedding": 0.5, "embedding": 0.5, "id_embedding/table": 0.25,
              "tower/Dense_0": 3.0, "Dense_0/bias/extra": 7.0, "": 9.0}
    assert path_scales(names, scales) == [0.25, 0.5, 0.25, 3.0, 1.0]
    assert path_scales(names, None) == [1.0] * 5


SCALE_TREE = {"cat_embedding": 0.5, "embedding": 0.5, "id_embedding/table": 0.3,
              "tower/Dense_0": 0.1}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_adam_sr_with_lr_scales_matches_jax(bf16):
    """5 steps of JAX's ``make_optimizer`` chain (``optax.adam``, or
    ``adam_sr`` where a leaf is bf16, then ``_scale_updates_by_path``)
    against ``AdamSR(scales=path_scales(...))``: a bf16 ``cat_embedding``
    (0.25 = two patterns), ``concat_embedding`` (0.5: only ``embedding``
    matches), a two-component pattern, and an unscaled leaf."""
    rng = np.random.default_rng(0)
    shapes = {("cat_embedding", "embedding"): (40, 8), ("concat_embedding", "embedding"): (30, 8),
              ("id_embedding", "table"): (20, 8), ("tower", "Dense_0", "bias"): (16,),
              ("tower", "Dense_1", "bias"): (4,)}
    dtype = {k: "bfloat16" if bf16 and k[0] == "cat_embedding" else "float32" for k in shapes}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]

    def nest(flat):
        tree = {}
        for path, v in flat.items():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v
        return tree

    cfg = JaxTrainConfig(learning_rate=1e-2, lr_scales=SCALE_TREE)
    opt = jax_make_optimizer(cfg, stochastic=bf16)
    jparams = nest({k: jnp.asarray(v).astype(jnp.dtype(dtype[k])) for k, v in init.items()})
    jstate = opt.init(jparams)
    order = sorted(shapes)  # JAX's flatten order: keys sorted at every level
    names = [".".join(k) for k in order]
    assert path_scales(names, SCALE_TREE) == [0.25, 0.5, 0.3, 0.1, 1.0]
    tparams = [torch.nn.Parameter(torch.tensor(init[k]).to(getattr(torch, dtype[k])))
               for k in order]
    topt = AdamSR(tparams, lr=1e-2, seed=0, scales=path_scales(names, SCALE_TREE))
    write = jax.random.fold_in(jax.random.PRNGKey(0), 0x5EED)
    step = jax.jit(lambda g, s, p: opt.update(g, s, p))
    for s, g in enumerate(grads):
        jg = nest({k: jnp.asarray(v).astype(jnp.dtype(dtype[k])) for k, v in g.items()})
        upd, jstate = step(jg, jstate, jparams)
        key = jax.random.fold_in(write, s)
        jparams = (jax_apply_updates_sr(jparams, upd, key) if bf16
                   else optax.apply_updates(jparams, upd))
        for p, k in zip(tparams, order):
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step(tuple(int(w) for w in np.asarray(jax.random.key_data(key))))
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    for p, k in zip(tparams, order):
        want = np.asarray(flat[tuple(jax.tree_util.DictKey(x) for x in k)].astype(jnp.float32))
        got = p.detach().float().numpy()
        if dtype[k] == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=str(k))
        moved = np.abs(got - init[k].astype(np.float32)).max()
        assert moved > 0


# ---------------------------------------------------------------- Trainer
STEPS, LR = 20, 5e-3


@functools.lru_cache(maxsize=None)
def _run_jax():
    batches = _batches(STEPS + 1, True)
    model = JaxEGES(**_kw("EGES"))
    params, model_state = jax_init_model(model, batches[0])
    init = _np_tree(params)  # the JAX step donates its state
    loss_fn, eval_fn = jax_make_skipgram_task(model)
    cfg = JaxTrainConfig(learning_rate=LR, log_every=1, eval_every=0, lr_scales=SCALES)
    trainer = JaxTrainer(loss_fn, cfg, eval_fn=eval_fn)
    state = trainer.init_state(lambda: (params, model_state))
    logs = []
    state, _ = trainer.fit(state, iter(batches[1:]), STEPS, log_fn=logs.append)
    return init, logs


def test_trainer_with_lr_scales_tracks_jax_trainer():
    params, jax_logs = _run_jax()
    model = _port("EGES", params)
    loss_fn, eval_fn = make_skipgram_task(model)
    cfg = TrainConfig(learning_rate=LR, log_every=1, eval_every=0, lr_scales=SCALES)
    trainer = Trainer(loss_fn, cfg, eval_fn, device="cpu")
    state = trainer.init_state(lambda: model)
    assert state.optimizer.scales == [0.5 if "cat_" in n or "brand_" in n else 1.0
                                      for n, _ in jax_leaf_order(model)]
    logs = []
    state, _ = trainer.fit(state, iter(_batches(STEPS + 1, True)[1:]), STEPS, log_fn=logs.append)
    assert state.step == STEPS == len(logs) == len(jax_logs)
    np.testing.assert_allclose([m["loss"] for m in logs], [m["loss"] for m in jax_logs],
                               rtol=0, atol=1e-3)
    assert logs[-1]["loss"] < logs[0]["loss"]
