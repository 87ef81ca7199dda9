"""The CTR family's modules against the JAX package on the CPU, from one
converted JAX init: ``CrossNetwork``, ``DeepFM`` and ``DCN`` forward and
gradients with f32 and bf16 tables, ``dlrm_warmup_cosine``, ``AdamSR``
driven by that schedule, 20 ``Trainer`` steps of DeepFM and of DCN against
the JAX Trainer, and early stopping with best-only checkpoints.

Vocab 2,000, D 8, batch 64; DeepFM's MLP (32, 16, 1), DCN's deep tower
(32, 16) and three cross layers over 26 x 8 + 13 = 221 features.

Tolerances:
* ``CrossNetwork`` is f32 end to end: the forward within 1e-5 of its
  largest magnitude, each gradient within 1e-4 of its own.
* The models' forward within 1e-5 relative (measured ≤ 1.2e-7, bit for
  bit with a bf16 table: the MLPs compute in bf16 on both sides with the
  same roundings, and ``fm_cross`` rounds where XLA's compiled function
  does). Gradients, each within a share of the leaf's largest entry: 1e-4
  for every leaf (measured ≤ 4.7e-5; the bf16 MLPs' kernels bit for bit)
  but two kinds. The bf16 MLPs' bias leaves within 2e-2 (measured ≤
  1.01e-2), as in ``test_torch_dlrm.py``: a bias gradient is a bf16 sum
  over the batch that the frameworks round at different points. A bf16
  table's within 2^-8, one bf16 ulp (measured ≤ 2.5e-3): both sides sum
  its rows in f32 (JAX's through ``_f32_table_backward``) in other
  orders and round once, so a sum near a rounding boundary can land on
  the other neighbour.
* ``dlrm_warmup_cosine``: within 1 f32 ulp (numpy's f32 cosine against
  XLA's). ``AdamSR`` with it: f32 params within 1e-6 abs; bf16 params
  and moments bit for bit.
* Trainer, 20 steps at the schedule's warmup and decay from one init: the
  per-step loss within 1e-3 abs (``test_torch_dien.py``'s Trainer
  tolerance), final exact eval AUC and eval loss within 1e-3.
"""
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.core.optim import adam_sr as jax_adam_sr
from recommender_tpu.core.optim import apply_updates_sr as jax_apply_updates_sr
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.models.dcn import DCN as JaxDCN
from recommender_tpu.models.deepfm import DeepFM as JaxDeepFM
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.nn.cross import CrossNetwork as JaxCrossNetwork
from recommender_tpu.nn.schedules import dlrm_warmup_cosine as jax_dlrm_warmup_cosine
from recommender_tpu_torch.convert import flax_to_state_dict, jax_leaf_order, load_flax_params
from recommender_tpu_torch.core.optim import AdamSR
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticCTR, batch_iterator
from recommender_tpu_torch.models import DCN, DeepFM, init_model, make_ctr_task
from recommender_tpu_torch.nn import CrossNetwork, dlrm_warmup_cosine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, D, BATCH = 2000, 8, 64
MODELS = {
    "DeepFM": (JaxDeepFM, DeepFM, dict(mlp_units=(32, 16, 1))),
    "DCN": (JaxDCN, DCN, dict(deep_units=(32, 16))),
}
# gradient tolerances, as shares of the leaf's largest entry (module docstring)
GRAD_TOL, MLP_BIAS_TOL, BF16_TABLE_TOL = 1e-4, 2e-2, 2.0**-8


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


# ---------------------------------------------------------- CrossNetwork
def test_cross_network_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(16, 21)).astype(np.float32)
    jm = JaxCrossNetwork(3)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x0))["params"]
    want, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x), params, jnp.asarray(x0))
    cot = rng.normal(size=want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot))
    model = CrossNetwork(21, 3)
    load_flax_params(model, _np_tree(params))
    assert [n for n, _ in jax_leaf_order(model)] == [
        f"cross_{i}.{w}" for i in range(3) for w in ("bias", "weight")]
    x = torch.from_numpy(x0).requires_grad_()
    out = model(x)
    out.backward(torch.from_numpy(cot))
    assert _rel_err(out.detach().numpy(), want) <= 1e-5
    assert _rel_err(x.grad.numpy(), want_gx) <= 1e-4
    for name, w in flax_to_state_dict(_np_tree(want_gp)).items():
        got = dict(model.named_parameters())[name].grad.numpy()
        assert _rel_err(got, w.numpy()) <= 1e-4, name


# ------------------------------------------------------ forward and grads
@contextlib.contextmanager
def _f32_table_backward():
    """JAX's lookup backward for a bf16 table of a few thousand rows sums
    the bf16 cotangent in bf16; the port's sums it in f32 (``PARITY.md``).
    Route JAX's through its own f32 path instead, the sorted scatter-add
    Pallas kernel (in interpret mode, as ``tests/test_dedup.py`` runs it),
    so that both round once, after the sum."""
    from jax.experimental import pallas as pl

    from recommender_tpu.ops import embedding_kernels as jax_ek

    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        mp.setattr(jax_ek, "use_padded_backward", lambda shape, n_ids: True)
        mp.setattr(jax_ek, "PADDED_BWD_MAX_ROWS", 0)
        mp.setattr(jax_ek, "_pallas_available", lambda: True)
        yield


@functools.lru_cache(maxsize=None)
def _jax_case(kind, table_dtype):
    """JAX model, converted init, batch, and what JAX computes: prob, loss
    and the gradients of the mean loss (a bf16 table's through
    ``_f32_table_backward``)."""
    jax_cls, _, kw = MODELS[kind]
    model = jax_cls(vocab_size=V, embed_dim=D, embed_param_dtype=jnp.dtype(table_dtype), **kw)
    batch = SyntheticCTR(vocab_size=V, seed=0).sample(BATCH, seed=1)
    params = _tame(jax_init_model(model, batch)[0])
    loss_fn, _ = jax_make_ctr_task(model)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def mean_loss(p):
        per_ex, _, _ = loss_fn(p, {}, jbatch, None, True)
        return jnp.mean(per_ex)

    backward = _f32_table_backward() if table_dtype == "bfloat16" else contextlib.nullcontext()
    with backward:
        loss, grads = jax.jit(jax.value_and_grad(mean_loss))(params)
    prob = jax.jit(lambda p: model.apply({"params": p}, batch))(params)
    return model, _np_tree(params), batch, np.asarray(prob), float(loss), _np_tree(grads)


def _tame(params):
    """The JAX init with its table scaled by 1/4 (exact in bf16). At the
    init's scale DeepFM's FM term over 26 features has a std of ~6 at D 8,
    so some examples saturate the sigmoid and BCE's clip zeroes their
    gradient: a logit that differs in its last bf16 bit between the
    frameworks then moves a table row's gradient by a whole example's
    share."""
    table = params["embedding"]["embedding"]
    return {**params, "embedding": {"embedding": table * jnp.asarray(0.25, table.dtype)}}


def _port(kind, params, table_dtype="float32"):
    _, cls, kw = MODELS[kind]
    model = cls(V, D, embed_param_dtype=getattr(torch, table_dtype), **kw)
    return load_flax_params(model, params)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["DeepFM", "DCN"])
def test_forward_and_grads_match_jax(kind, table_dtype):
    _, params, batch, want_prob, want_loss, want_grads = _jax_case(kind, table_dtype)
    model = _port(kind, params, table_dtype)
    assert model.embedding.embedding.dtype == getattr(torch, table_dtype)
    loss_fn, _ = make_ctr_task(model)
    per_ex, _ = loss_fn(_torch_batch(batch), True)
    loss = per_ex.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    model.eval()
    with torch.no_grad():
        prob = model(_torch_batch(batch))
    assert prob.dtype == torch.float32 and prob.shape == (BATCH,)
    assert _rel_err(prob.numpy(), want_prob) <= 1e-5
    want = flax_to_state_dict(want_grads)
    got = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        tol = GRAD_TOL
        if name.startswith(("mlp.", "deep.")) and name.endswith("bias"):
            tol = MLP_BIAS_TOL
        elif name == "embedding.embedding" and table_dtype == "bfloat16":
            tol = BF16_TABLE_TOL
        assert _rel_err(got[name], w.float().numpy()) <= tol, name


@pytest.mark.parametrize("kind", ["DeepFM", "DCN"])
def test_converter_and_leaf_order(kind):
    _, params, *_ = _jax_case(kind, "float32")
    model = _port(kind, params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(p.key for p in path).replace(".kernel", ".weight") for path, _ in leaves]
    assert [n for n, _ in jax_leaf_order(model)] == names
    again = init_model(_port(kind, params), seed=3)
    for name, p in again.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().numpy().any(), name
        else:
            assert not torch.equal(p, dict(model.named_parameters())[name]), name


# -------------------------------------------------------------- schedule
def test_dlrm_warmup_cosine_matches_jax():
    warmup, decay, lr, alpha = 20, 100, 3e-3, 1e-4
    ours = dlrm_warmup_cosine(lr, warmup, decay, alpha)
    theirs = jax_dlrm_warmup_cosine(lr, warmup, decay, alpha)
    steps = [0, 1, 7, warmup - 1, warmup, warmup + 1, 50, 77, warmup + decay - 1,
             warmup + decay, warmup + decay + 1, 10_000]
    got = np.asarray([ours(s) for s in steps], np.float32)
    want = np.asarray([theirs(jnp.int32(s)) for s in steps], np.float32)
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1, dict(zip(steps, ulps))
    assert got[0] == 0 and got[4] == np.float32(lr)
    assert got[-1] == np.float32(lr) * np.float32(alpha)  # constant after the decay
    assert all(isinstance(ours(s), float) for s in steps)


@pytest.mark.parametrize("dtypes", [("float32",) * 3, ("bfloat16", "float32", "bfloat16")],
                         ids=["f32", "bf16"])
def test_adam_sr_with_schedule_matches_jax(dtypes):
    """5 steps from one init with the schedule's warmup and decay: the update
    count the schedule reads starts at 0, as optax's does."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 16), "b": (32,), "c": (7,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    dt = dict(zip("abc", dtypes))
    jparams = {k: jnp.asarray(v).astype(jnp.dtype(dt[k])) for k, v in init.items()}
    opt = jax_adam_sr(jax_dlrm_warmup_cosine(1e-2, 2, 2, 0.1), seed=0)
    jstate = opt.init(jparams)
    tparams = [torch.nn.Parameter(torch.tensor(init[k]).to(getattr(torch, dt[k])))
               for k in "abc"]
    topt = AdamSR(tparams, lr=dlrm_warmup_cosine(1e-2, 2, 2, 0.1), seed=0)
    write = jax.random.fold_in(jax.random.PRNGKey(0), 0x5EED)
    for s, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        upd, jstate = opt.update(jg, jstate, jparams)
        key = jax.random.fold_in(write, s)
        jparams = jax_apply_updates_sr(jparams, upd, key)
        for p, k in zip(tparams, "abc"):
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step(tuple(int(w) for w in np.asarray(jax.random.key_data(key))))
    assert topt.count == 5
    for p, k in zip(tparams, "abc"):
        want = np.asarray(jparams[k].astype(jnp.float32))
        got = p.detach().float().numpy()
        if dt[k] == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert not np.array_equal(got, init[k].astype(np.float32))  # the step moved it


# ---------------------------------------------------------------- Trainer
STEPS = 20


@functools.lru_cache(maxsize=None)
def _data():
    gen = SyntheticCTR(vocab_size=V, seed=0)
    return gen.sample(STEPS * BATCH, seed=1), gen.sample(4 * BATCH, seed=2)


def _schedule(jax_side):
    fn = jax_dlrm_warmup_cosine if jax_side else dlrm_warmup_cosine
    return fn(3e-3, 5, 10, 1e-4)


@functools.lru_cache(maxsize=None)
def _run_jax(kind):
    train, test = _data()
    jax_cls, _, kw = MODELS[kind]
    model = jax_cls(vocab_size=V, embed_dim=D, **kw)
    params, model_state = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    params = _tame(params)
    init = _np_tree(params)  # the JAX step donates its state
    loss_fn, eval_fn = jax_make_ctr_task(model)
    cfg = JaxTrainConfig(learning_rate=_schedule(True), log_every=1, eval_every=0)
    trainer = JaxTrainer(loss_fn, cfg, eval_fn=eval_fn)
    state = trainer.init_state(lambda: (params, model_state))
    logs = []
    state, _ = trainer.fit(state, jax_batch_iterator(train, BATCH, seed=0), STEPS,
                           log_fn=logs.append)
    ev = trainer.evaluate(state, jax_batch_iterator(test, BATCH, shuffle=False), exact=True)
    return init, logs, ev


@pytest.mark.parametrize("kind", ["DeepFM", "DCN"])
def test_trainer_tracks_jax_trainer(kind):
    params, jax_logs, jax_ev = _run_jax(kind)
    train, test = _data()
    model = _port(kind, params)
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=_schedule(False), log_every=1, eval_every=0)
    trainer = Trainer(loss_fn, cfg, eval_fn, device="cpu")
    state = trainer.init_state(lambda: model)
    logs = []
    state, _ = trainer.fit(state, batch_iterator(train, BATCH, seed=0), STEPS,
                           log_fn=logs.append)
    assert state.step == STEPS == len(logs) == len(jax_logs)
    np.testing.assert_allclose([m["loss"] for m in logs], [m["loss"] for m in jax_logs],
                               rtol=0, atol=1e-3)
    ev = trainer.evaluate(state, batch_iterator(test, BATCH, shuffle=False), exact=True)
    assert ev["eval_batches"] == jax_ev["eval_batches"] == 4
    assert abs(ev["eval_auc_exact"] - jax_ev["eval_auc_exact"]) < 1e-3
    assert abs(ev["eval_loss"] - jax_ev["eval_loss"]) < 1e-3


# --------------------------------------------------------- early stopping
def _small_trainer(tmp_path, lr, **cfg_kw):
    model = DeepFM(V, D, mlp_units=(16, 1), generator=torch.Generator().manual_seed(0))
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=lr, log_every=10**9, eval_every=2,
                      checkpoint_dir=str(tmp_path / "ckpt") if tmp_path else None, **cfg_kw)
    trainer = Trainer(loss_fn, cfg, eval_fn, device="cpu")
    return trainer, trainer.init_state(lambda: model)


@pytest.mark.parametrize("metric,mode", [("eval_auc", "max"), ("eval_loss", "min")])
def test_early_stopping_fires_and_saves_best_only(tmp_path, metric, mode):
    """A frozen model (lr 0) never improves: the first eval is the best and
    is saved, two stale evals later the loop stops (``tests/test_early_stop.py``)."""
    train, test = _data()
    trainer, state = _small_trainer(tmp_path, 0.0, early_stop_patience=2,
                                    early_stop_metric=metric, early_stop_mode=mode)
    state, hist = trainer.fit(state, batch_iterator(train, BATCH, seed=0, epochs=None), 100,
                              eval_iter_fn=lambda: batch_iterator(test, BATCH, shuffle=False))
    assert hist[-1] == {"early_stopped": True, "step": 6} and state.step == 6
    assert [h["step"] for h in hist if metric in h] == [2, 4, 6]
    assert os.listdir(tmp_path / "ckpt") == ["step_2.pt"]  # best only


def test_early_stopping_keeps_going_while_it_improves(tmp_path):
    train, test = _data()
    trainer, state = _small_trainer(tmp_path, 1e-2, early_stop_patience=1,
                                    early_stop_metric="eval_loss", early_stop_mode="min")
    state, hist = trainer.fit(state, batch_iterator(train, BATCH, seed=0, epochs=None), 8,
                              eval_iter_fn=lambda: batch_iterator(test, BATCH, shuffle=False))
    losses = [h["eval_loss"] for h in hist if "eval_loss" in h]
    assert len(losses) == 4 and np.all(np.diff(losses) < 0)  # it learns: no stop
    assert not any("early_stopped" in h for h in hist) and state.step == 8
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"step_{s}.pt" for s in (2, 4, 6, 8)][-3:]


def test_fit_prefetch_matches_and_closes(monkeypatch):
    """``prefetch`` reads the stream ahead in a thread: the same steps as
    reading it in place, and the thread is stopped when ``fit`` returns."""
    from recommender_tpu_torch.core import train as train_module

    made = []

    class Spy(train_module.Prefetcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(train_module, "Prefetcher", Spy)
    train, _ = _data()
    runs = []
    for prefetch in (0, 2):
        trainer, state = _small_trainer(None, 1e-2)
        trainer.cfg.log_every = 1
        logs = []
        trainer.fit(state, batch_iterator(train, BATCH, seed=0, epochs=None), 5,
                    log_fn=logs.append, prefetch=prefetch)
        runs.append([m["loss"] for m in logs])
    assert len(runs[0]) == 5 and runs[0] == runs[1]
    (pf,) = made  # prefetch=0 made none
    for t in pf._threads:
        t.join(timeout=5)
    assert pf._stop.is_set() and not any(t.is_alive() for t in pf._threads)
