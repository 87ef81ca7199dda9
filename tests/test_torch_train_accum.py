"""Gradient accumulation (``TrainConfig.accum_steps``) against the JAX
Trainer's, every comparison from one converted JAX init.

* A = 4 against A = 1 on one batch with SGD: JAX's
  ``test_grad_accumulation_matches_single_step`` on the port, at its
  tolerances (params rtol 1e-5, atol 1e-6; loss 1e-5).
* A = 2 on a small DLRM against JAX's A = 2, with an f32 table and with a
  bf16 table under stochastic rounding, the MLPs computing in f32 on both
  sides (``DLRM``'s default bf16 would add its rounding to every
  comparison): the loss at every update, every param and Adam's moments
  after one and after five updates. Losses are held to
  ``tests/test_torch_train.py``'s Trainer parity, 2e-3 (f32 table) and
  1e-2 (bf16) (measured 1.1e-4 and 3.1e-5). After one update each param
  is within 1e-5 of JAX's for at least 99% of its entries and within
  ``2 lr`` everywhere: Adam's first step is about ``lr * sign(g)``, and a
  table row whose gradient is near 0 (its ids' contributions cancel) may
  step the other way (measured: 0.6% of the f32 table's entries); Adam's
  moments within 5e-3 of max|moment| in f32 (measured 1.3e-3 for the first
  and 2.2e-3 for the second, the table's gradient summed in another order)
  and 5e-2 as SR-rounded bf16 (measured 3.7e-2, a few ulps). After five updates those flips have moved the
  trajectories apart elementwise, so the bound is on the whole: each param
  within ``2 lr`` per update everywhere and 5% in norm (measured 3.1%),
  each moment within 15% in norm (measured 9.3%).
* The f32 accumulation: per-microbatch gradients of a bf16 table that a
  bf16 sum would lose (256 + 1 + 1 - 256, each exact in bf16) sum in f32 to
  JAX's result, bit for bit (moments, and the stochastically rounded
  table: the same keys).
* The two guards with JAX's messages, BatchNorm's running statistics after
  A microbatches against JAX's ``batch_stats`` (1e-6), and A = 2 on two
  gloo CPU ranks at mesh (2, 1) against A = 1 on the same ranks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_dist_workers as W
from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.models.dlrm import DLRM as JaxDLRM
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.nn.mlp import MLP as JaxMLP
from recommender_tpu_torch.convert import flax_to_state_dict, load_flax_params
from recommender_tpu_torch.core.optim import Adam, AdamSR
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticCTR, batch_iterator
from recommender_tpu_torch.models import DLRM, make_ctr_task
from recommender_tpu_torch.nn import MLP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)  # the steps donate


# ------------------------------------------------------------ A = 4 vs A = 1
class _Linear(nn.Module):
    def __init__(self, w0):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w0))


def test_grad_accumulation_matches_single_step():
    """accum_steps=A: the same params after one SGD update as A = 1 on the
    same batch (a deterministic loss, equal microbatches)."""
    rng = np.random.default_rng(0)
    batch = {"x": torch.tensor(rng.normal(size=(32, 4)), dtype=torch.float32),
             "y": torch.tensor(rng.normal(size=(32,)), dtype=torch.float32)}
    w0 = rng.normal(size=(4,)).astype(np.float32)
    outs = {}
    for a in (1, 4):
        model = _Linear(w0)

        def loss_fn(b, train, model=model):
            return (b["x"] @ model.w - b["y"]) ** 2, {}

        tr = Trainer(loss_fn, TrainConfig(learning_rate=0.1, optimizer="sgd", accum_steps=a),
                     device="cpu")
        state = tr.init_state(lambda: model)
        state, m = tr.train_step(state, batch)
        outs[a] = (model.w.detach().numpy().copy(), float(m["loss"]))
    assert not np.array_equal(outs[1][0], w0)
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=1e-5, atol=1e-6)
    assert abs(outs[1][1] - outs[4][1]) < 1e-5


# ------------------------------------------------------------ DLRM, A = 2
SMALL = dict(embed_dim=8, bottom_units=(32, 16, 8), top_units=(32, 16, 1))
VOCAB, BATCH, STEPS, LR, ACCUM = 1000, 256, 5, 1e-2, 2


@functools.lru_cache(maxsize=None)
def _batches():
    train = SyntheticCTR(vocab_size=VOCAB, seed=0).sample(STEPS * BATCH, 1)
    return train, list(batch_iterator(train, BATCH, seed=0))


@functools.lru_cache(maxsize=None)
def _run_jax(table_dtype):
    """(converted init, losses, [(params, mu, nu) after updates 1 and 5]),
    the MLPs computing in f32 (``DLRM`` builds them at bf16)."""
    import recommender_tpu.models.dlrm as jax_dlrm

    mlp = jax_dlrm.MLP
    jax_dlrm.MLP = functools.partial(mlp, compute_dtype=jnp.float32)
    try:
        return _jax_steps(table_dtype)
    finally:
        jax_dlrm.MLP = mlp


def _jax_steps(table_dtype):
    train, _ = _batches()
    model = JaxDLRM(vocab_size=VOCAB, embed_param_dtype=jnp.dtype(table_dtype), **SMALL)
    params, _ = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    init = _np_tree(params)
    loss_fn, eval_fn = jax_make_ctr_task(model)
    tr = JaxTrainer(loss_fn, JaxTrainConfig(learning_rate=LR, accum_steps=ACCUM), eval_fn=eval_fn)
    state = tr.init_state(lambda: (params, {}))
    losses, snaps = [], []
    for i, b in enumerate(jax_batch_iterator(train, BATCH, seed=0)):
        state, m = tr._train_step(state, tr.put_batch(b), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        if i in (0, STEPS - 1):
            adam = state.opt_state[0]
            snaps.append(tuple(flax_to_state_dict(_np_tree(t))
                               for t in (state.params, adam.mu, adam.nu)))
    return init, losses, snaps


def _run_port(init, table_dtype):
    _, batches = _batches()
    model = DLRM(VOCAB, embed_param_dtype=getattr(torch, table_dtype), **SMALL)
    load_flax_params(model, init)
    for m in (model.bottom_mlp, model.top_mlp):
        m.compute_dtype = torch.float32
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=LR, accum_steps=ACCUM), eval_fn,
                 device="cpu")
    state = tr.init_state(lambda: model)
    losses, snaps = [], []
    for i, b in enumerate(batches):
        state, m = tr.train_step(state, tr.put_batch(b))
        losses.append(float(m["loss"]))
        if i in (0, STEPS - 1):
            opt = state.optimizer
            names = {id(p): n for n, p in model.named_parameters()}
            moments = [{names[id(p)]: opt.state[p][w].clone() for p in opt.param_groups[0]["params"]}
                       for w in ("mu", "nu")]
            snaps.append(({n: p.detach().clone() for n, p in model.named_parameters()},
                          *moments))
    return state, losses, snaps


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("table_dtype,loss_tol", [("float32", 2e-3), ("bfloat16", 1e-2)])
def test_accum_2_matches_jax_accum_2(table_dtype, loss_tol):
    init, jax_losses, jax_snaps = _run_jax(table_dtype)
    state, losses, snaps = _run_port(init, table_dtype)
    # stochastic_round None: SR-Adam where the table is bf16, as in JAX
    assert type(state.optimizer) is (AdamSR if table_dtype == "bfloat16" else Adam)
    assert state.optimizer.count == STEPS
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=loss_tol)
    (params, mu, nu), (jparams, jmu, jnu) = snaps[0], jax_snaps[0]  # after one update
    for name, p in params.items():
        got, want = p.float().numpy(), jparams[name].float().numpy()
        assert p.dtype == jparams[name].dtype, name
        assert np.abs(got - want).max() <= 2 * LR, name
        assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name
        for ours, theirs in ((mu[name], jmu[name]), (nu[name], jnu[name])):
            o, t = ours.float().numpy(), theirs.float().numpy()
            assert ours.dtype == theirs.dtype, name
            tol = 5e-3 if ours.dtype == torch.float32 else 5e-2
            assert np.abs(o - t).max() <= tol * np.abs(t).max(), name
    (params, mu, nu), (jparams, jmu, jnu) = snaps[1], jax_snaps[1]  # after five
    for name, p in params.items():
        got, want = p.float().numpy(), jparams[name].float().numpy()
        assert np.abs(got - want).max() <= 2 * LR * STEPS, name
        assert _norm_rel(got, want) <= 0.05, name
        for ours, theirs in ((mu[name], jmu[name]), (nu[name], jnu[name])):
            assert _norm_rel(ours.float().numpy(), theirs.float().numpy()) <= 0.15, name


# ------------------------------------------------------------ f32 sums
class _Table(nn.Module):
    def __init__(self, t0):
        super().__init__()
        self.table = nn.Parameter(t0)


def test_accumulation_sums_a_bf16_tables_gradients_in_f32():
    """Microbatch gradients 256, 1, 1, -256 of row 0 (each exact in bf16;
    two rows a microbatch, the batch split over JAX's 8 test devices): a
    bf16 sum gives 0, the f32 sum 2, so the mean gradient is 0.5 and Adam's
    f32 first moment 0.05; the port's moments and SR-written table equal
    the JAX Trainer's bit for bit."""
    import flax.linen as fnn

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, b):
            t = self.param("table", fnn.initializers.normal(0.5), (8, 4), jnp.bfloat16)
            return jnp.take(t, b["ids"], axis=0).astype(jnp.float32).sum(-1)

    batch = {"ids": np.zeros(8, np.int32),
             "w": np.array([512.0, 0.0, 2.0, 0.0, 2.0, 0.0, -512.0, 0.0], np.float32)}
    jm = Tiny()
    params = jm.init(jax.random.PRNGKey(0), batch)["params"]
    t0 = np.asarray(params["table"])

    def jax_loss(p, ms, b, key, train):
        return b["w"] * jm.apply({"params": p}, b), {}, ms

    cfg = dict(learning_rate=1e-2, accum_steps=4, moment_dtype="float32")
    jtr = JaxTrainer(jax_loss, JaxTrainConfig(**cfg))
    jstate = jtr.init_state(lambda: (params, {}))
    jstate, _ = jtr._train_step(jstate, jtr.put_batch(batch), jax.random.PRNGKey(1))
    jmu = np.asarray(jstate.opt_state[0].mu["table"])
    jtable = np.asarray(jstate.params["table"].astype(jnp.float32))

    model = _Table(flax_to_state_dict({"table": t0})["table"])

    def loss_fn(b, train):
        return b["w"] * model.table[b["ids"]].float().sum(-1), {}

    tr = Trainer(loss_fn, TrainConfig(**cfg), device="cpu")
    state = tr.init_state(lambda: model)
    state, _ = tr.train_step(state, tr.put_batch(batch))
    mu = state.optimizer.state[model.table]["mu"]
    assert mu.dtype == torch.float32 and model.table.grad is None
    np.testing.assert_allclose(mu[0].numpy(), 0.05, rtol=1e-6)
    np.testing.assert_array_equal(mu.numpy(), jmu)
    np.testing.assert_array_equal(model.table.detach().float().numpy(), jtable)


# ------------------------------------------------------------ guards
def _dlrm_trainer(accum):
    model = DLRM(VOCAB, **SMALL)
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(accum_steps=accum), eval_fn, device="cpu")
    return tr, tr.init_state(lambda: model)


def test_accum_refuses_dedup_plans():
    from recommender_tpu_torch.data.pipeline import with_dedup_plans

    _, batches = _batches()
    tr, state = _dlrm_trainer(2)
    batch = tr.put_batch(next(with_dedup_plans(iter(batches))))
    with pytest.raises(ValueError, match=r"dedup plan keys \['cat_dedup'\] are incompatible "
                                         r"with accum_steps=2 \(plans index the whole-batch"):
        tr.train_step(state, batch)


def test_accum_must_divide_the_batch():
    _, batches = _batches()
    tr, state = _dlrm_trainer(3)
    with pytest.raises(ValueError, match="accum_steps=3 must divide the batch size 256"):
        tr.train_step(state, tr.put_batch(batches[0]))


def test_batchnorm_statistics_after_the_microbatches_match_jax():
    """The input BatchNorm's running statistics move once per microbatch,
    as JAX's ``model_state`` through its ``lax.scan``."""
    rng = np.random.default_rng(1)
    d = 12
    batch = {"x": (rng.normal(size=(64, d)) * 3.0 + 1.5).astype(np.float32),
             "y": rng.random(64).astype(np.float32)}
    jm = JaxMLP((16, 1), final_activation=jax.nn.sigmoid, input_batch_norm=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, d)))
    init = _np_tree(variables)  # the JAX step donates its state

    def jax_loss(p, ms, b, key, train):
        out, upd = jm.apply({"params": p, **ms}, b["x"], train=True, mutable=["batch_stats"])
        return (out[:, 0] - b["y"]) ** 2, {}, upd

    jtr = JaxTrainer(jax_loss, JaxTrainConfig(accum_steps=4))
    jstate = jtr.init_state(lambda: (variables["params"],
                                     {"batch_stats": variables["batch_stats"]}))
    jstate, _ = jtr._train_step(jstate, jtr.put_batch(batch), jax.random.PRNGKey(0))
    want = _np_tree(jstate.model_state["batch_stats"]["BatchNorm_0"])

    tm = MLP(d, (16, 1), final_activation=torch.sigmoid, input_batch_norm=True)
    load_flax_params(tm, init["params"], init["batch_stats"])

    def loss_fn(b, train):
        tm.train(train)
        return (tm(b["x"])[:, 0] - b["y"]) ** 2, {}

    tr = Trainer(loss_fn, TrainConfig(accum_steps=4), device="cpu")
    state = tr.init_state(lambda: tm)
    tr.train_step(state, tr.put_batch(batch))
    bn = tm.BatchNorm_0
    np.testing.assert_allclose(bn.mean.numpy(), want["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), want["var"], rtol=0, atol=1e-6)
    # four moves, not one: the whole batch's statistics would leave them elsewhere
    assert not np.allclose(bn.mean.numpy(), 0.01 * batch["x"].mean(0), atol=1e-4)


# ------------------------------------------------------------ two ranks
CTR = ["--synthetic", "--device", "cpu", "--vocab_size", "2000", "--embedding_size", "8",
       "--train_batch_size", "64", "--test_batch_size", "128", "--eval_batches", "2",
       "--log_every", "1", "--eval_every", "0", "--steps", "4", "--embed_dtype", "bf16",
       "--mesh_data", "2", "--num_processes", "2"]


def test_accum_on_a_data_axis_tracks_the_whole_batch_step(tmp_path):
    """Mesh (2, 1), each rank on its rows: with A = 2 the table's lookup
    gathers each microbatch's ids over data, and the other gradients
    average once a step, on the f32 sums. The ranks agree bit for bit, and
    follow the same two ranks at A = 1: the first loss (the same params on
    the same rows) within 1e-6, the four within 2e-3
    (``tests/test_torch_train.py``'s bound: the bf16 MLPs round a
    microbatch's sums apart from the whole batch's; measured 1.3e-4)."""
    runs = {}
    for accum in ("1", "2"):
        launch = ["--coordinator_address", f"file://{tmp_path}/rdzv_{accum}",
                  "--accum_steps", accum]
        runs[accum] = W.spawn(W.cli_main, 2, tmp_path, "train_ctr", CTR + launch, init=False)
    two = runs["2"]
    assert two[0]["losses"] == two[1]["losses"] and len(two[0]["losses"]) == 4
    np.testing.assert_array_equal(two[0]["tables"]["embedding"][0],
                                  two[1]["tables"]["embedding"][0])
    assert abs(two[0]["losses"][0] - runs["1"][0]["losses"][0]) <= 1e-6
    np.testing.assert_allclose(two[0]["losses"], runs["1"][0]["losses"], rtol=0, atol=2e-3)
