"""The multi-task family against the JAX package on the CPU, from one
converted JAX init: ``ExpertBank`` and ``MMOEGate``, ``FeatureEmbedder``
(per-table f32 and bf16, stacked with out-of-range ids), ``MultiTaskBase``,
``ESMM`` and ``MMOE`` heads and gradients, ``make_multitask_task``'s
losses, ``evaluate_head``, 20 ``Trainer`` steps against the JAX Trainer,
and the converter with JAX's leaf order for every model.

Four features of vocab 50, D 8, batch 64; MMOE with 4 experts of (16, 8)
and towers (8, 1); ESMM's towers (16, 8, 1); BASE's MLP (16, 8, 2).

Tolerances (as ``tests/test_torch_ctr.py``; the MLPs, towers and experts
compute in bf16 on both sides):
* heads and per-example losses within 1e-5 relative;
* gradients, each within a share of the leaf's largest entry: 1e-4
  (``GRAD_TOL``) but for the bf16 layers' bias leaves, 2e-2
  (``MLP_BIAS_TOL``: a bias gradient is a bf16 sum over the batch that the
  frameworks round at different points), and a bf16 table's, one bf16 ulp
  of its largest entry (``BF16_TABLE_TOL`` = 2^-8 of a power of two: both
  sides sum its rows in f32, JAX's through its f32 Pallas path here, in
  other orders and round once; ``test_torch_ctr.py`` takes 2^-8 of the
  largest entry itself, half an ulp short where that entry lies just under
  a power of two);
* Trainer, 20 steps from one init: the per-step losses within 1e-3 abs.

The gradients are JAX's taken op by op, without ``jax.jit``: under jit XLA
folds the bf16 rounding of a bf16 ``Dense``'s input cotangent into the
product, so the compiled backward carries the tables' cotangent in f32
where the program (and the port's eager backward) rounds it to bf16
(``recommender_tpu_torch/PARITY.md``). Op by op the tables' gradients agree
bit for bit in f32; the Trainer comparison runs JAX's jitted step.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.models.esmm import ESMM as JaxESMM
from recommender_tpu.models.esmm import MMOE as JaxMMOE
from recommender_tpu.models.esmm import FeatureEmbedder as JaxFeatureEmbedder
from recommender_tpu.models.esmm import MultiTaskBase as JaxMultiTaskBase
from recommender_tpu.models.tasks import evaluate_head as jax_evaluate_head
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.models.tasks import make_head_eval as jax_make_head_eval
from recommender_tpu.models.tasks import make_multitask_task as jax_make_multitask_task
from recommender_tpu.nn.moe import ExpertBank as JaxExpertBank
from recommender_tpu.nn.moe import MMOEGate as JaxMMOEGate
from recommender_tpu_torch.convert import flax_to_state_dict, jax_leaf_order, load_flax_params
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticMultiTask, batch_iterator
from recommender_tpu_torch.models import (
    ESMM,
    MMOE,
    FeatureEmbedder,
    MultiTaskBase,
    evaluate_head,
    init_model,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
)
from recommender_tpu_torch.nn import ExpertBank, MMOEGate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F, V, D, BATCH = 4, 50, 8, 64
VOCABS = (V,) * F
GRAD_TOL, MLP_BIAS_TOL, BF16_TABLE_TOL = 1e-4, 2e-2, 2.0**-8
MODELS = {
    "BASE": (JaxMultiTaskBase, MultiTaskBase, dict(mlp_units=(16, 8, 2))),
    "ESMM": (JaxESMM, ESMM, dict(mlp_units=(16, 8, 1))),
    "MMOE": (JaxMMOE, MMOE, dict(num_experts=4, expert_units=(16, 8), tower_units=(8, 1))),
}
# (kind, table dtype, stacked tables)
CASES = [("BASE", "float32", False), ("ESMM", "float32", False), ("ESMM", "bfloat16", False),
         ("MMOE", "float32", False), ("MMOE", "bfloat16", False), ("MMOE", "float32", True)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _bf16_table_err(got, want):
    """The largest difference in bf16 ulps of the leaf's largest entry."""
    want = np.asarray(want, np.float32)
    ulp = BF16_TABLE_TOL * 2.0 ** np.ceil(np.log2(np.abs(want).max() + 1e-30))
    return np.abs(got - want).max() / ulp


def _batch(n=BATCH, seed=1):
    data = SyntheticMultiTask(num_feats=F, seed=0).sample(n, seed=seed)
    return {**data, "label": data["click"]}  # BASE's CTR model reads "label"


@contextlib.contextmanager
def _f32_table_backward():
    """JAX's per-table lookup backward at these sizes is ``jnp.take``'s
    scatter, which sums a bf16 cotangent in bf16; the port's sums in f32
    (``PARITY.md``). Route JAX's through its own f32 path, the sorted
    scatter-add Pallas kernel in interpret mode, as ``test_torch_ctr.py``
    does."""
    from jax.experimental import pallas as pl

    from recommender_tpu.ops import embedding_kernels as jax_ek

    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        mp.setattr(jax_ek, "use_padded_backward", lambda shape, n_ids: True)
        mp.setattr(jax_ek, "PADDED_BWD_MAX_ROWS", 0)
        mp.setattr(jax_ek, "_pallas_available", lambda: True)
        yield


def _backward_ctx(table_dtype):
    return _f32_table_backward() if table_dtype == "bfloat16" else contextlib.nullcontext()


def _jax_model(kind, table_dtype="float32", stack=False):
    cls, _, kw = MODELS[kind]
    return cls(vocab_sizes=VOCABS, embed_dim=D, stack_tables=stack,
               embed_param_dtype=jnp.dtype(table_dtype), **kw)


def _port(kind, params, table_dtype="float32", stack=False):
    _, cls, kw = MODELS[kind]
    model = cls(VOCABS, D, stack_tables=stack, embed_param_dtype=getattr(torch, table_dtype), **kw)
    return load_flax_params(model, params)


def _tasks(kind, jax_side):
    if kind == "BASE":
        return jax_make_ctr_task if jax_side else make_ctr_task
    return jax_make_multitask_task if jax_side else make_multitask_task


def _check_grads(got_model, jax_grads, table_dtype):
    want = flax_to_state_dict(jax_grads)
    got = {n: p.grad.float().numpy() for n, p in got_model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        tol = GRAD_TOL
        if name.endswith("bias") and not name.startswith("gate_"):
            tol = MLP_BIAS_TOL  # a bf16 layer's bias
        elif name.endswith("embedding") and table_dtype == "bfloat16":
            assert _bf16_table_err(got[name], w.float().numpy()) <= 1.0, name
            continue
        assert _rel_err(got[name], w.float().numpy()) <= tol, name


# ------------------------------------------------------------ moe layers
def test_expert_bank_and_gate_match_jax():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(16, 12)).astype(np.float32)
    bank, gate = JaxExpertBank(4, (16, 8)), JaxMMOEGate(4)
    bank_p = bank.init(jax.random.PRNGKey(0), jnp.asarray(x0))["params"]
    experts0 = np.asarray(bank.apply({"params": bank_p}, x0))
    gate_p = gate.init(jax.random.PRNGKey(1), jnp.asarray(x0), experts0)["params"]

    def jax_fn(bp, gp, x):
        e = bank.apply({"params": bp}, x)
        return e, gate.apply({"params": gp}, x, e)

    (want_e, want_mix), vjp = jax.vjp(jax_fn, bank_p, gate_p, jnp.asarray(x0))
    cot_e = rng.normal(size=want_e.shape).astype(np.float32)
    cot_mix = rng.normal(size=want_mix.shape).astype(np.float32)
    want_gb, want_gg, want_gx = vjp((jnp.asarray(cot_e), jnp.asarray(cot_mix)))

    tb = load_flax_params(ExpertBank(4, 12, (16, 8)), _np_tree(bank_p))
    tg = load_flax_params(MMOEGate(12, 4), _np_tree(gate_p))
    assert tb.experts.Dense_0.kernel.shape == (4, 12, 16)  # one [E, in, out] param
    assert [n for n, _ in jax_leaf_order(tb)] == [
        f"experts.Dense_{i}.{w}" for i in range(2) for w in ("bias", "kernel")]
    x = torch.from_numpy(x0).requires_grad_()
    e = tb(x)
    mix = tg(x, e)
    assert e.dtype == mix.dtype == torch.float32 and e.shape == (16, 4, 8)
    torch.autograd.backward([e, mix], [torch.from_numpy(cot_e), torch.from_numpy(cot_mix)])
    assert _rel_err(e.detach().numpy(), want_e) <= 1e-5
    assert _rel_err(mix.detach().numpy(), want_mix) <= 1e-5
    assert _rel_err(x.grad.numpy(), want_gx) <= GRAD_TOL
    for module, grads in ((tb, want_gb), (tg, want_gg)):
        params = dict(module.named_parameters())
        for name, w in flax_to_state_dict(_np_tree(grads)).items():
            tol = MLP_BIAS_TOL if name.startswith("experts") and name.endswith("bias") else GRAD_TOL
            assert _rel_err(params[name].grad.numpy(), w.numpy()) <= tol, name


# ------------------------------------------------------- FeatureEmbedder
@pytest.mark.parametrize("table_dtype,stack", [("float32", False), ("bfloat16", False),
                                               ("float32", True)])
def test_feature_embedder_matches_jax(table_dtype, stack):
    feats = _batch()["features"].copy()
    if stack:  # out of range: each clipped into its own feature's segment
        feats[0, 1], feats[1, 2], feats[2, 3] = V + 25, -4, V
    jm = JaxFeatureEmbedder(VOCABS, D, stack=stack, param_dtype=jnp.dtype(table_dtype))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"]
    want, vjp = jax.vjp(lambda p: jm.apply({"params": p}, feats), params)
    cot = np.random.default_rng(0).normal(size=want.shape).astype(np.float32)
    with _backward_ctx(table_dtype):
        (want_g,) = vjp(jnp.asarray(cot))
    model = load_flax_params(
        FeatureEmbedder(VOCABS, D, stack=stack, param_dtype=getattr(torch, table_dtype)),
        _np_tree(params))
    out = model(torch.from_numpy(feats))
    assert out.dtype == torch.float32 and out.shape == (BATCH, F * D)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))  # a gather
    grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    for name, w in flax_to_state_dict(_np_tree(want_g)).items():
        if table_dtype == "bfloat16":
            assert _bf16_table_err(grads[name], w.float().numpy()) <= 1.0, name
        else:
            assert _rel_err(grads[name], w.float().numpy()) <= GRAD_TOL, name
    if stack:
        assert list(grads) == ["stacked_embedding"]
        table = model.stacked_embedding.detach()
        np.testing.assert_array_equal(out[0, D:2 * D].detach(), table[V + V - 1])
        np.testing.assert_array_equal(out[1, 2 * D:3 * D].detach(), table[2 * V])
        np.testing.assert_array_equal(out[2, 3 * D:].detach(), table[4 * V - 1])


def test_unported_policies_raise():
    # per-feature policies and sharded tables are ported (tests/test_torch_distributed.py);
    # a policy tuple makes the tables separate, as in JAX
    emb = FeatureEmbedder(VOCABS, D, stack=True, lookup_modes=("gspmd",) * F)
    assert not emb.stack and len(emb.tables()) == F
    assert [t.lookup_mode for t in FeatureEmbedder(
        VOCABS, D, lookup_modes=("psum", "a2a") * (F // 2) + ("psum",) * (F % 2)).tables()][:2] == [
        "psum", "a2a"]
    with pytest.raises(ValueError, match="per-feature"):
        FeatureEmbedder(VOCABS, D, partition=("model",) * (F + 1))
    with pytest.raises(ValueError, match="only the gspmd lookup"):
        FeatureEmbedder(VOCABS, D, stack=True, lookup_modes="a2a")
    with pytest.raises(ValueError, match="f32-only"):
        FeatureEmbedder(VOCABS, D, stack=True, param_dtype=torch.bfloat16)


# ------------------------------------------------------ models and task
@functools.lru_cache(maxsize=None)
def _jax_case(kind, table_dtype, stack):
    """JAX model, its init, the batch, the eval heads, the task's per-example
    loss and aux, and the gradients of the mean loss."""
    model = _jax_model(kind, table_dtype, stack)
    batch = _batch()
    params = jax_init_model(model, batch)[0]
    loss_fn, _ = _tasks(kind, True)(model)

    def mean_loss(p):
        per_ex, aux, _ = loss_fn(p, {}, batch, None, True)
        return jnp.mean(per_ex), (per_ex, aux)

    with _backward_ctx(table_dtype):  # op by op: see the module docstring
        (_, (per_ex, aux)), grads = jax.value_and_grad(mean_loss, has_aux=True)(params)
    heads = jax.jit(lambda p: model.apply({"params": p}, batch))(params)
    return (_np_tree(params), batch, _np_tree(heads), np.asarray(per_ex),
            {k: float(v) for k, v in aux.items()}, _np_tree(grads))


@pytest.mark.parametrize("kind,table_dtype,stack", CASES)
def test_heads_and_grads_match_jax(kind, table_dtype, stack):
    params, batch, want_heads, want_per_ex, want_aux, want_grads = _jax_case(
        kind, table_dtype, stack)
    model = _port(kind, params, table_dtype, stack)
    loss_fn, _ = _tasks(kind, False)(model)
    per_ex, aux = loss_fn(_torch_batch(batch), True)
    per_ex.mean().backward()
    assert _rel_err(per_ex.detach().numpy(), want_per_ex) <= 1e-5
    assert set(aux) == set(want_aux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), want_aux[k], rtol=1e-5, err_msg=k)
    model.eval()
    with torch.no_grad():
        heads = model(_torch_batch(batch))
    if kind == "BASE":
        heads, want_heads = {"prob": heads}, {"prob": want_heads}
    assert set(heads) == set(want_heads)
    for k, h in heads.items():
        assert h.dtype == torch.float32 and h.shape == (BATCH,)
        assert _rel_err(h.numpy(), want_heads[k]) <= 1e-5, k
    _check_grads(model, want_grads, table_dtype)


@pytest.mark.parametrize("kind,table_dtype,stack", [c for c in CASES if c[1] == "float32"])
def test_converter_and_leaf_order(kind, table_dtype, stack):
    params = _jax_case(kind, table_dtype, stack)[0]
    model = _port(kind, params, table_dtype, stack)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(p.key for p in path) for path, leaf in leaves]
    names = [n[: -len("kernel")] + "weight" if n.endswith("kernel") and leaf.ndim == 2 else n
             for n, (_, leaf) in zip(names, leaves)]
    assert [n for n, _ in jax_leaf_order(model)] == names
    if kind == "MMOE":
        assert "expert_bank.experts.Dense_0.kernel" in names and "gate_1.Dense_0.weight" in names
        assert ("embedder.stacked_embedding" in names) == stack
    again = init_model(_port(kind, params, table_dtype, stack), seed=3)
    for name, p in again.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().numpy().any(), name
        else:
            assert not torch.equal(p, dict(model.named_parameters())[name]), name


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("head,label", [("cvr", "purchase"), ("ctcvr", "purchase")])
def test_evaluate_head_matches_jax(head, label, exact):
    params, *_ = _jax_case("MMOE", "float32", False)
    jm = _jax_model("MMOE")
    test = SyntheticMultiTask(num_feats=F, seed=0).sample(4 * BATCH, seed=2)
    jax_trainer = JaxTrainer(lambda *a: None, JaxTrainConfig())
    jstate = jax_trainer.init_state(lambda: (params, {}))
    want = jax_evaluate_head(jax_trainer, jstate, jax_batch_iterator(test, BATCH, shuffle=False),
                             jax_make_head_eval(jm, head, label), exact=exact)
    model = _port("MMOE", params)
    trainer = Trainer(lambda *a: None, TrainConfig(), device="cpu")
    state = trainer.init_state(lambda: model)
    got = evaluate_head(trainer, state, batch_iterator(test, BATCH, shuffle=False),
                        make_head_eval(model, head, label), exact=exact)
    assert isinstance(got, float) and 0.0 < got < 1.0
    assert abs(got - want) <= 1e-3


# ---------------------------------------------------------------- Trainer
STEPS, LR = 20, 1e-3


@functools.lru_cache(maxsize=None)
def _data():
    gen = SyntheticMultiTask(num_feats=F, seed=0)
    return gen.sample(STEPS * BATCH, seed=1)


@functools.lru_cache(maxsize=None)
def _run_jax(kind, table_dtype):
    train = _data()
    model = _jax_model(kind, table_dtype)
    params, model_state = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    init = _np_tree(params)  # the JAX step donates its state
    loss_fn, eval_fn = jax_make_multitask_task(model)
    trainer = JaxTrainer(loss_fn, JaxTrainConfig(learning_rate=LR, log_every=1, eval_every=0),
                         eval_fn=eval_fn)
    state = trainer.init_state(lambda: (params, model_state))
    logs = []
    with _backward_ctx(table_dtype):
        trainer.fit(state, jax_batch_iterator(train, BATCH, seed=0), STEPS, log_fn=logs.append)
    return init, logs


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ESMM", "MMOE"])
def test_trainer_tracks_jax_trainer(kind, table_dtype):
    params, jax_logs = _run_jax(kind, table_dtype)
    model = _port(kind, params, table_dtype)
    loss_fn, eval_fn = make_multitask_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0), eval_fn,
                      device="cpu")
    state = trainer.init_state(lambda: model)
    logs = []
    state, _ = trainer.fit(state, batch_iterator(_data(), BATCH, seed=0), STEPS,
                           log_fn=logs.append)
    assert state.step == STEPS == len(logs) == len(jax_logs)
    for key in ("loss", "ctr_loss", "ctcvr_loss"):
        np.testing.assert_allclose([m[key] for m in logs], [m[key] for m in jax_logs],
                                   rtol=0, atol=1e-3, err_msg=key)
