"""BASE, DIN and DIEN end to end on the CPU against the JAX package from one
converted init: forward and gradients, the padding invariance, ``Trainer``
trajectories, and the learning floors of ``tests/test_dien.py``.

Item vocab 200, cat vocab 20, dims 8 + 8, MLP (32, 16, 1); histories of 7
and 33 steps whose first three rows are all pad, full and one step long.

Tolerances:
* DIEN's auxiliary loss is f32 end to end (tables → GRU → ``AuxiliaryNet``):
  its value within 1e-5 abs, and the gradient of its mean with respect to
  every parameter it reaches and to both tables within 1e-4 of that
  gradient's largest magnitude. With bf16 tables the JAX lookup's backward
  sums the bf16 cotangent in bf16 and the port's in f32
  (``recommender_tpu_torch/PARITY.md``): table gradients within 2e-2 there.
* The head's MLP computes in bf16 on both sides, so the probabilities agree
  to 1e-3 abs and each parameter's gradient of the full loss to 2e-2 of that
  leaf's largest entry plus 1e-6 — 5e-2 for the head's bias leaves, which
  are bf16 sums over the batch that the frameworks round at different points
  (as in ``test_torch_bst.py``).
* ``shared_gather`` on and off: the same forward bit for bit; gradients
  within 1e-6 of their largest entry (one scatter-add over the concatenated
  ids sums a row's contributions in another order than three).
* Trainer, 20 steps at lr 1e-3 from one init: DIEN's per-step ``aux_loss``
  (f32) within 1e-4 abs (measured 1.2e-7); the per-step loss within 1e-3
  abs (measured 2.1e-4 BASE, 1.6e-4 DIN, 3.4e-4 DIEN: the bf16 head's
  rounding differences, which grow through Adam as for BST); final eval AUC
  within 1e-3 (measured ≤ 4.3e-4) and eval loss within 1e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from recommender_tpu.models.dien import DIEN as JaxDIEN
from recommender_tpu.models.dien import DIN as JaxDIN
from recommender_tpu.models.dien import BaseModel as JaxBaseModel
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_aux_loss_task as jax_make_aux_loss_task
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.nn.losses import binary_cross_entropy as jax_bce
from recommender_tpu_torch.convert import flax_to_state_dict, jax_leaf_order, load_flax_params
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticSequence, batch_iterator
from recommender_tpu_torch.models import (
    DIEN,
    DIN,
    BaseModel,
    init_model,
    make_aux_loss_task,
    make_ctr_task,
)
from recommender_tpu_torch.nn.losses import binary_cross_entropy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = dict(item_vocab=200, cat_vocab=20, item_dim=8, cat_dim=8, mlp_units=(32, 16, 1))
DIEN_KW = dict(extract_hidden=12, evolve_hidden=10)  # hidden != input, evolve_hidden != dim
MODELS = {
    "BASE": (JaxBaseModel, BaseModel, {}),
    "DIN": (JaxDIN, DIN, {}),
    "DIEN": (JaxDIEN, DIEN, DIEN_KW),
}
BATCH = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n, seed, t, rows=True):
    b = SyntheticSequence(num_items=200, num_cats=20, max_len=t).sample(n, seed)
    if rows:  # row 0 all pad, row 1 full, row 2 one step
        for k in ("pos_his_item", "pos_his_cat"):
            b[k][0] = 0
            b[k][1] = np.maximum(b[k][1], 1)
            b[k][2, 1:] = 0
            b[k][2, 0] = max(b[k][2, 0], 1)
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_case(kind, t, table_dtype):
    """JAX model, converted init, batch, and what the JAX side computes in
    train mode: prob, aux loss, gradients of the full loss and of the mean
    auxiliary loss alone."""
    jax_cls, _, kw = MODELS[kind]
    model = jax_cls(**SMALL, **kw, embed_param_dtype=jnp.dtype(table_dtype))
    batch = _batch(BATCH, 1 + t, t)
    params, model_state = jax_init_model(model, batch)

    def outputs(p):
        out, _ = model.apply({"params": p, **model_state}, batch, train=True,
                             mutable=["batch_stats"])
        return out if kind == "DIEN" else (out, jnp.zeros_like(out))

    def loss(p):
        prob, aux = outputs(p)
        return jnp.mean(jax_bce(prob, batch["label"]) + aux), (prob, aux)

    (_, (prob, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    aux_grads = None
    if kind == "DIEN":
        aux_grads = _np_tree(jax.jit(jax.grad(lambda p: jnp.mean(outputs(p)[1])))(params))
    return (model, _np_tree(params), _np_tree(model_state), batch,
            np.asarray(prob), np.asarray(aux), _np_tree(grads), aux_grads)


def _port(kind, params, model_state, table_dtype="float32", **kw):
    _, cls, model_kw = MODELS[kind]
    model = cls(**SMALL, **model_kw, embed_param_dtype=getattr(torch, table_dtype), **kw)
    return load_flax_params(model, params, model_state["batch_stats"])


def _port_outputs(kind, model, batch):
    out = model(_torch_batch(batch))
    return out if kind == "DIEN" else (out, torch.zeros_like(out))


def _grads(model):
    return {n: p.grad.float().numpy() for n, p in model.named_parameters() if p.grad is not None}


def _full_loss_grads(kind, model, batch):
    model.zero_grad()
    model.train()
    prob, aux = _port_outputs(kind, model, batch)
    (binary_cross_entropy(prob, torch.from_numpy(batch["label"])) + aux).mean().backward()
    return prob.detach().numpy(), aux.detach().numpy(), _grads(model)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


# ------------------------------------------------- forward and gradients
@pytest.mark.parametrize("shared_gather", [False, True], ids=["per_set", "shared_gather"])
@pytest.mark.parametrize(
    "kind,t",
    [("BASE", 7), ("DIN", 7), ("DIN", 33), ("DIEN", 7), ("DIEN", 33)],
)
def test_forward_and_param_grads_match_jax(kind, t, shared_gather):
    _, params, model_state, batch, want_prob, want_aux, want_grads, _ = _jax_case(
        kind, t, "float32")
    model = _port(kind, params, model_state, shared_gather=shared_gather)
    prob, aux, grads = _full_loss_grads(kind, model, batch)
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-3)
    np.testing.assert_allclose(aux, want_aux, rtol=0, atol=1e-5)
    want = flax_to_state_dict(want_grads)
    assert set(grads) == set(want)
    for name, w in want.items():
        w = w.numpy()
        tol = 5e-2 if name.startswith("mlp.Dense_") and name.endswith(".bias") else 2e-2
        err = np.abs(grads[name] - w).max()
        assert err <= tol * np.abs(w).max() + 1e-6, (name, err, np.abs(w).max())


@pytest.mark.parametrize("shared_gather", [False, True], ids=["per_set", "shared_gather"])
@pytest.mark.parametrize(
    "t,table_dtype", [(7, "float32"), (33, "float32"), (7, "bfloat16")],
)
def test_dien_auxiliary_path_matches_jax_in_f32(t, table_dtype, shared_gather):
    """The f32 path: tables → GRU → AuxiliaryNet → masked auxiliary loss."""
    _, params, model_state, batch, _, want_aux, _, want_grads = _jax_case("DIEN", t, table_dtype)
    model = _port("DIEN", params, model_state, table_dtype, shared_gather=shared_gather)
    model.train()
    _, aux = model(_torch_batch(batch))
    aux.mean().backward()
    np.testing.assert_allclose(aux.detach().numpy(), want_aux, rtol=0, atol=1e-5)
    assert aux[0].item() == 0.0 and aux[2].item() == 0.0  # no valid next step
    grads = _grads(model)
    reached = {n for n in grads if n.split(".")[0] in
               ("item_embedding", "cat_embedding", "extract_gru", "auxiliary_net")}
    assert reached == {n for n in grads if np.abs(grads[n]).max() > 0}
    want = flax_to_state_dict(want_grads)
    for name in sorted(reached):
        table = name.endswith("embedding.embedding")
        tol = 2e-2 if table and table_dtype == "bfloat16" else 1e-4
        assert _rel_err(grads[name], want[name].float().numpy()) <= tol, name


@pytest.mark.parametrize("kind", ["BASE", "DIN", "DIEN"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_shared_gather_equals_per_set_lookups(kind, table_dtype):
    _, params, model_state, batch, *_ = _jax_case(kind, 7, table_dtype)
    runs = []
    for shared in (False, True):
        model = _port(kind, params, model_state, table_dtype, shared_gather=shared)
        runs.append(_full_loss_grads(kind, model, batch))
    (prob, aux, grads), (prob_s, aux_s, grads_s) = runs
    np.testing.assert_array_equal(prob, prob_s)
    np.testing.assert_array_equal(aux, aux_s)
    for name in grads:
        # a bf16 table's gradient is rounded once more, after the f32 sum
        tol = 1e-2 if table_dtype == "bfloat16" and "embedding" in name else 1e-6
        assert _rel_err(grads_s[name], grads[name]) <= tol, name


def test_dien_head_takes_target_and_final_state():
    """The head is ``dim + evolve_hidden`` wide, not ``2 * dim``: a JAX init
    at unequal widths loads, and the leaf order is JAX's flatten order."""
    _, params, model_state, *_ = _jax_case("DIEN", 7, "float32")
    assert params["mlp"]["Dense_0"]["kernel"].shape[0] == 16 + DIEN_KW["evolve_hidden"]
    model = _port("DIEN", params, model_state)
    assert model.mlp.Dense_0.in_features == 26 and model.mlp.BatchNorm_0.weight.shape == (26,)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(p.key for p in path) for path, _ in leaves]
    port_names = [n.replace(".weight", ".kernel") if "BatchNorm" not in n else
                  n.replace(".weight", ".scale") for n, _ in jax_leaf_order(model)]
    assert port_names == names
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {
        "item_embedding", "cat_embedding", "mlp", "extract_gru", "auxiliary_net",
        "attention", "evolve"}
    assert "local_activation_unit.Dense_2.weight" in dict(DIN(**SMALL).named_parameters())


def test_dien_eval_mode_and_padding_invariance():
    """Eval mode (running stats) against JAX, and the JAX package's
    padding-invariance check: appending pad steps leaves the prob unchanged
    (2e-5 abs, as in ``tests/test_dien.py``)."""
    jm, params, model_state, batch, *_ = _jax_case("DIEN", 7, "float32")
    want, _ = jm.apply({"params": params, **model_state}, batch)
    model = _port("DIEN", params, model_state).eval()
    with torch.no_grad():
        p1, _ = model(_torch_batch(batch))
        padded = {
            **batch,
            "pos_his_item": np.pad(batch["pos_his_item"], ((0, 0), (0, 4))),
            "pos_his_cat": np.pad(batch["pos_his_cat"], ((0, 0), (0, 4))),
            "neg_his_item": np.pad(batch["neg_his_item"], ((0, 0), (0, 4)), constant_values=1),
            "neg_his_cat": np.pad(batch["neg_his_cat"], ((0, 0), (0, 4)), constant_values=1),
        }
        p3, _ = model(_torch_batch(padded))
    np.testing.assert_allclose(p1.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    np.testing.assert_allclose(p1.numpy(), p3.numpy(), rtol=0, atol=2e-5)


def test_dien_remat_on_and_off_agree():
    _, params, model_state, batch, *_ = _jax_case("DIEN", 33, "float32")
    runs = []
    for remat in (False, True):
        model = _port("DIEN", params, model_state, remat=remat)
        runs.append(_full_loss_grads("DIEN", model, batch))
    (prob, aux, grads), (prob_r, aux_r, grads_r) = runs
    np.testing.assert_array_equal(prob, prob_r)
    np.testing.assert_array_equal(aux, aux_r)
    for name in grads:
        assert _rel_err(grads_r[name], grads[name]) <= 1e-5, name


def test_init_model_redraws_every_part():
    model = DIEN(item_vocab=300, cat_vocab=30)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    init_model(model, seed=5)
    for name, p in model.named_parameters():
        if name.endswith(("bias", "b_gates", "b_cand")):
            assert not p.detach().numpy().any(), name
        elif "BatchNorm" not in name:
            assert not torch.equal(p, before[name]), name
    again = init_model(DIEN(item_vocab=300, cat_vocab=30), seed=5)
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n


# ------------------------------------------------------------------ Trainer
STEPS, LR, T = 20, 1e-3, 12


@functools.lru_cache(maxsize=None)
def _data():
    return _batch(STEPS * BATCH * 2, 5, T, rows=False), _batch(8 * BATCH, 6, T, rows=False)


def _task(kind, jax_side):
    if kind == "DIEN":
        return jax_make_aux_loss_task if jax_side else make_aux_loss_task
    return jax_make_ctr_task if jax_side else make_ctr_task


@functools.lru_cache(maxsize=None)
def _run_jax(kind):
    train, test = _data()
    jax_cls, _, kw = MODELS[kind]
    model = jax_cls(**SMALL, **kw)
    params, model_state = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    init = (_np_tree(params), _np_tree(model_state))  # the JAX step donates its state
    loss_fn, eval_fn = _task(kind, True)(model)
    trainer = JaxTrainer(
        loss_fn, JaxTrainConfig(learning_rate=LR, log_every=1, eval_every=0), eval_fn=eval_fn
    )
    state = trainer.init_state(lambda: (params, model_state))
    logs = []
    state, _ = trainer.fit(state, jax_batch_iterator(train, 2 * BATCH, seed=0), STEPS,
                           log_fn=logs.append)
    ev = trainer.evaluate(state, jax_batch_iterator(test, 2 * BATCH, shuffle=False), exact=True)
    return init, logs, ev


@pytest.mark.parametrize("kind", ["BASE", "DIN", "DIEN"])
def test_trainer_tracks_jax_trainer(kind):
    (params, model_state), jax_logs, jax_ev = _run_jax(kind)
    train, test = _data()
    model = _port(kind, params, model_state)
    loss_fn, eval_fn = _task(kind, False)(model)
    trainer = Trainer(
        loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0), eval_fn, device="cpu"
    )
    state = trainer.init_state(lambda: model)
    logs = []
    state, _ = trainer.fit(state, batch_iterator(train, 2 * BATCH, seed=0), STEPS,
                           log_fn=logs.append)
    assert state.step == STEPS == len(logs) == len(jax_logs)
    tols = dict(loss=1e-3, aux_loss=1e-4) if kind == "DIEN" else dict(loss=1e-3)
    for key, tol in tols.items():
        np.testing.assert_allclose([m[key] for m in logs], [m[key] for m in jax_logs],
                                   rtol=0, atol=tol, err_msg=key)
    ev = trainer.evaluate(state, batch_iterator(test, 2 * BATCH, shuffle=False), exact=True)
    assert ev["eval_batches"] == jax_ev["eval_batches"] == 4
    assert abs(ev["eval_auc_exact"] - jax_ev["eval_auc_exact"]) < 1e-3
    assert abs(ev["eval_loss"] - jax_ev["eval_loss"]) < 1e-3


# --------------------------------------------------------- learning floors
@pytest.mark.parametrize("kind", ["BASE", "DIN", "DIEN"])
def test_model_learns(kind):
    """``tests/test_dien.py``'s floors: 150 steps at lr 3e-3, batch 128, on
    the default ``SyntheticSequence``; eval AUC > 0.62."""
    gen = SyntheticSequence(seed=0)
    train, test = gen.sample(8000, seed=1), gen.sample(2000, seed=2)
    cls = MODELS[kind][1]
    kw = dict(extract_hidden=16, evolve_hidden=16) if kind == "DIEN" else {}
    model = cls(item_vocab=gen.num_items, cat_vocab=gen.num_cats, item_dim=8, cat_dim=8,
                mlp_units=(32, 16, 1), **kw)
    init_model(model, seed=0)
    loss_fn, eval_fn = _task(kind, False)(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9), eval_fn,
                      device="cpu")
    state = trainer.init_state(lambda: model)
    state, _ = trainer.fit(state, batch_iterator(train, 128, seed=0, epochs=None), steps=150)
    auc = trainer.evaluate(state, batch_iterator(test, 400, shuffle=False))["eval_auc"]
    assert auc > 0.62, auc
