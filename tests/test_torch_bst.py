"""BST end to end on the CPU: the converter's new leaves, the transformer
block on both attention paths, BST's forward and parameter gradients, and
a few Trainer steps, each against the JAX package from one converted init.

BST item vocab 200, cat vocab 20, dims 8 + 8, 4 heads (Dh 4), 2 blocks,
MLP (32, 16, 1); histories of 12 with an all-pad history in every batch.

Tolerances:
* transformer block (f32 throughout): outputs 2e-5 abs, gradients 1e-4 abs.
  The flash path (``flash_mha_ref`` here; JAX's Pallas flash in interpret
  mode) is compared on valid rows, with a cotangent that is zero on pad
  rows, as the two define pad rows differently.
* BST: the MLP head computes in bf16, so the probabilities agree to
  1e-3 abs, and each parameter gradient to 2e-2 of that leaf's largest
  entry plus 1e-6 — 5e-2 for the head's bias leaves, which are bf16 sums
  over the batch that the frameworks round at different points (measured
  2.5e-2 for ``mlp/Dense_2/bias``, ≤ 8.4e-3 elsewhere).
* Trainer, lr 1e-3 (``TrainConfig``'s default): per-step loss within 2e-3
  abs (measured 3.4e-4), BatchNorm running stats within 1e-2 of their
  largest entry (measured 3.4e-3), eval AUC within 5e-3 (measured 6e-4).
  The trajectories drift apart at a rate set by the learning rate: the
  batch-statistics BatchNorm makes the loss nearly blind to some leaves
  (the last LayerNorm's scale and bias), whose gradients are then at the
  level of f32 roundoff, and Adam turns those into full-size steps that
  move the running stats.
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
from recommender_tpu.models.bst import BST as JaxBST
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu.models.tasks import make_ctr_task as jax_make_ctr_task
from recommender_tpu.nn.losses import binary_cross_entropy as jax_bce
from recommender_tpu.nn.transformer import TransformerBlock as JaxTransformerBlock
from recommender_tpu_torch.convert import flax_to_state_dict, jax_leaf_order, load_flax_params
from recommender_tpu_torch.core.mesh import Mesh
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticSequence, batch_iterator
from recommender_tpu_torch.models import BST, init_model, make_ctr_task
from recommender_tpu_torch.nn import TransformerBlock
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
T, BATCH = 12, 64


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _path_name(path):
    return "/".join(p.key for p in path)


def _port_name(path, leaf):
    """The port's ``state_dict`` name of a flax leaf, and the leaf in the
    port's layout."""
    keys = [p.key for p in path]
    leaf = np.asarray(leaf)
    if keys[-1] == "kernel" and leaf.ndim == 2:  # Dense → Linear
        keys[-1], leaf = "weight", leaf.T
    elif keys[-1] == "scale":  # LayerNorm / BatchNorm
        keys[-1] = "weight"
    return ".".join(keys), leaf


def _batch(n, seed, empty_row=True):
    b = SyntheticSequence(num_items=200, num_cats=20, max_len=T).sample(n, seed)
    b = {k: v for k, v in b.items() if not k.startswith("neg_")}
    if empty_row:
        b["pos_his_item"][0] = 0
        b["pos_his_cat"][0] = 0
    return b


@functools.lru_cache(maxsize=None)
def _jax_bst():
    batch = _batch(32, 1)
    model = JaxBST(**SMALL)
    params, model_state = jax_init_model(model, batch)
    return model, _np_tree(params), _np_tree(model_state), batch


def _port_bst(params, model_state, **kw):
    model = BST(**SMALL, **kw)
    return load_flax_params(model, params, model_state["batch_stats"])


def _set_flash(model, on):
    for blk in model.blocks():
        blk.use_flash = on


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


# ------------------------------------------------------------- converter
def test_converter_maps_dense_general_norms_embed_and_batch_stats():
    _, params, model_state, _ = _jax_bst()
    state = flax_to_state_dict(params, model_state["batch_stats"])
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in leaves:
        name, want = _port_name(path, leaf)
        np.testing.assert_array_equal(state[name].numpy(), want)
    assert state["block_0.qkv.kernel"].shape == (16, 3, 4, 4)  # DenseGeneral, own shape
    assert state["block_1.out.kernel"].shape == (4, 4, 16)
    assert state["positions.embedding"].shape == (512, 16)
    bn = model_state["batch_stats"]["mlp"]["BatchNorm_0"]
    np.testing.assert_array_equal(state["mlp.BatchNorm_0.mean"].numpy(), bn["mean"])
    np.testing.assert_array_equal(state["mlp.BatchNorm_0.var"].numpy(), bn["var"])
    # the port's leaf order is JAX's flatten order (it keys stochastic rounding)
    model = _port_bst(params, model_state)
    assert [n for n, _ in jax_leaf_order(model)] == [_port_name(p, x)[0] for p, x in leaves]
    assert {n for n, _ in model.named_buffers()} == {"mlp.BatchNorm_0.mean", "mlp.BatchNorm_0.var"}


def test_load_needs_batch_stats_for_the_batchnorm_buffers():
    _, params, _, _ = _jax_bst()
    with pytest.raises(RuntimeError, match="BatchNorm_0.mean"):
        load_flax_params(BST(**SMALL), params)


# ------------------------------------------------------- transformer block
def _block_case(flash: bool):
    rng = np.random.default_rng(4)
    B, L, D = 3, 13, 16
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    valid = (rng.random((B, L)) < 0.7).astype(np.float32)
    valid[0] = 0.0  # an empty history: only the target position is valid
    valid[:, -1] = 1.0
    cot = rng.normal(size=(B, L, D)).astype(np.float32)
    if flash:
        cot *= valid[..., None]
    jb = JaxTransformerBlock(dim=D, num_heads=4, use_flash=flash or None)
    variables = JaxTransformerBlock(dim=D, num_heads=4).init(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(valid)
    )
    return jb, variables, x, valid, cot


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_transformer_block_matches_jax(pallas_interpret, flash):
    jb, variables, x, valid, cot = _block_case(flash)

    def f(params, x_):
        y = jb.apply({"params": params}, x_, jnp.asarray(valid))
        return jnp.sum(y * cot), y

    (_, want), (want_gp, want_gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x)
    )
    tb = TransformerBlock(16, num_heads=4, use_flash=flash or None)
    load_flax_params(tb, _np_tree(variables["params"]))
    xt = torch.tensor(x, requires_grad=True)
    y = tb(xt, torch.tensor(valid))
    (y * torch.tensor(cot)).sum().backward()
    rows = valid > 0 if flash else np.ones_like(valid, bool)
    np.testing.assert_allclose(y.detach().numpy()[rows], np.asarray(want)[rows], rtol=0, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=0, atol=1e-4)
    grads = dict(tb.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_gp)[0]:
        name, want = _port_name(path, leaf)
        np.testing.assert_allclose(grads[name].grad.numpy(), want, rtol=0, atol=1e-4, err_msg=name)


# -------------------------------------------------------------------- BST
def _jax_loss_and_grads(model, params, model_state, batch):
    def loss(p):
        prob, _ = model.apply({"params": p, **model_state}, batch, train=True,
                              mutable=["batch_stats"])
        return jnp.mean(jax_bce(prob, batch["label"])), prob

    (value, prob), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return float(value), np.asarray(prob), grads


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash_ref"])
def test_bst_forward_and_param_grads_match_jax(flash):
    """Train mode (batch-statistics BatchNorm); the JAX side runs its plain
    attention, whose valid rows — all that BST reads — the flash path
    reproduces."""
    jm, params, model_state, batch = _jax_bst()
    want_loss, want_prob, want_grads = _jax_loss_and_grads(jm, params, model_state, batch)
    model = _port_bst(params, model_state)
    _set_flash(model, flash)
    model.train()
    prob = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss = binary_cross_entropy(prob, torch.from_numpy(batch["label"])).mean()
    loss.backward()
    np.testing.assert_allclose(prob.detach().numpy(), want_prob, rtol=0, atol=1e-3)
    assert abs(loss.item() - want_loss) < 1e-3
    grads = dict(model.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        name, want = _port_name(path, leaf)
        tol = 5e-2 if name.startswith("mlp.Dense_") and name.endswith(".bias") else 2e-2
        err = np.abs(grads[name].grad.numpy() - want).max()
        assert err <= tol * np.abs(want).max() + 1e-6, (name, err)


def test_bst_eval_mode_uses_running_stats():
    jm, params, model_state, batch = _jax_bst()
    stats = {"mlp": {"BatchNorm_0": {
        "mean": np.linspace(-0.5, 0.5, 32).astype(np.float32),
        "var": np.linspace(0.5, 3.0, 32).astype(np.float32),
    }}}
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, batch))
    model = load_flax_params(BST(**SMALL), params, stats)
    model.eval()
    got = model({k: torch.from_numpy(v) for k, v in batch.items()}).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_history_longer_than_the_position_table_raises():
    model = BST(**SMALL, max_len=T)  # T + 1 positions needed
    with pytest.raises(ValueError):
        model({k: torch.from_numpy(v) for k, v in _batch(4, 2).items()})


@pytest.mark.parametrize(
    "kw,error",
    [(dict(lookup_mode="ring"), ValueError), (dict(partition="data"), ValueError),
     (dict(partition="model", mesh=Mesh(1, 3)), ValueError), (dict(mesh=object()), TypeError)],
    ids=["kw0", "kw1", "kw2", "kw3"],
)
def test_unported_options_raise(kw, error):
    """The sharded-table options are ported (``tests/test_torch_sharded.py``);
    what JAX has no counterpart of is refused: an unknown exchange or axis,
    a vocabulary the model axis does not divide, a mesh that is not one."""
    with pytest.raises(error):
        BST(**SMALL, **kw)


def test_init_model_redraws_params_with_flax_distributions():
    """flax inits: positions and DenseGeneral kernels truncated-normal with
    variance 1/fan_in, biases 0, LayerNorm and BatchNorm scale 1, running
    stats reset (the RNG streams differ, so the statistics are compared)."""
    model = BST(item_vocab=5000, cat_vocab=40, max_len=2048)
    model.mlp.BatchNorm_0.mean.fill_(3.0)
    init_model(model, seed=1)
    pos = model.positions.embedding.detach().numpy()
    assert abs(pos.std() * np.sqrt(36) - 1.0) < 0.02 and abs(pos).max() <= 2 / np.sqrt(36) / 0.8796 + 1e-6
    qkv = model.block_0.qkv.kernel.detach().numpy()
    assert abs(qkv.std() * np.sqrt(36) - 1.0) < 0.05
    out = model.block_1.out.kernel.detach().numpy()
    assert abs(out.std() * np.sqrt(36) - 1.0) < 0.05
    assert not model.block_0.qkv.bias.detach().numpy().any()
    assert (model.block_0.LayerNorm_0.weight.detach().numpy() == 1).all()
    assert not model.mlp.BatchNorm_0.mean.numpy().any()
    assert (model.mlp.BatchNorm_0.var.numpy() == 1).all()


# ------------------------------------------------------------------ Trainer
STEPS, LR = 8, 1e-3


@functools.lru_cache(maxsize=None)
def _data():
    train = _batch(STEPS * BATCH, 5)
    test = _batch(4 * BATCH, 6, empty_row=False)
    return train, test


@functools.lru_cache(maxsize=None)
def _run_jax():
    train, test = _data()
    model = JaxBST(**SMALL)
    params, model_state = jax_init_model(model, {k: v[:8] for k, v in train.items()})
    init = (_np_tree(params), _np_tree(model_state))  # the JAX step donates its state
    loss_fn, eval_fn = jax_make_ctr_task(model)
    trainer = JaxTrainer(
        loss_fn, JaxTrainConfig(learning_rate=LR, log_every=1, eval_every=0), eval_fn=eval_fn
    )
    state = trainer.init_state(lambda: (params, model_state))
    losses = []
    state, _ = trainer.fit(state, jax_batch_iterator(train, BATCH, seed=0), STEPS,
                           log_fn=lambda m: losses.append(m["loss"]))
    stats = _np_tree(state.model_state["batch_stats"]["mlp"]["BatchNorm_0"])
    ev = trainer.evaluate(state, jax_batch_iterator(test, BATCH, shuffle=False), exact=True)
    return init, losses, stats, ev


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash_ref"])
def test_trainer_tracks_jax_trainer(flash):
    (params, model_state), jax_losses, jax_stats, jax_ev = _run_jax()
    train, test = _data()
    model = _port_bst(params, model_state)
    _set_flash(model, flash)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(
        loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0), eval_fn, device="cpu"
    )
    state = trainer.init_state(lambda: model)
    losses = []
    state, _ = trainer.fit(state, batch_iterator(train, BATCH, seed=0), STEPS,
                           log_fn=lambda m: losses.append(m["loss"]))
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=2e-3)
    bn = model.mlp.BatchNorm_0
    for name in ("mean", "var"):
        want = jax_stats[name]
        got = getattr(bn, name).numpy()
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), name
    ev = trainer.evaluate(state, batch_iterator(test, BATCH, shuffle=False), exact=True)
    assert ev["eval_batches"] == jax_ev["eval_batches"] == 4
    assert abs(ev["eval_auc_exact"] - jax_ev["eval_auc_exact"]) < 5e-3
    assert abs(ev["eval_loss"] - jax_ev["eval_loss"]) < 1e-3
