"""The DIN/DIEN layers on the CPU against the JAX package from converted
weights: the masked auxiliary loss, ``AuxiliaryNet``, ``LocalActivationUnit``,
``DIENAttention``, ``GRU`` and ``AUGRU``.

Inputs come from numpy seeds; every mask holds an all-pad row, a full row
and a one-step row. All layers compute in f32 on both sides.

Tolerances: forward within 1e-5 abs; the gradient of every parameter and
of every input within 1e-4 of that gradient's largest magnitude (plus
1e-7). ``remat`` on and off: outputs equal bit for bit, gradients within
1e-6 of their largest magnitude (the chunks' contributions are summed in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.nn.losses import masked_auxiliary_loss as jax_masked_auxiliary_loss
from recommender_tpu.nn.recurrent import AUGRU as JaxAUGRU
from recommender_tpu.nn.recurrent import GRU as JaxGRU
from recommender_tpu.nn.recurrent import REMAT_MIN_T as JAX_REMAT_MIN_T
from recommender_tpu.nn.sequence import AuxiliaryNet as JaxAuxiliaryNet
from recommender_tpu.nn.sequence import DIENAttention as JaxDIENAttention
from recommender_tpu.nn.sequence import LocalActivationUnit as JaxLocalActivationUnit
from recommender_tpu_torch.convert import flax_to_state_dict, load_flax_params
from recommender_tpu_torch.nn import recurrent
from recommender_tpu_torch.nn.losses import masked_auxiliary_loss
from recommender_tpu_torch.nn.recurrent import AUGRU, GRU
from recommender_tpu_torch.nn.sequence import AuxiliaryNet, DIENAttention, LocalActivationUnit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B = 6


def _mask(rng, t):
    """[B, t] post-padded masks: row 0 all pad, row 1 full, row 2 one step."""
    lengths = rng.integers(1, t + 1, size=B)
    lengths[:3] = (0, t, 1)
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_grad(got, want, name):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())


def _check_layer(jax_module, port_module, inputs, diff_inputs, cot):
    """Run both layers on ``inputs`` (numpy), compare the outputs and the
    gradients of sum(out * cot) with respect to every parameter and to the
    inputs listed in ``diff_inputs``."""
    jin = [jnp.asarray(a) for a in inputs]
    variables = jax_module.init(jax.random.PRNGKey(0), *jin)

    def f(params, diff):
        args = list(jin)
        for i, d in zip(diff_inputs, diff):
            args[i] = d
        out = jax_module.apply({"params": params}, *args)
        return jnp.sum(out * cot), out

    (_, want), (want_gp, want_gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], [jin[i] for i in diff_inputs]
    )
    params = _np_tree(variables["params"])
    load_flax_params(port_module, params)
    tin = [torch.tensor(a) for a in inputs]
    for i in diff_inputs:
        tin[i].requires_grad_()
    out = port_module(*tin)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    grads = {n: p.grad.numpy() for n, p in port_module.named_parameters()}
    want_state = flax_to_state_dict(_np_tree(want_gp))
    assert set(grads) == set(want_state)
    for name, w in want_state.items():
        _close_grad(grads[name], w.numpy(), name)
    for i, w in zip(diff_inputs, want_gx):
        _close_grad(tin[i].grad.numpy(), w, f"input {i}")
    return params, out.detach().numpy()


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("t", [7, 33])
def test_masked_auxiliary_loss_matches_jax(t):
    rng = np.random.default_rng(t)
    pos, neg = (rng.normal(size=(B, t - 1)).astype(np.float32) * 3 for _ in range(2))
    mask = _mask(rng, t)[:, 1:]
    cot = rng.normal(size=(B,)).astype(np.float32)
    f = lambda p, n: jnp.sum(jax_masked_auxiliary_loss(p, n, jnp.asarray(mask)) * cot)  # noqa: E731
    want = jax_masked_auxiliary_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask))
    want_g = jax.grad(f, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(neg))
    tp, tn = torch.tensor(pos, requires_grad=True), torch.tensor(neg, requires_grad=True)
    got = masked_auxiliary_loss(tp, tn, torch.tensor(mask))
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    assert got[0].item() == 0.0  # the all-pad row: max(2 * 0, 1) under a zero sum
    _close_grad(tp.grad.numpy(), want_g[0], "pos_logits")
    _close_grad(tn.grad.numpy(), want_g[1], "neg_logits")


# ------------------------------------------------------- nn/sequence.py layers
@pytest.mark.parametrize("t", [7, 33])
def test_auxiliary_net_matches_jax(t):
    rng = np.random.default_rng(10 + t)
    x = rng.normal(size=(B, t, 20)).astype(np.float32)
    cot = rng.normal(size=(B, t)).astype(np.float32)
    _check_layer(JaxAuxiliaryNet(), AuxiliaryNet(20), [x], [0], cot)


@pytest.mark.parametrize("t", [7, 33])
def test_local_activation_unit_matches_jax(t):
    rng = np.random.default_rng(20 + t)
    d = 10
    target = rng.normal(size=(B, d)).astype(np.float32)
    history = rng.normal(size=(B, t, d)).astype(np.float32)
    mask = _mask(rng, t)
    cot = rng.normal(size=(B, d)).astype(np.float32)
    port = LocalActivationUnit(d)
    assert [n for n, _ in port.named_children()] == ["Dense_0", "Dense_1", "Dense_2"]
    assert port.Dense_2.out_features == 1
    _, out = _check_layer(JaxLocalActivationUnit(), port, [target, history, mask], [0, 1], cot)
    assert not out[0].any()  # an all-pad history pools to zeros: raw weights, zeroed


@pytest.mark.parametrize("t", [7, 33])
def test_dien_attention_matches_jax(t):
    rng = np.random.default_rng(30 + t)
    h, d_t = 12, 10  # hidden != target width
    target = rng.normal(size=(B, d_t)).astype(np.float32)
    hidden = rng.normal(size=(B, t, h)).astype(np.float32)
    mask = _mask(rng, t)
    cot = rng.normal(size=(B, t, 1)).astype(np.float32)
    port = DIENAttention(h, d_t)
    params, out = _check_layer(JaxDIENAttention(), port, [target, hidden, mask], [0, 1], cot)
    # the flax [H, D_t] kernel lands transposed in ``weight`` [D_t, H]
    assert params["kernel"].shape == (h, d_t) and port.weight.shape == (d_t, h)
    np.testing.assert_array_equal(port.weight.detach().numpy(), params["kernel"].T)
    np.testing.assert_allclose(out[0, :, 0], 1.0 / t, rtol=0, atol=1e-7)  # all pad: uniform
    np.testing.assert_allclose(out[2, :, 0], np.eye(t)[0], rtol=0, atol=1e-7)  # one step
    assert np.abs(out.sum(1) - 1).max() < 1e-6


# -------------------------------------------------------------- recurrences
@pytest.mark.parametrize("t", [7, 33])
@pytest.mark.parametrize("d,h", [(10, 10), (10, 14), (14, 6)], ids=["d=h", "d<h", "d>h"])
def test_gru_matches_jax(t, d, h):
    rng = np.random.default_rng(40 + t + d + h)
    x = rng.normal(size=(B, t, d)).astype(np.float32)
    mask = _mask(rng, t)
    cot = rng.normal(size=(B, t, h)).astype(np.float32)
    port = GRU(d, h)
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == {
        "w_gates": (h + d, 2 * h), "b_gates": (2 * h,), "w_cand": (h + d, h), "b_cand": (h,)}
    _, out = _check_layer(JaxGRU(hidden=h), port, [x, mask], [0], cot)
    assert out.shape == (B, t, h)
    assert not out[0].any()  # all pad: the zero state is carried through
    np.testing.assert_array_equal(out[2, 1:], np.broadcast_to(out[2, 0], (t - 1, h)))


@pytest.mark.parametrize("t", [7, 33])
@pytest.mark.parametrize("d,h", [(10, 10), (10, 14), (14, 6)], ids=["d=h", "d<h", "d>h"])
def test_augru_matches_jax(t, d, h):
    rng = np.random.default_rng(50 + t + d + h)
    x = rng.normal(size=(B, t, d)).astype(np.float32)
    mask = _mask(rng, t)
    att = rng.random(size=(B, t, 1)).astype(np.float32)
    cot = rng.normal(size=(B, h)).astype(np.float32)
    _, out = _check_layer(JaxAUGRU(hidden=h), AUGRU(d, h), [x, att, mask], [0, 1], cot)
    assert out.shape == (B, h) and not out[0].any()


def test_recurrence_biases_take_part():
    """The flax init zeroes the biases; with random ones the hoisted
    projections (``w_gates[h:]`` on x, ``w_cand[:d]`` on x) still agree."""
    rng = np.random.default_rng(60)
    t, d, h = 9, 5, 8
    x = rng.normal(size=(B, t, d)).astype(np.float32)
    mask = _mask(rng, t)
    params = {
        "w_gates": rng.normal(size=(h + d, 2 * h)).astype(np.float32) * 0.3,
        "b_gates": rng.normal(size=(2 * h,)).astype(np.float32),
        "w_cand": rng.normal(size=(h + d, h)).astype(np.float32) * 0.3,
        "b_cand": rng.normal(size=(h,)).astype(np.float32),
    }
    want = JaxGRU(hidden=h).apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    got = load_flax_params(GRU(d, h), params)(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    att = rng.random(size=(B, t, 1)).astype(np.float32)
    want = JaxAUGRU(hidden=h).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(att), jnp.asarray(mask))
    got = load_flax_params(AUGRU(d, h), params)(
        torch.tensor(x), torch.tensor(att), torch.tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("layer", ["gru", "augru"])
def test_remat_on_and_off_are_equal(layer, monkeypatch):
    """Chunked checkpointing (3 chunks of 3 + 1 of 1 step here) recomputes
    the same operations: outputs equal bit for bit, and gradients to f32
    roundoff (each chunk's share of a gradient is summed on its own first)."""
    monkeypatch.setattr(recurrent, "REMAT_CHUNK", 3)
    rng = np.random.default_rng(70)
    t, d, h = 10, 6, 7
    x = rng.normal(size=(B, t, d)).astype(np.float32)
    mask = torch.tensor(_mask(rng, t))
    att = torch.tensor(rng.random(size=(B, t, 1)).astype(np.float32))
    results = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(3)
        m = (GRU if layer == "gru" else AUGRU)(d, h, remat=remat, generator=g)
        xt = torch.tensor(x, requires_grad=True)
        out = m(xt, mask) if layer == "gru" else m(xt, att, mask)
        out.square().sum().backward()
        results.append([out.detach(), xt.grad, *(p.grad for p in m.parameters())])
    (out, *grads), (out_remat, *grads_remat) = results
    assert torch.equal(out, out_remat)
    for a, b in zip(grads, grads_remat):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


def test_remat_auto_follows_the_jax_threshold():
    assert recurrent.REMAT_MIN_T == JAX_REMAT_MIN_T == 256
    m = GRU(4, 4)
    assert m._chunks(256) == [slice(0, 256)]
    assert len(m._chunks(257)) == -(-257 // recurrent.REMAT_CHUNK)
    assert GRU(4, 4, remat=True)._chunks(40) == [slice(0, 32), slice(32, 40)]
    with torch.no_grad():  # nothing to rematerialize without a backward pass
        assert GRU(4, 4, remat=True)._chunks(40) == [slice(0, 40)]


@pytest.mark.parametrize("cls", [GRU, AUGRU])
def test_unroll_is_not_an_argument(cls):
    with pytest.raises(TypeError):
        cls(4, 4, unroll=8)


def test_init_draws_lecun_normal_from_the_generator():
    g = torch.Generator().manual_seed(1)
    m = GRU(300, 200, generator=g)
    w = m.w_gates.detach().numpy()
    assert abs(w.std() * np.sqrt(500) - 1.0) < 0.02
    assert np.abs(w).max() <= 2 / np.sqrt(500) / 0.8796 + 1e-6
    assert not m.b_gates.detach().numpy().any() and not m.b_cand.detach().numpy().any()
    again = GRU(300, 200, generator=torch.Generator().manual_seed(1))
    assert torch.equal(m.w_cand, again.w_cand)
    att = DIENAttention(400, 50, generator=g).weight.detach().numpy()
    assert abs(att.std() * np.sqrt(400) - 1.0) < 0.03
