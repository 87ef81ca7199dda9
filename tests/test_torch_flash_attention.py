"""Flash attention (K2): the plain version against the JAX package, the
CUDA kernels against the plain version.

On the CPU ``flash_mha`` runs ``flash_mha_ref``, which is held here against
JAX's ``_flash_mha`` (the Pallas TPU flash attention, run in interpret mode
through the ``pallas_call`` monkeypatch of ``tests/test_ops.py``) and
against the plain branch of the JAX ``TransformerBlock``. JAX's flash pads
L to a multiple of 128 with inert segment-0 positions that its pad queries
attend to, and the plain branch lets pad queries attend to the valid keys,
so pad query rows are defined differently on each side: forward outputs
are compared on valid rows, and gradients under a cotangent that is zero
on pad rows (as BST's masked readout gives), where all rows agree.

The ``cuda``-marked tests hold the three CUDA kernels against
``flash_mha_ref`` on the card and skip without one. jax is imported inside
the tests that use it, so they also run where jax is not installed:

    python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest

Tolerances (f32 on both sides, sums in another order):
* against JAX, forward 2e-6 and q/k/v gradients 1e-5 abs (inputs ~N(0, 1));
* kernels against the plain version on the card, as a share of the
  largest magnitude of the plain result: forward 1e-5, gradients 1e-4
  (the kernel's exp2 differs from torch's exp by a few ulp, and the
  backward sums L terms in another order).
"""
import numpy as np
import pytest
import torch

from recommender_tpu_torch.ops import flash_attention as fa

FWD_REL_TOL = 1e-5
BWD_REL_TOL = 1e-4


@pytest.fixture
def pallas_interpret(monkeypatch):
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")


def _inputs(B, L, H, Dh, seed):
    """q, k, v ~ N(0, 1) [B, L, H, Dh] f32; valid [B, L] f32 with ragged
    valid prefixes, row 0 pad everywhere but its last position (an empty
    history whose target attends only to itself), the last position of
    every row valid; a cotangent that is zero on pad rows."""
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(4))
    lengths = rng.integers(0, L, size=B)
    lengths[0] = 0
    valid = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    valid[:, -1] = 1.0
    cot *= valid[:, :, None, None]
    return q, k, v, valid, cot


def _port_grads(q, k, v, valid, cot, device="cpu"):
    """(o, dq, dk, dv) of ``flash_mha`` as numpy, on ``device``."""
    ts = [torch.tensor(x, device=device, requires_grad=True) for x in (q, k, v)]
    o = fa.flash_mha(*ts, torch.tensor(valid, device=device))
    (o * torch.tensor(cot, device=device)).sum().backward()
    return [t.detach().cpu().numpy() for t in (o, *(x.grad for x in ts))]


@pytest.mark.parametrize("B,L,H,Dh", [(2, 11, 4, 9), (3, 130, 2, 9)])
def test_ref_matches_jax_flash_interpret(pallas_interpret, B, L, H, Dh):
    """L not a multiple of 128 (11, and 130 which spans two 128-blocks),
    Dh 9, with an all-pad-history row: forward on valid rows, q/k/v
    gradients on every row."""
    import jax
    import jax.numpy as jnp

    from recommender_tpu.nn.transformer import _flash_mha

    q, k, v, valid, cot = _inputs(B, L, H, Dh, seed=L)

    def loss(q_, k_, v_):
        o = _flash_mha(q_, k_, v_, jnp.asarray(valid))
        return jnp.sum(o * cot), o

    (_, want_o), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    o, *grads = _port_grads(q, k, v, valid, cot)
    rows = valid > 0
    np.testing.assert_allclose(o[rows], np.asarray(want_o)[rows], rtol=0, atol=2e-6)
    for got, want in zip(grads, want_g):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,L,H,Dh", [(4, 17, 4, 9), (2, 101, 4, 9), (3, 33, 2, 16)])
def test_ref_matches_jax_plain_branch_on_valid_rows(B, L, H, Dh):
    """The plain branch of the JAX block (``transformer.py:91-93``) agrees
    with the segment-equality mask wherever the query is valid."""
    import jax
    import jax.numpy as jnp

    q, k, v, valid, cot = _inputs(B, L, H, Dh, seed=7 * L)

    def plain(q_, k_, v_):
        s = jnp.einsum("bqhd,bkhd->bhqk", q_, k_) / (Dh ** 0.5)
        s = jnp.where(jnp.asarray(valid)[:, None, None, :] > 0, s, -1e30)
        o = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v_)
        return jnp.sum(o * cot), o

    (_, want_o), want_g = jax.value_and_grad(plain, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    o, *grads = _port_grads(q, k, v, valid, cot)
    rows = valid > 0
    np.testing.assert_allclose(o[rows], np.asarray(want_o)[rows], rtol=0, atol=2e-6)
    for got, want in zip(grads, want_g):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_pad_queries_attend_to_pad_keys():
    """The segment-id semantics on pad rows: a pad query's output is the
    softmax-weighted mean of the pad positions' values only."""
    q, k, v, valid, _ = _inputs(2, 6, 1, 3, seed=1)
    valid[1] = [1, 1, 0, 0, 1, 1]
    o = fa.flash_mha_ref(*(torch.tensor(x) for x in (q, k, v, valid))).numpy()
    pads = [2, 3]
    s = np.einsum("qd,kd->qk", q[1, pads, 0], k[1, pads, 0]) / np.sqrt(3.0)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(o[1, pads, 0], p @ v[1, pads, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "shape,dtype,valid_shape",
    [
        ((2, 5, 2, 65), torch.float32, (2, 5)),  # Dh above the kernel's 64
        ((2, 5, 2, 8), torch.float32, (2, 4)),  # valid of the wrong shape
        ((2, 5, 2, 8), torch.bfloat16, (2, 5)),  # not f32
        ((2, 0, 2, 8), torch.float32, (2, 0)),  # empty sequence
    ],
)
def test_flash_mha_rejects_what_the_kernel_does_not_take(shape, dtype, valid_shape):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_mha(q, q, q, torch.ones(valid_shape))


def test_cpu_path_launches_nothing():
    q, k, v, valid, _ = _inputs(2, 9, 2, 4, seed=3)
    before = (fa.flash_mha.launches_fwd, fa.flash_mha.launches_bwd_dkv, fa.flash_mha.launches_bwd_dq)
    out = fa.flash_mha(*(torch.tensor(x) for x in (q, k, v, valid)))
    torch.testing.assert_close(out, fa.flash_mha_ref(*(torch.tensor(x) for x in (q, k, v, valid))))
    after = (fa.flash_mha.launches_fwd, fa.flash_mha.launches_bwd_dkv, fa.flash_mha.launches_bwd_dq)
    assert before == after


# ------------------------------------------------------------------ on the card
def _rel_err(got, want):
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,H,Dh",
    [
        (3, 1, 2, 9),  # a single position
        (16, 101, 4, 9),  # BST's shape at a small batch
        (4, 64, 4, 9),  # exactly one tile
        (4, 65, 4, 9),  # one row into the second tile
        (2, 130, 3, 16),
        (2, 77, 2, 5),
        (2, 70, 2, 24),
        (2, 90, 2, 33),  # two threads per row from here
        (2, 129, 2, 48),
        (2, 200, 2, 64),
    ],
)
def test_kernels_match_ref(cuda_device, B, L, H, Dh):
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=B * L + Dh)
    cot = np.random.default_rng(0).normal(size=q.shape).astype(np.float32)
    got = _port_grads(q, k, v, valid, cot, device=cuda_device)
    ts = [torch.tensor(x, device=cuda_device, requires_grad=True) for x in (q, k, v)]
    o = fa.flash_mha_ref(*ts, torch.tensor(valid, device=cuda_device))
    (o * torch.tensor(cot, device=cuda_device)).sum().backward()
    want = [o.detach(), *(t.grad for t in ts)]
    for name, g, w, tol in zip(
        ("o", "dq", "dk", "dv"), got, want, (FWD_REL_TOL,) + (BWD_REL_TOL,) * 3
    ):
        err = _rel_err(torch.tensor(g, device=cuda_device), w)
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_kernels_are_bitwise_repeatable_and_counted(cuda_device):
    q, k, v, valid, _ = _inputs(8, 101, 4, 9, seed=5)
    cot = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    n = (fa.flash_mha.launches_fwd, fa.flash_mha.launches_bwd_dkv, fa.flash_mha.launches_bwd_dq)
    first = _port_grads(q, k, v, valid, cot, device=cuda_device)
    second = _port_grads(q, k, v, valid, cot, device=cuda_device)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    assert fa.flash_mha.launches_fwd == n[0] + 2
    assert fa.flash_mha.launches_bwd_dkv == n[1] + 2
    assert fa.flash_mha.launches_bwd_dq == n[2] + 2
