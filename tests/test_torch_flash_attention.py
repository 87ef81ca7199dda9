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

The ``cuda``-marked tests hold the CUDA kernels (the forward and the
backward, each on both of its routes) against ``flash_mha_ref`` on the
card and skip without one. jax is imported inside the tests that use it, so they
also run where jax is not installed:

    python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest

Tolerances (f32 on both sides, sums in another order):
* against JAX, forward 2e-6 and q/k/v gradients 1e-5 abs (inputs ~N(0, 1));
* kernels against the plain version on the card, as a share of the
  largest magnitude of the plain result: forward 1e-5, gradients 1e-4
  (the kernel's exp2 differs from torch's exp by a few ulp, the kernels
  sum L terms in another order, and their products are 3xTF32:
  ``test_3xtf32_products_meet_the_tolerance_where_tf32_does_not``).
"""
import numpy as np
import pytest
import torch

from recommender_tpu_torch.ops import _build
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


@pytest.mark.parametrize("B,L,H,Dh", [(2, 11, 4, 9), (3, 130, 2, 9), (2, 11, 2, 72),
                                     (1, 130, 1, 128), (2, 11, 1, 130), (2, 11, 1, 192),
                                     (1, 11, 2, 256), (2, 101, 1, 128)])
def test_ref_matches_jax_flash_interpret(pallas_interpret, B, L, H, Dh):
    """L not a multiple of 128 (11, 101, and 130 which spans two
    128-blocks), Dh 9 and the wide 72, 128, 130, 192 and 256 (which JAX pads
    to 256 lanes; 256 is the widest one column group takes), with an
    all-pad-history row: forward on valid rows, q/k/v gradients on every
    row. (2, 101, 1, 128) is BST's L with one head of Dh 128, a shape the
    wide fused backward takes."""
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
        ((2, 5, 2, 0), torch.float32, (2, 5)),  # no head dim
        ((2, 5, 2, 8), torch.float32, (2, 4)),  # valid of the wrong shape
        ((2, 5, 2, 8), torch.bfloat16, (2, 5)),  # not f32
        ((2, 0, 2, 8), torch.float32, (2, 0)),  # empty sequence
        ((2, 5, 0, 8), torch.float32, (2, 5)),  # no head
        ((0, 5, 2, 8), torch.float32, (0, 5)),  # empty batch
        ((2, 5, 16), torch.float32, (2, 5)),  # not [B, L, H, Dh]
    ],
)
def test_flash_mha_rejects_what_the_kernel_does_not_take(shape, dtype, valid_shape):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_mha(q, q, q, torch.ones(valid_shape))


@pytest.mark.parametrize("Dh", [65, 128, 130, 300])
def test_flash_mha_takes_any_head_dim(Dh):
    """No head dim is refused: Dh past the 64 that the kernels keep in
    registers runs too (the CUDA kernels in chunks of 64 columns; here the
    plain version), and the gradients flow."""
    q, k, v, valid, cot = _inputs(2, 7, 2, Dh, seed=Dh)
    o, *grads = _port_grads(q, k, v, valid, cot)
    want = fa.flash_mha_ref(*(torch.tensor(x) for x in (q, k, v, valid))).numpy()
    np.testing.assert_array_equal(o, want)
    assert o.shape == (2, 7, 2, Dh) and all(np.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("case", ["k_shape", "valid_device", "device_type"])
def test_flash_mha_rejects_mismatched_arguments(case):
    q = torch.zeros((2, 5, 2, 8))
    k, valid = q, torch.ones((2, 5))
    if case == "k_shape":
        k = torch.zeros((2, 6, 2, 8))
    elif case == "valid_device":
        valid = valid.to("meta")
    else:  # neither CPU nor CUDA
        q, k, valid = q.to("meta"), q.to("meta"), valid.to("meta")
    with pytest.raises(ValueError):
        fa.flash_mha(q, k, q, valid)


_COUNTERS = ("fwd", "fwd_fused", "fwd_long", "bwd", "bwd_dkv", "bwd_dq")


def _counts():
    return {n: getattr(fa.flash_mha, f"launches_{n}") for n in _COUNTERS}


def _launched(fwd_route, bwd_route, times=1):
    """The launches one forward and backward make on these routes."""
    fused = bwd_route == "fused"
    return {"fwd": times, "fwd_fused": times * (fwd_route == "fused"),
            "fwd_long": times * (fwd_route == "long"), "bwd": times * fused,
            "bwd_dkv": times * (not fused), "bwd_dq": times * (not fused)}


def test_cpu_path_launches_nothing():
    q, k, v, valid, cot = _inputs(2, 9, 2, 4, seed=3)
    before = _counts()
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.flash_mha(*ts, torch.tensor(valid))
    (out * torch.tensor(cot)).sum().backward()
    torch.testing.assert_close(out, fa.flash_mha_ref(*(torch.tensor(x) for x in (q, k, v, valid))))
    assert _counts() == before


@pytest.mark.parametrize(
    "L,H,Dh,route",
    [
        (1, 1, 1, "fused"),
        (101, 4, 9, "fused"),  # BST
        (128, 4, 9, "fused"),  # the longest fused sequence
        (129, 4, 9, "long"),
        (1001, 4, 9, "long"),  # the TPU flash probe
        (1001, 4, 64, "long"),
        (128, 1, 64, "fused"),  # 202,496 bytes of shared memory
        (101, 4, 64, "long"),  # 4 heads of Dh 64 do not fit one block
        (128, 2, 40, "long"),
        # above Dh 64 a block holds one head: fused at every L <= 128
        *[(L, H, Dh, "fused" if L <= 128 else "long")
          for Dh in (65, 72, 128, 256, 300) for L in (1, 101, 128, 129) for H in (1, 2)],
    ],
)
def test_bwd_route_is_a_function_of_the_shape(L, H, Dh, route):
    assert fa.bwd_route(L, H, Dh) == route


@pytest.mark.parametrize(
    "L,H,Dh,route",
    [
        (1, 1, 1, "fused"),
        (101, 4, 9, "fused"),  # BST
        (128, 4, 9, "fused"),
        (129, 4, 9, "long"),
        (1001, 4, 9, "long"),  # the TPU flash probe
        (1001, 4, 64, "long"),
        (128, 2, 64, "fused"),  # 198,336 bytes of shared memory
        (128, 3, 64, "long"),
        (101, 4, 64, "long"),  # 4 heads of Dh 64 do not fit one block
        (128, 2, 40, "fused"),  # long for the backward: the forward's block is smaller
        # above Dh 64, fused only at Dh <= 128 with H * Dh % 32 != 0, where
        # its block fits; 129 is past the fused block
        *[(L, H, Dh, "fused" if Dh in (65, 72) and L <= 128 else "long")
          for Dh in (65, 72, 128, 256, 300) for L in (1, 101, 128, 129) for H in (1, 2)],
    ],
)
def test_fwd_route_is_a_function_of_the_shape(L, H, Dh, route):
    assert fa.fwd_route(L, H, Dh) == route


def test_fwd_smem_bytes_at_bst_and_at_the_limit():
    """BST's forward block: 3 spans of 104 x 4 x 9 floats (L rounded up to
    8 rows, 3,744, +16 zeros), lse 4 x 101, seg 104: four such blocks fit
    one SM's 228 KB. Over MAX_BLOCK_SMEM the route turns long; every shape
    the fused backward takes, the fused forward takes too."""
    assert fa.fwd_smem_bytes(101, 4, 9) == 4 * (3 * 3760 + 404 + 104) == 47_152
    dims = [(128, h, dh) for h in range(1, 17) for dh in range(1, 65)]
    for L, H, Dh in dims:
        fits = fa.fwd_smem_bytes(L, H, Dh) <= fa.MAX_BLOCK_SMEM
        assert fa.fwd_route(L, H, Dh) == ("fused" if fits else "long")
        assert fa.bwd_route(L, H, Dh) == "long" or fits
    assert {fa.fwd_route(*d) for d in dims} == {"fused", "long"}


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source and of every
    ``csrc/*.cuh``: an edit to a header, or a new header, builds anew."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    (tmp_path / "g.cuh").write_text("// new\n")
    third = _build.library_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")


def test_library_path_names_a_variant_by_its_defines(tmp_path, monkeypatch):
    """A build with ``-D`` defines is a library of its own; the same
    defines name the same library."""
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    shipped = _build.library_path("k")
    variant = _build.library_path("k", ("-DMIN_BLOCKS=1",))
    assert variant != shipped
    assert _build.library_path("k", ("-DMIN_BLOCKS=1",)) == variant
    assert _build.library_path("k", ("-DMIN_BLOCKS=2",)) not in (shipped, variant)


def test_fused_smem_bytes_at_bst_and_at_the_limit():
    """BST's block: 4 spans of 101 x 4 x 9 floats (3,636, +16 zeros), dS^T
    101 x 120, lse and di 4 x 101 each, seg 101; two such blocks fit one
    SM's 228 KB. Over MAX_BLOCK_SMEM the route turns long."""
    assert fa.fused_smem_bytes(101, 4, 9) == 4 * (4 * 3652 + 101 * 120 + 2 * 404 + 101) == 110_548
    dims = [(128, h, dh) for h in range(1, 9) for dh in range(1, 65)]
    for L, H, Dh in dims:
        fits = fa.fused_smem_bytes(L, H, Dh) <= fa.MAX_BLOCK_SMEM
        assert fa.bwd_route(L, H, Dh) == ("fused" if fits else "long")
    assert {fa.bwd_route(*d) for d in dims} == {"fused", "long"}


def test_fwd_wide_route_rule():
    """Above Dh 64 the forward is fused only at Dh <= 128 where H * Dh is not
    a multiple of 32 and the block fits: BST's L 101 with one head of Dh 72
    or 112 and two of Dh 65 or 72 fused; of Dh 96, 128, 144 or 160, or two
    heads of 96 at L 64, long (the times of ``k2_routes`` on the card). At
    Dh <= 64 only the block's size decides."""
    for H, Dh in ((1, 65), (1, 72), (1, 80), (1, 100), (1, 112), (2, 65), (2, 72)):
        assert fa.fwd_route(101, H, Dh) == "fused"
    for L, H, Dh in ((101, 1, 96), (101, 1, 128), (101, 1, 144), (101, 1, 160), (64, 1, 128),
                     (33, 1, 128), (64, 2, 96), (101, 2, 128), (101, 1, 192)):
        assert fa.fwd_route(L, H, Dh) == "long"
    for L in (1, 16, 64, 101, 128):
        for H in (1, 2, 3):
            for Dh in range(65, 300):
                fits = fa.fwd_smem_bytes(L, H, Dh) <= fa.MAX_BLOCK_SMEM
                fused = fits and Dh <= 128 and H * Dh % 32 != 0
                assert fa.fwd_route(L, H, Dh) == ("fused" if fused else "long")
    assert fa.fwd_route(128, 2, 64) == "fused"  # H * Dh % 32 == 0 is no reason below Dh 65
    assert fa.fwd_route(101, 3, 72) == "long"  # 271,388 bytes: no fused block


@pytest.mark.parametrize("L,slots,nbytes", [(1, 6, 26_048), (101, 6, 225_344), (112, 6, 225_344),
                                            (113, 4, 200_192), (128, 4, 200_192)])
def test_wide_fused_bwd_smem_bytes_do_not_grow_with_head_dim(L, slots, nbytes):
    """Above Dh 64 a fused-backward block holds one (batch row, head): a ring
    of [round16(L), 64] chunk slots (6, or 4 where 6 do not fit), P^T then
    dS^T [round16(L), round16(L) + 4], and lse, di and seg [round16(L)]. Its
    shared memory follows L alone: the same at BST's rows with Dh 72 and
    128 and at every Dh to 600 and H to 4, within MAX_BLOCK_SMEM. Below Dh
    65 the count is the per-batch-row one, which grows with Dh."""
    lp = -(-L // 16) * 16
    assert fa.wide_fused_bwd_slots(L) == slots
    assert nbytes == 4 * (slots * lp * 64 + lp * (lp + 4) + 3 * lp) <= fa.MAX_BLOCK_SMEM
    assert fa.fused_smem_bytes(L, 1, 72) == fa.fused_smem_bytes(L, 1, 128) == nbytes
    assert {fa.fused_smem_bytes(L, H, Dh) for H in (1, 2, 4) for Dh in range(65, 600, 13)} == {nbytes}
    assert fa.fused_smem_bytes(L, 1, 64) < fa.fused_smem_bytes(L, 4, 64)
    if slots < fa.WIDE_FUSED_BWD_MAX_SLOTS:  # one slot more would not fit
        assert nbytes + 4 * lp * 64 > fa.MAX_BLOCK_SMEM


def _simulate_wide_fused_bwd_ring(Dh, L):
    """Runs ``flash_bwd_fused_wide_kernel``'s schedule of copies and steps
    (``csrc/flash_attention_bwd.cu``, "wide fused route") for one block and
    checks it: copy i takes ring slot i % R (R = ``wide_fused_bwd_slots``)
    only once every step that reads the slot's last copy has passed a
    barrier; each step finds its two copies issued and waited for (the count
    of pending groups it asks cp.async to leave is >= 0), in slots no later
    copy has taken, holding the tensor and chunk it needs: per chunk d, pass
    S (Q_d, K_d); then pass P (dO_d, V_d); then pass B (Q_c, K_c). Returns
    the copies each step leaves in flight."""
    R, nd = fa.wide_fused_bwd_slots(L), -(-Dh // 64)
    passes = (("q", "k"), ("do", "v"), ("q", "k"))
    plan = [[(t, d) for t in names] for names in passes for d in range(nd)]
    copies = [c for need in plan for c in need]  # (tensor, chunk) of copy i, in order
    total = len(copies)

    def what(i):  # the kernel's issue(): its index arithmetic
        p = i // (2 * nd)
        return passes[p][i & 1], (i >> 1) - p * nd

    assert total == 6 * nd and [what(i) for i in range(total)] == copies
    slot, state = {}, dict(issued=0)

    def issue(upto, last):
        while state["issued"] <= upto and state["issued"] < total:
            i = state["issued"]
            assert slot.get(i % R, -1) <= last, (Dh, L, i)  # its last reader is done
            slot[i % R] = i
            state["issued"] += 1

    last, in_flight = -1, []
    issue(R - 1, last)
    for need in plan:
        pending = state["issued"] - 1 - (last + 2)
        assert pending >= 0, (Dh, L, last)  # the step's last copy was issued
        issue(last + R, last)  # at the barrier: every earlier step is done
        for i, want in zip(range(last + 1, last + 3), need):
            assert slot[i % R] == i and copies[i] == want, (Dh, L, i)
        last += 2
        in_flight.append(state["issued"] - 1 - last)
    assert last == total - 1 and state["issued"] == total
    return in_flight


@pytest.mark.parametrize("L", [1, 16, 64, 101, 112, 113, 128])
def test_wide_fused_bwd_ring_schedule(L):
    """The wide fused backward's ring over Dh 65-599: 2 to 10 chunks, 6 slots
    (4 at L 113-128). A block takes 3 steps a chunk (S; dP and dV; dK and
    dQ), each of two copies, and each leaves R - 2 in flight until the list
    runs out."""
    R = fa.wide_fused_bwd_slots(L)
    assert R >= 4
    for Dh in range(65, 600):
        nd = -(-Dh // 64)
        in_flight = _simulate_wide_fused_bwd_ring(Dh, L)
        assert in_flight == [min(R - 2, 6 * nd - 2 * j - 2) for j in range(3 * nd)], (Dh, L)


@pytest.mark.parametrize("Dh,groups", [(64, 0), (65, 1), (128, 1), (129, 1), (256, 1),
                                       (257, 2), (320, 2), (512, 2), (520, 3)])
def test_wide_bwd_groups_at_each_boundary(Dh, groups):
    """The long backward's blocks above Dh 64 own 2 chunks of 64 columns up
    to Dh 128, else 4 (256 columns): one group, so S and dP are computed once
    per (block, tile), up to Dh 256; 2 at 257-512; 3 at 520."""
    assert fa.wide_bwd_groups(Dh) == groups


@pytest.mark.parametrize("Dh,groups", [(64, 0), (65, 1), (128, 1), (129, 1), (256, 1),
                                       (257, 2), (512, 2), (520, 3)])
def test_wide_fwd_groups_at_each_boundary(Dh, groups):
    """The forward's warps above Dh 64 keep O on 2 chunks of 64 columns up
    to Dh 128, else on 4 (256 columns): one group, so S is computed once per
    block of keys, up to Dh 256; 2 at 257-512; 3 at 520."""
    assert fa.wide_fwd_groups(Dh) == groups


def _wide_fwd_ring(Dh, group):
    """The wide long forward's ring as ``flash_fwd_wide_long_kernel`` sets
    it up (``csrc/flash_attention.cu``, "wide long route"): the chunks nd,
    the group's chunks NC, its first chunk and how many it has, whether Q
    streams (nd > NC), the block's slots (``wide_fwd_slots``: 6 at NC 2, 7
    at NC 4), the ring's R, the copies an S step takes (Q's where it
    streams, then K's), a tile's S copies kd and all its copies."""
    nd = -(-Dh // 64)
    nc = 2 if nd <= 2 else 4
    g0 = group * nc
    q_stream = nd > nc
    slots = 6 if nc == 2 else 7
    take = 2 if q_stream else 1
    ngc = min(nc, nd - g0)
    return dict(nd=nd, nc=nc, g0=g0, ngc=ngc, q_stream=q_stream, slots=slots,
                ring=slots - (0 if q_stream else nd), take=take, kd=take * nd,
                per_tile=take * nd + ngc)


def _simulate_wide_fwd_ring(Dh, L, group):
    """Runs the kernel's schedule of copies and steps for one block and
    checks it: every step finds its copies landed (the wait count it asks
    cp.async for), in ring slots that no later copy has taken yet, holding
    the tensor and chunk the step needs; a copy takes a slot, and a tile's
    seg a seg buffer, only once every step that reads it has passed a
    barrier; R - take copies stay in flight under each step. Returns the
    number of steps."""
    r = _wide_fwd_ring(Dh, group)
    R, kd, per_tile = r["ring"], r["kd"], r["per_tile"]
    nt = -(-L // 64)
    total = nt * per_tile

    def what(i):  # (tile, tensor, chunk) of copy i
        t, k = divmod(i, per_tile)
        if k >= kd:
            return t, "v", r["g0"] + k - kd
        d, j = divmod(k, r["take"])
        return t, "q" if j < r["take"] - 1 else "k", d

    slot, seg_buf = {}, {}
    masked = set()  # tiles whose seg every warp has read (their first step passed)
    state = dict(issued=0)

    def issue(upto, last):
        while state["issued"] <= upto and state["issued"] < total:
            i = state["issued"]
            prev = slot.get(i % R)
            assert prev is None or prev <= last, (Dh, L, i, prev)
            slot[i % R] = i
            t, k = divmod(i, per_tile)
            if k == 0:
                assert seg_buf.get(t % 2) is None or seg_buf[t % 2] in masked, (Dh, L, t)
                seg_buf[t % 2] = t
            state["issued"] += 1

    last, steps = -1, 0
    issue(R - 1, last)
    for t in range(nt):
        plan = [(r["take"], [("q", d)] * (r["take"] - 1) + [("k", d)]) for d in range(r["nd"])]
        plan += [(1, [("v", r["g0"] + c)]) for c in range(r["ngc"])]
        for j, (take, need) in enumerate(plan):
            pending = state["issued"] - 1 - (last + take)
            assert pending >= 0, (Dh, L, t, j)  # the step's last copy was issued
            # the barrier: every earlier step is done
            if j == 1:
                masked.add(t)
            issue(last + R, last)
            assert state["issued"] - 1 - (last + take) == min(R - take, total - 1 - last - take)
            for i, (tensor, chunk) in zip(range(last + 1, last + take + 1), need):
                assert slot[i % R] == i and what(i) == (t, tensor, chunk), (Dh, L, t, j, i)
            if j == 0:
                assert seg_buf[t % 2] == t
            last += take
            steps += 1
        masked.add(t)
    assert last == total - 1 and state["issued"] == total
    return steps


@pytest.mark.parametrize("L", [1, 64, 101, 1001])
def test_wide_fwd_ring_schedule(L):
    """The wide long forward's ring over Dh 65-599 and every column group:
    resident Q (Dh <= 256, 2 to 4 chunks beside a ring of 3 or 4) and
    streamed Q (a ring of 7, two copies a step), 1 to 16 key tiles. A tile
    takes nd + ngc steps, and a block's slots fit two blocks an SM (228 KB,
    1 KB of it reserved for each block)."""
    for Dh in range(65, 600):
        for group in range(fa.wide_fwd_groups(Dh)):
            r = _wide_fwd_ring(Dh, group)
            assert r["ring"] >= 3 and (r["q_stream"] or r["ring"] + r["nd"] == r["slots"])
            steps = _simulate_wide_fwd_ring(Dh, L, group)
            assert steps == -(-L // 64) * (r["nd"] + r["ngc"])
            assert 2 * (4 * (r["slots"] * 64 * 64 + 2 * 64) + 1024) <= 233_472


@pytest.mark.parametrize("kernel,nbytes", [("dkv", 231_040), ("dq", 230_016)])
def test_wide_bwd_smem_bytes_fit_one_block(kernel, nbytes):
    """6 ring slots of two 16 KB chunk tiles, phase A's P and D (16 KB
    each), two tiles' row vectors (lse, di and seg, or seg) and 32 liveness
    flags: within the 227 KB a block may use, at every Dh."""
    tile = 64 * 64 * 4
    vectors = 3 if kernel == "dkv" else 1
    assert fa.wide_bwd_smem_bytes(kernel) == 12 * tile + 2 * tile + 2 * vectors * 256 + 128
    assert fa.wide_bwd_smem_bytes(kernel) == nbytes <= fa.MAX_BLOCK_SMEM


def _tf32_hi(x):
    """The kernel's split of f32 x: hi = x rounded to TF32's 10 mantissa bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_read(x):
    """What a TF32 tensor core reads of an f32 operand: its top 19 bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, b):
    return _tf32_hi(a).astype(np.float64) @ _tf32_hi(b).astype(np.float64)


def _mm_3xtf32(a, b):
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = (_tf32_read(x.astype(np.float32) - h) for x, h in ((a, ah), (b, bh)))
    ah, bh, al, bl = (x.astype(np.float64) for x in (ah, bh, al, bl))
    return ah @ bh + (ah @ bl + al @ bh)


def _mm_f32(a, b):
    return (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_3xtf32_products_meet_the_tolerance_where_tf32_does_not(kernel):
    """The kernels' products emulated in numpy at BST's L 101, H 4, Dh 9 (8
    batch rows): the forward's two (S, and P V with P in f32) and the
    backward's five (S, dP, dV, dK, dQ). With operands rounded to TF32 the
    results miss their tolerance; with the kernels' 3xTF32 split they meet
    it with a wide margin. This is why the kernels spend three tensor-core
    products on each f32 product.

    The forward's margin is 10x, not the backward's 100x: its tolerance is
    10x tighter, and 3xTF32 there is as close as f32 products are
    (2-3e-7 of max|o|, the rounding of the f32 sums and of P itself)."""
    rng = np.random.default_rng(0)
    B, L, H, Dh = 8, 101, 4, 9
    q, k, v, do = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(4))
    valid = np.arange(L)[None] < rng.integers(0, L, size=B)[:, None]
    valid[:, -1] = True
    same = valid[:, None, :, None] == valid[:, None, None, :]
    scale = 1 / np.sqrt(Dh)
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731

    def probs(mm):
        s = np.where(same, mm(q, t(k)) * scale, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        return p / p.sum(-1, keepdims=True)

    def fwd(mm):
        return (mm(probs(mm).astype(np.float32), v),)

    def bwd(mm):
        p = probs(mm)
        di = (do * (p @ v.astype(np.float64))).sum(-1, keepdims=True)
        ds = p * (mm(do, t(v)) - di)
        return mm(ds, k) * scale, mm(t(ds), q) * scale, mm(t(p), do)

    outputs = fwd if kernel == "fwd" else bwd
    want = outputs(lambda a, b: a.astype(np.float64) @ b.astype(np.float64))

    def worst(mm):
        return max(np.abs(g - w).max() / max(1.0, np.abs(w).max())
                   for g, w in zip(outputs(mm), want))

    tol, margin = (FWD_REL_TOL, 10) if kernel == "fwd" else (BWD_REL_TOL, 100)
    assert worst(_mm_3xtf32) < tol / margin
    assert worst(_mm_3xtf32) < 2 * worst(_mm_f32)
    assert worst(_mm_tf32) > tol


# ------------------------------------------------------------------ on the card
def _rel_err(got, want):
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


# (B, L, H, Dh) run on each backward route that takes the shape
_KERNEL_SHAPES = [
    (3, 1, 2, 9),  # a single position
    (16, 101, 4, 9),  # BST's shape at a small batch
    (4, 64, 4, 9),  # exactly one tile
    (4, 65, 4, 9),  # one row into the second tile
    (2, 130, 3, 16),
    (2, 77, 2, 5),
    (2, 70, 2, 24),
    (2, 90, 2, 33),
    (2, 129, 2, 48),
    (2, 200, 2, 64),
    (2, 100, 3, 3),
    (2, 96, 2, 20),
    (2, 111, 2, 28),
    # one head: the fused span's last B reads reach DP - Dh floats past it
    (2, 128, 1, 37),
    (2, 120, 1, 50),
    (2, 128, 1, 64),
    # wide head dims, in chunks of 64 columns: one chunk and a sliver (72,
    # 65, 130), whole chunks (128, 256), a width that no 16-byte copy takes
    # (67, 100 + 2), chunks past the long tile's columns (520)
    (2, 101, 1, 72),
    (3, 101, 1, 128),  # BST with item_dim = cat_dim = 64 and one head
    (2, 64, 1, 128),
    (2, 200, 2, 65),
    (2, 130, 1, 130),
    (2, 101, 2, 256),
    (2, 90, 1, 67),
    (2, 150, 1, 102),
    (2, 16, 1, 200),
    (2, 33, 1, 520),
    # the long backward's column groups (wide_bwd_groups): the last Dh of one
    # group of 4 chunks (256, above), the first of two (257: a 1-column
    # group), two whole groups of 4 + 1 chunks (320); 16 streamed tiles
    # through the ring at H 2 (1001)
    (2, 101, 1, 257),
    (2, 70, 1, 320),
    (2, 1001, 2, 128),
    # the wide fused backward (one block per batch row and head, any Dh at L
    # <= 128): one chunk and a sliver (65, 72, 129), whole chunks (128, 192,
    # 256), past one column group (257, 300); L 1 to 128, H 1 to 3
    (3, 1, 2, 65),
    (2, 16, 3, 72),
    (4, 101, 1, 72),
    (2, 127, 2, 128),
    (2, 128, 1, 129),
    (2, 101, 3, 192),
    (2, 16, 1, 256),
    (2, 128, 2, 257),
    (2, 127, 1, 300),
    (2, 1, 1, 300),
    (2, 101, 2, 300),
]


def _routes(fused_takes):
    """The routes a shape can be forced onto: the long routes take any."""
    return ("fused", "long") if fused_takes else ("long",)


def _fwd_fused_takes(L, H, Dh):
    """Whether the fused forward kernel takes the shape (``fwd_route`` picks
    it at fewer shapes above Dh 64)."""
    return L <= fa.FUSED_MAX_L and fa.fwd_smem_bytes(L, H, Dh) <= fa.MAX_BLOCK_SMEM


def _kernel_cases():
    """(B, L, H, Dh, forward route, backward route, valid): the shapes
    above; L 1, 64, 101, 127, 128, 129, 200 with Dh cycling through 5, 9,
    16, 33, 48, 64 and H as large as the fused backward block holds; each on
    both routes of the forward and of the backward where the fused one takes
    it. Then BST's shape on every pair of routes with every position valid,
    and with only the target position valid. Together they run every
    head-dim instantiation of both kernel files, the wide chunked ones
    included."""
    dhs = [5, 9, 16, 33, 48, 64]
    shapes = list(_KERNEL_SHAPES)
    for i, L in enumerate((1, 64, 101, 127, 128, 129, 200)):
        Dh = dhs[i % len(dhs)]
        H = max(h for h in (1, 2, 3, 4) if h == 1 or fa.bwd_route(min(L, 128), h, Dh) == "fused")
        shapes.append((3, L, H, Dh))
    cases = []
    for B, L, H, Dh in shapes:
        for fwd in _routes(_fwd_fused_takes(L, H, Dh)):
            for bwd in _routes(fa.bwd_route(L, H, Dh) == "fused"):
                cases.append((B, L, H, Dh, fwd, bwd, "ragged"))
    for fwd in ("fused", "long"):
        for bwd in ("fused", "long"):
            for valid in ("all", "target_only"):
                cases.append((8, 101, 4, 9, fwd, bwd, valid))
    for valid in ("all", "target_only"):  # the wide long backward, every piece live or few
        cases.append((4, 101, 1, 128, "fused", "long", valid))
        cases.append((4, 200, 2, 128, "long", "long", valid))
    for valid in ("all", "target_only"):  # the wide fused backward: every tile listed, or few
        cases.append((4, 101, 1, 128, "long", "fused", valid))
        cases.append((4, 101, 1, 72, "fused", "fused", valid))
        cases.append((2, 128, 2, 257, "long", "fused", valid))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,Dh,fwd_route,bwd_route,valid_kind", _kernel_cases())
def test_kernels_match_ref(cuda_device, monkeypatch, B, L, H, Dh, fwd_route, bwd_route,
                           valid_kind):
    """The forward on ``fwd_route`` and the backward on ``bwd_route`` (each
    forced where the shape would take the other one) against the plain
    version."""
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=B * L + Dh)
    if valid_kind == "all":
        valid[:] = 1.0
    elif valid_kind == "target_only":
        valid[:, :-1] = 0.0
    monkeypatch.setattr(fa, "fwd_route", lambda *shape: fwd_route)
    monkeypatch.setattr(fa, "bwd_route", lambda *shape: bwd_route)
    cot = np.random.default_rng(0).normal(size=q.shape).astype(np.float32)
    before = _counts()
    got = _port_grads(q, k, v, valid, cot, device=cuda_device)
    launched = {n: c - before[n] for n, c in _counts().items()}
    assert launched == _launched(fwd_route, bwd_route)
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
@pytest.mark.parametrize("L,fwd_route,bwd_route",
                         [(101, "fused", "fused"), (101, "long", "fused"), (200, "long", "long")])
def test_kernels_are_bitwise_repeatable_and_counted(cuda_device, monkeypatch, L, fwd_route,
                                                    bwd_route):
    assert fa.bwd_route(L, 4, 9) == bwd_route
    if fa.fwd_route(L, 4, 9) != fwd_route:  # BST's shape on the long forward
        monkeypatch.setattr(fa, "fwd_route", lambda *shape: fwd_route)
    q, k, v, valid, _ = _inputs(8, L, 4, 9, seed=5)
    cot = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    n = _counts()
    first = _port_grads(q, k, v, valid, cot, device=cuda_device)
    second = _port_grads(q, k, v, valid, cot, device=cuda_device)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    want = _launched(fwd_route, bwd_route, times=2)
    assert _counts() == {c: n[c] + want[c] for c in _COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,Dh", [(2, 1001, 2, 128), (2, 101, 2, 256), (2, 101, 1, 257),
                                      (2, 70, 1, 320)])
def test_wide_backward_is_bitwise_repeatable_and_counted(cuda_device, monkeypatch, B, L, H, Dh):
    """The long backward above Dh 64 (one and two column groups, 16 streamed
    tiles) gives the same bits twice, with one dK/dV and one dQ launch each."""
    monkeypatch.setattr(fa, "bwd_route", lambda *shape: "long")
    fwd_route = fa.fwd_route(L, H, Dh)
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=Dh)
    cot = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    n = _counts()
    first = _port_grads(q, k, v, valid, cot, device=cuda_device)
    second = _port_grads(q, k, v, valid, cot, device=cuda_device)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    want = _launched(fwd_route, "long", times=2)
    assert _counts() == {c: n[c] + want[c] for c in _COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,Dh", [(4, 101, 1, 72), (2, 101, 1, 128), (2, 101, 2, 256),
                                      (2, 128, 1, 300), (3, 1, 2, 65)])
def test_wide_fused_backward_is_bitwise_repeatable_and_counted(cuda_device, B, L, H, Dh):
    """The wide fused backward, on the routes ``fwd_route`` and
    ``bwd_route`` pick (fused for the backward at every L <= 128), gives the
    same bits twice with one ``launches_bwd`` each and no long launch."""
    fwd_route = fa.fwd_route(L, H, Dh)
    assert fa.bwd_route(L, H, Dh) == "fused"
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=Dh + L)
    cot = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    n = _counts()
    first = _port_grads(q, k, v, valid, cot, device=cuda_device)
    second = _port_grads(q, k, v, valid, cot, device=cuda_device)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    want = _launched(fwd_route, "fused", times=2)
    assert _counts() == {c: n[c] + want[c] for c in _COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 101, 112, 113, 128])
def test_wide_fused_bwd_kernel_does_not_spill(cuda_device, L):
    """The wide fused backward keeps its sums (8 tiles of S^T or dP^T a
    warp) and 32 columns of its output chunks in registers: no local memory
    (no spills, no stack), at most 128 registers (up to 16 warps a block),
    one block an SM at BST's L and above."""
    import ctypes

    fn = _build.load("flash_attention_bwd").rtt_flash_attention_bwd_fused_wide_info
    fn.argtypes, fn.restype = [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    assert fn(L, 1, 128, ctypes.addressof(out)) == 0
    registers, local_bytes, blocks = out
    assert local_bytes == 0 and registers <= 128 and blocks >= 1
    assert blocks == 1 or L < 101  # from L 101 one block fills an SM's registers
    assert fn(L, 1, 64, ctypes.addressof(out)) != 0  # the narrow kernel's shapes are refused


def _wide_fwd_cases():
    """(route, B, L, H, Dh, valid) for the wide forward kernels alone: the
    long one at Dh 65-520 (one column group and the first of two, Q resident
    at 2-4 chunks and streamed above 256) at L 1, 101, 200 and 1001, H 1 and
    2; the fused one at Dh 72, 128, 200 and 520 at L 1, 16, 101 and 128 where
    its block fits; all-valid and target-only masks at a few of each."""
    cases = []
    Ls = (1, 101, 200, 1001)
    for i, Dh in enumerate((65, 127, 128, 129, 192, 255, 256, 257, 320, 520)):
        for L in (Ls[i % 2], Ls[2 + i % 2]):
            cases.append(("long", 2, L, 1 + i % 2, Dh, "ragged"))
    for Dh in (72, 128, 200, 520):
        for L in (1, 16, 101, 128):
            H = max(h for h in (1, 2) if h == 1 or _fwd_fused_takes(L, h, Dh))
            if _fwd_fused_takes(L, H, Dh):
                cases.append(("fused", 3, L, H, Dh, "ragged"))
    for valid in ("all", "target_only"):
        cases += [("long", 2, 1001, 2, 128, valid), ("long", 2, 101, 2, 256, valid),
                  ("long", 2, 200, 1, 520, valid), ("fused", 4, 101, 1, 128, valid),
                  ("fused", 2, 16, 1, 520, valid)]
    return cases


def _ref_lse(q, k, valid):
    """The row log-sum-exp [B, H, L] of the plain version's masked scores."""
    seg = valid.to(torch.int32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * fa._scale(q.shape[-1])
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.logsumexp(s.masked_fill(~same, float("-inf")), dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("route,B,L,H,Dh,valid_kind", _wide_fwd_cases())
def test_wide_forward_matches_ref(cuda_device, monkeypatch, route, B, L, H, Dh, valid_kind):
    """Each wide forward kernel, forced onto its route, against the plain
    version: o within FWD_REL_TOL of max|plain|, the lse it saves for the
    backward within 1e-5 of max(1, max|lse|); one launch, on that route."""
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=L + Dh)
    if valid_kind == "all":
        valid[:] = 1.0
    elif valid_kind == "target_only":
        valid[:, :-1] = 0.0
    monkeypatch.setattr(fa, "fwd_route", lambda *shape: route)
    qt, kt, vt, vd = (torch.tensor(x, device=cuda_device) for x in (q, k, v, valid))
    before = _counts()
    o, lse = fa._forward(qt, kt, vt, vd.to(torch.int32))
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _counts().items()}
    assert launched == {**_launched(route, "fused"), "bwd": 0}
    assert _rel_err(o, fa.flash_mha_ref(qt, kt, vt, vd)) <= FWD_REL_TOL
    assert _rel_err(lse, _ref_lse(qt, kt, vd)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route,B,L,H,Dh", [("long", 2, 1001, 2, 128), ("long", 2, 101, 2, 256),
                                            ("long", 2, 101, 1, 257), ("long", 2, 70, 1, 520),
                                            ("fused", 2, 101, 1, 128), ("fused", 2, 16, 1, 520)])
def test_wide_forward_is_bitwise_repeatable_and_counted(cuda_device, monkeypatch, route, B, L,
                                                        H, Dh):
    """The wide forward kernels (one and several column groups, resident and
    streamed Q, 16 key tiles) give the same bits twice through ``flash_mha``,
    with one launch on their route each."""
    monkeypatch.setattr(fa, "fwd_route", lambda *shape: route)
    q, k, v, valid, _ = _inputs(B, L, H, Dh, seed=Dh)
    ts = [torch.tensor(x, device=cuda_device) for x in (q, k, v, valid)]
    n = _counts()
    first = fa.flash_mha(*ts)
    second = fa.flash_mha(*ts)
    assert torch.equal(first, second)
    want = {c: n[c] for c in _COUNTERS}
    want["fwd"] += 2
    want[f"fwd_{route}"] += 2
    assert _counts() == want


@pytest.mark.cuda
def test_wide_fwd_groups_match_the_kernel(cuda_device):
    """The Python count of the wide forward's column groups is the one the
    kernels use (the long kernel's grid y)."""
    import ctypes

    fn = _build.load("flash_attention").rtt_flash_attention_fwd_wide_groups
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for Dh in (1, 64, 65, 72, 128, 129, 200, 256, 257, 320, 512, 513, 520, 1000):
        assert fn(Dh) == fa.wide_fwd_groups(Dh)


def _fwd_wide_info(fused, L, H, Dh):
    """(registers, local bytes, blocks an SM) of a wide forward kernel."""
    import ctypes

    fn = _build.load("flash_attention").rtt_flash_attention_fwd_wide_info
    fn.argtypes, fn.restype = [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    assert fn(int(fused), L, H, Dh, ctypes.addressof(out)) == 0
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("route,L,H,Dh,blocks", [("long", 1001, 4, 128, 2), ("long", 101, 2, 256, 2),
                                                 ("fused", 101, 1, 128, 1), ("fused", 64, 1, 256, 1)])
def test_wide_fwd_kernels_do_not_spill(cuda_device, route, L, H, Dh, blocks):
    """Each wide forward kernel (O on 2 and on 4 chunks a warp) keeps its
    accumulators in registers (no local memory: no spills, no stack), with
    the blocks an SM it is built for: two long blocks, one fused block (it
    holds the batch row)."""
    _, local_bytes, got_blocks = _fwd_wide_info(route == "fused", L, H, Dh)
    assert local_bytes == 0
    assert got_blocks == blocks


@pytest.mark.cuda
def test_wide_bwd_counts_match_the_kernel(cuda_device):
    """The Python counts of the wide long backward's column groups and
    shared memory are the ones the kernels launch with."""
    import ctypes

    lib = _build.load("flash_attention_bwd")
    groups, smem = lib.rtt_flash_attention_bwd_wide_groups, lib.rtt_flash_attention_bwd_wide_smem
    groups.argtypes, groups.restype = [ctypes.c_int], ctypes.c_int
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_longlong
    for Dh in (1, 64, 65, 72, 128, 129, 200, 256, 257, 320, 512, 513, 520, 1000):
        assert groups(Dh) == fa.wide_bwd_groups(Dh)
    assert smem(1) == fa.wide_bwd_smem_bytes("dkv")
    assert smem(0) == fa.wide_bwd_smem_bytes("dq")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("Dh", [128, 256])
def test_wide_bwd_kernels_do_not_spill(cuda_device, kernel, Dh):
    """Each wide long-route kernel (2 and 4 chunks a group) keeps its
    accumulators in registers (no local memory: no spills, no stack) and
    gets one block an SM."""
    import ctypes

    fn = _build.load("flash_attention_bwd").rtt_flash_attention_bwd_long_info
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    assert fn(int(kernel == "dkv"), Dh, ctypes.addressof(out)) == 0
    _, local_bytes, blocks = out
    assert local_bytes == 0 and blocks == 1


@pytest.mark.cuda
def test_fused_smem_bytes_matches_the_kernel(cuda_device):
    """The routing's count of the fused block's shared memory is the one the
    kernel allocates (and refuses to exceed)."""
    import ctypes

    fn = _build.load("flash_attention_bwd").rtt_flash_attention_bwd_fused_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for L, H, Dh in [(1, 1, 1), (101, 4, 9), (128, 4, 9), (128, 1, 64), (77, 3, 33), (128, 8, 64),
                     (101, 1, 72), (101, 1, 128), (101, 2, 256), (112, 3, 65), (113, 1, 300),
                     (128, 4, 520), (1, 1, 65)]:
        assert fn(L, H, Dh) == fa.fused_smem_bytes(L, H, Dh)


@pytest.mark.cuda
def test_fwd_smem_bytes_matches_the_kernel(cuda_device):
    """The same for the fused forward's block."""
    import ctypes

    fn = _build.load("flash_attention").rtt_flash_attention_fwd_fused_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for L, H, Dh in [(1, 1, 1), (101, 4, 9), (128, 4, 9), (128, 2, 64), (77, 3, 33), (128, 8, 64)]:
        assert fn(L, H, Dh) == fa.fwd_smem_bytes(L, H, Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape", [("fused", (2, 129, 2, 9)), ("long", (2, 0, 2, 8))])
def test_forward_refuses_what_its_route_does_not_take(cuda_device, monkeypatch, route, shape):
    """The forward's C entry refuses a shape its route does not take (L past
    the fused block; no position, which ``flash_mha`` checks first), and the
    wrapper raises: nothing falls back."""
    monkeypatch.setattr(fa, "fwd_route", lambda *s: route)
    q = torch.zeros(shape, device=cuda_device)
    seg = torch.ones(shape[:2], dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match=f"{route} forward"):
        fa._forward(q, q, q, seg)
