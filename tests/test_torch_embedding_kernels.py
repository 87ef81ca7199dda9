"""The sorted scatter-add (K1) and the kernel-backed embedding lookup.

On the CPU the wrapper runs its plain version, which is held here against
the JAX package's Pallas kernel run in interpret mode (the monkeypatch of
``tests/test_ops.py``) and against ``jax.grad`` of the JAX lookup. The cases
include the skews the kernel's two passes must survive: a quarter of the
ids equal (BST's pad id 0), a single id, runs of C - 1, C and C + 1 around
the kernel's chunk of C positions, and ids below 0 and at or above V. The
CUDA kernel itself is held against the plain version by the ``cuda``-marked
tests (every case above, and a sweep of widths, dtypes and ``order``),
which skip without a card (``python3 chip_smoke.py`` does the same check on
the card at the DLRM and BST shapes). jax is imported inside the tests that
use it, so that the ``cuda`` tests also run where jax is not installed:

    python -m pytest tests/test_torch_embedding_kernels.py -m cuda --noconftest

Tolerance: both sides accumulate in f32 in different orders, so each
output row may differ by f32 roundoff of its sum: |Δ| ≤ 1e-5 · Σ|upd| over
the row's contributions (plus a 1e-6 floor for rows of tiny sums).
"""
import numpy as np
import pytest
import torch

from recommender_tpu_torch.ops import embedding_kernels as ek

PAD = 2**30


@pytest.fixture
def jax_ek():
    pytest.importorskip("jax")
    from recommender_tpu.ops import embedding_kernels

    return embedding_kernels


@pytest.fixture
def pallas_interpret(monkeypatch, jax_ek):
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


def _row_abs_sum(ids, upd, vocab):
    keep = (ids >= 0) & (ids < vocab)
    out = np.zeros((vocab, upd.shape[1]), np.float64)
    np.add.at(out, ids[keep], np.abs(upd[keep].astype(np.float64)))
    return out


def _assert_rows_close(got, want, abs_sum):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = 1e-5 * abs_sum + 1e-6
    assert (err <= bound).all(), float((err - bound).max())


def _case(kind, rng):
    """(sorted_ids, updates [N,D], vocab, order-or-None, kernel_dtype)."""
    if kind == "d16":
        V, D, N = 5000, 16, 3000
        ids = np.sort(rng.integers(0, V, N)).astype(np.int32)
        return ids, rng.normal(size=(N, D)).astype(np.float32), V, None, "f32"
    if kind == "d18_order":
        V, D, N = 4100, 18, 2500
        raw = rng.integers(0, V, N).astype(np.int32)
        order = np.argsort(raw, kind="stable").astype(np.int32)
        return raw[order], rng.normal(size=(N, D)).astype(np.float32), V, order, "f32"
    if kind == "bf16_kernel_dtype":
        V, D, N = 3000, 16, 2000
        raw = rng.zipf(1.2, N).astype(np.int64) % V
        order = np.argsort(raw, kind="stable").astype(np.int32)
        ids = raw.astype(np.int32)[order]
        return ids, rng.normal(size=(N, D)).astype(np.float32), V, order, "bf16"
    if kind == "pad_ids":
        V, D, N = 2000, 16, 1500
        ids = np.sort(rng.integers(0, V, N - 200)).astype(np.int32)
        ids = np.concatenate([ids, np.full(200, PAD, np.int32)])
        return ids, rng.normal(size=(N, D)).astype(np.float32), V, None, "f32"
    if kind == "empty_tiles":
        # ids only in the first and last 8192-row tile of the JAX kernel
        V, D, N = 3 * 8192 + 5, 16, 1200
        lo = rng.integers(0, 100, N // 2)
        hi = rng.integers(V - 100, V, N - N // 2)
        ids = np.sort(np.concatenate([lo, hi])).astype(np.int32)
        return ids, rng.normal(size=(N, D)).astype(np.float32), V, None, "f32"
    if kind == "pad_run_d18_order":
        # a BST-like history: a quarter of the positions are pad id 0
        V, D, N = 4000, 18, 2500
        raw = np.where(rng.random(N) < 0.25, 0, rng.integers(1, V, N)).astype(np.int32)
        order = np.argsort(raw, kind="stable").astype(np.int32)
        return raw[order], rng.normal(size=(N, D)).astype(np.float32), V, order, "f32"
    if kind == "one_id":
        V, D, N = 600, 16, 2100
        raw = np.full(N, 417, np.int32)
        order = np.argsort(raw, kind="stable").astype(np.int32)
        return raw[order], rng.normal(size=(N, D)).astype(np.float32), V, order, "f32"
    if kind == "runs_at_chunk_edges":
        # runs of C - 1, C and C + 1 positions around the kernel's chunk of C
        # (and of the 8 positions of a row slot); N is not a multiple of C
        V, D = 3000, 16
        C = ek._geometry(D, ek._load_width(D, 4, 0))[2]
        lens = [3, C - 1, C, C + 1, 7, 8, 9, C, 1, 2 * C + 1, 5]
        starts = np.sort(rng.choice(V, len(lens), replace=False))
        ids = np.repeat(starts, lens).astype(np.int32)
        assert ids.size % C
        return ids, rng.normal(size=(ids.size, D)).astype(np.float32), V, None, "f32"
    if kind == "negative_and_pad":
        V, D = 1500, 16
        raw = np.concatenate([
            rng.integers(-2**31, 0, 150), np.full(60, -1),
            rng.integers(0, V, 1400), np.full(70, V), rng.integers(V, 2**31 - 1, 50),
            np.full(120, PAD),
        ]).astype(np.int32)
        rng.shuffle(raw)
        order = np.argsort(raw, kind="stable").astype(np.int32)
        return raw[order], rng.normal(size=(raw.size, D)).astype(np.float32), V, order, "f32"
    raise ValueError(kind)


CASES = [
    "d16", "d18_order", "bf16_kernel_dtype", "pad_ids", "empty_tiles",
    "pad_run_d18_order", "one_id", "runs_at_chunk_edges", "negative_and_pad",
]


@pytest.mark.parametrize("kind", CASES)
def test_plain_scatter_matches_pallas_kernel(kind, pallas_interpret, jax_ek):
    import jax.numpy as jnp

    ids, upd, V, order, kd = _case(kind, np.random.default_rng(CASES.index(kind)))
    jdt = jnp.bfloat16 if kd == "bf16" else jnp.float32
    tdt = torch.bfloat16 if kd == "bf16" else torch.float32
    want = jax_ek.sorted_scatter_add(
        jnp.asarray(ids), jnp.asarray(upd), V,
        order=None if order is None else jnp.asarray(order), kernel_dtype=jdt,
    )
    launches = ek.sorted_scatter_add.launches
    got = ek.sorted_scatter_add(
        torch.from_numpy(ids), torch.from_numpy(upd), V,
        order=None if order is None else torch.from_numpy(order), kernel_dtype=tdt,
    )
    assert ek.sorted_scatter_add.launches == launches  # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == (V, upd.shape[1])
    ordered = upd if order is None else upd[order]
    if kd == "bf16":  # both round each contribution to bf16, then sum in f32
        ordered = torch.from_numpy(ordered).to(torch.bfloat16).float().numpy()
    _assert_rows_close(got.numpy(), np.asarray(want), _row_abs_sum(ids, ordered, V))


def test_plain_scatter_matches_numpy_with_bf16_updates():
    rng = np.random.default_rng(9)
    V, D, N = 700, 16, 900
    ids = np.sort(rng.integers(0, V, N)).astype(np.int32)
    upd = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(torch.bfloat16)
    got = ek.sorted_scatter_add(torch.from_numpy(ids), upd, V)
    want = np.zeros((V, D), np.float64)
    np.add.at(want, ids, upd.float().numpy().astype(np.float64))
    _assert_rows_close(got.numpy(), want, _row_abs_sum(ids, upd.float().numpy(), V))


def test_scatter_add_dense_matches_pallas(pallas_interpret, jax_ek):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    V, D = 3000, 8
    ids = rng.integers(0, V, (85, 20)).astype(np.int32)
    upd = rng.normal(size=(85, 20, D)).astype(np.float32)
    want = jax_ek.scatter_add_dense(jnp.asarray(ids), jnp.asarray(upd), V)
    got = ek.scatter_add_dense(torch.from_numpy(ids), torch.from_numpy(upd), V)
    flat = ids.reshape(-1)
    _assert_rows_close(got.numpy(), np.asarray(want), _row_abs_sum(flat, upd.reshape(-1, D), V))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_embedding_lookup_forward_and_grad_match_jax(table_dtype, jax_ek):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    V, D = 300, 16
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = (rng.zipf(1.3, (64, 26)) % V).astype(np.int32)
    w = rng.normal(size=(64, 26, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(table_dtype), getattr(torch, table_dtype)

    jt = jnp.asarray(table).astype(jdt)

    def loss(t):
        return jnp.sum(jax_ek.embedding_lookup(t, jnp.asarray(ids)).astype(jnp.float32) * w)

    want_out = np.asarray(jax_ek.embedding_lookup(jt, jnp.asarray(ids)).astype(jnp.float32))
    want_grad = np.asarray(jax.grad(loss)(jt).astype(jnp.float32))

    tt = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = ek.embedding_lookup(tt, torch.from_numpy(ids))
    assert out.dtype == tdt and out.shape == (64, 26, D)
    (out.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().float().numpy(), want_out)
    assert tt.grad.dtype == tdt
    if table_dtype == "float32":
        _assert_rows_close(
            tt.grad.numpy(), want_grad, _row_abs_sum(ids.reshape(-1), w.reshape(-1, D), V)
        )
    else:
        # JAX sums the bf16 cotangent in bf16 (padded XLA scatter); the port
        # sums it exactly in f32 and rounds once, so the two agree to a few
        # bf16 ulps of the row's abs-sum (PARITY.md).
        err = np.abs(tt.grad.float().numpy() - want_grad)
        abs_sum = _row_abs_sum(ids.reshape(-1), w.reshape(-1, D), V)
        assert (err <= 2.0**-5 * abs_sum + 1e-6).all()


@pytest.mark.parametrize(
    "bad",
    ["ids_int64", "ids_2d", "upd_f16", "n_mismatch", "order_int64", "kernel_dtype", "noncontig"],
)
def test_wrapper_rejects_bad_arguments(bad):
    ids = torch.arange(8, dtype=torch.int32)
    upd = torch.ones(8, 4)
    kw = {}
    if bad == "ids_int64":
        ids = ids.long()
    elif bad == "ids_2d":
        ids = ids.reshape(2, 4)
    elif bad == "upd_f16":
        upd = upd.half()
    elif bad == "n_mismatch":
        upd = torch.ones(7, 4)
    elif bad == "order_int64":
        kw["order"] = torch.arange(8)
    elif bad == "kernel_dtype":
        kw["kernel_dtype"] = torch.float16
    elif bad == "noncontig":
        upd = torch.ones(4, 8).t()
    with pytest.raises(ValueError):
        ek.sorted_scatter_add(ids, upd, 10, **kw)


def _check_on_card(ids, upd_t, vocab, order, kernel_dtype, device):
    args = dict(order=None if order is None else torch.from_numpy(order),
                kernel_dtype=kernel_dtype)
    want = ek.sorted_scatter_add_ref(torch.from_numpy(ids), upd_t, vocab, **args)
    dev_args = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in args.items()}
    launches = ek.sorted_scatter_add.launches
    got, again = (
        ek.sorted_scatter_add(torch.from_numpy(ids).to(device), upd_t.to(device), vocab,
                              **dev_args)
        for _ in range(2)
    )
    torch.cuda.synchronize()
    assert ek.sorted_scatter_add.launches == launches + 2
    assert torch.equal(got, again)  # deterministic: no atomics
    contrib = upd_t.to(kernel_dtype).float().numpy()
    ordered = contrib if order is None else contrib[order]
    _assert_rows_close(got.cpu().numpy(), want.numpy(), _row_abs_sum(ids, ordered, vocab))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CASES + ["bf16_updates"])
def test_cuda_kernel_matches_plain(kind, cuda_device):
    rng = np.random.default_rng(11)
    if kind == "bf16_updates":
        ids, upd, V, order, kd = _case("bf16_kernel_dtype", rng)
        upd_t = torch.from_numpy(upd).to(torch.bfloat16)
        kd = "f32"
    else:
        ids, upd, V, order, kd = _case(kind, rng)
        upd_t = torch.from_numpy(upd)
    tdt = torch.bfloat16 if kd == "bf16" else torch.float32
    _check_on_card(ids, upd_t, V, order, tdt, cuda_device)


@pytest.mark.parametrize(
    "d, element_size, address, vec",
    [
        (16, 4, 0, 4),  # 64-byte rows: 16-byte loads
        (18, 4, 0, 2),  # 72-byte rows: 8-byte loads
        (5, 4, 0, 1),
        (16, 4, 8, 2),  # rows only 8-byte aligned
        (16, 2, 0, 8),
        (18, 2, 0, 2),
        (6, 2, 0, 2),
        (5, 2, 0, 1),
    ],
)
def test_load_width_follows_row_bytes(d, element_size, address, vec):
    assert ek._load_width(d, element_size, address) == vec


@pytest.mark.parametrize("d, vec", [(1, 1), (16, 4), (16, 8), (18, 2), (130, 2), (256, 4)])
def test_chunk_geometry_fills_one_block(d, vec):
    slab, slots, chunk = ek._geometry(d, vec)
    assert 1 <= slab <= d // vec and slab * slots <= ek._THREADS
    assert slots * slab > ek._THREADS - slab  # no whole row slot left idle
    assert chunk == slots * ek._ROWS_PER_SLOT


SWEEP_DIMS = [1, 3, 5, 8, 16, 18, 32, 33, 64, 128, 130]
SWEEP_TYPES = ["f32", "bf16_updates", "f32_kernel_bf16"]


def _sweep_case(d, rng, n=3000, vocab=2500):
    """Zipf ids with one run long enough to cross several chunks at any
    width, some ids >= V; original order and its stable argsort."""
    raw = (rng.zipf(1.3, n) % vocab).astype(np.int32)
    raw[:1200] = 77
    raw[-40:] = vocab + 3
    rng.shuffle(raw)
    order = np.argsort(raw, kind="stable").astype(np.int32)
    return raw, order, rng.normal(size=(n, d)).astype(np.float32), vocab


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", [True, False], ids=["order", "sorted"])
@pytest.mark.parametrize("dtypes", SWEEP_TYPES)
@pytest.mark.parametrize("d", SWEEP_DIMS)
def test_cuda_kernel_width_sweep(d, dtypes, with_order, cuda_device):
    rng = np.random.default_rng(d)
    raw, order, upd, vocab = _sweep_case(d, rng)
    upd_t = torch.from_numpy(upd)
    if not with_order:
        upd_t = upd_t[torch.from_numpy(order).long()].contiguous()
    if dtypes == "bf16_updates":
        upd_t = upd_t.to(torch.bfloat16)
    kd = torch.bfloat16 if dtypes == "f32_kernel_bf16" else torch.float32
    _check_on_card(raw[order], upd_t, vocab, order if with_order else None, kd, cuda_device)


# the retrieval models' tables: (vocab, D, ids a b512 / b1024 step looks up)
RETRIEVAL_SHAPES = {
    "pinsage_year": (81, 8, 6144 + 18432),  # runs of ~300 equal ids
    "pinsage_id": (3706, 8, 18432),
    "twotower_user": (6000, 32, 1024),
    "twotower_item": (3700, 32, 1024),
}


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", [True, False], ids=["order", "sorted"])
@pytest.mark.parametrize("dtypes", ["f32", "bf16_updates"])
@pytest.mark.parametrize("shape", list(RETRIEVAL_SHAPES))
def test_cuda_kernel_retrieval_shapes(shape, dtypes, with_order, cuda_device):
    vocab, d, n = RETRIEVAL_SHAPES[shape]
    rng = np.random.default_rng(vocab)
    raw = rng.integers(0, vocab, n).astype(np.int32)
    raw[::97] = vocab + 5  # ids >= V, dropped
    order = np.argsort(raw, kind="stable").astype(np.int32)
    upd_t = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    if not with_order:
        upd_t = upd_t[torch.from_numpy(order).long()].contiguous()
    if dtypes == "bf16_updates":
        upd_t = upd_t.to(torch.bfloat16)
    _check_on_card(raw[order], upd_t, vocab, order if with_order else None, torch.float32,
                   cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["n1", "all_dropped"])
def test_cuda_kernel_edge_inputs(kind, cuda_device):
    rng = np.random.default_rng(3)
    if kind == "n1":
        ids = np.array([5], np.int32)
    else:
        ids = np.sort(rng.integers(10, 2**31 - 1, 700)).astype(np.int32)  # all >= V
    upd_t = torch.from_numpy(rng.normal(size=(ids.size, 16)).astype(np.float32))
    _check_on_card(ids, upd_t, 10, None, torch.float32, cuda_device)
