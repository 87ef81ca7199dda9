"""The CTR slice's host modules and the dedup'd lookup against the JAX
package.

* The copies of ``data/dedup.py`` (``build_plan``, native and numpy),
  ``data/pipeline.py`` (``Prefetcher``, ``prefetch_to_device``,
  ``interleave_ordered``, ``with_dedup_plans``) and ``data/criteo.py`` give
  the originals' outputs bit for bit on the same inputs.
* ``embedding_lookup_dedup`` (its backward: K1's plain version twice)
  against JAX's, whose K1 runs as its Pallas kernel in interpret mode: the
  forward bit for bit; the f32 table's gradient within 1e-5 of each row's
  abs-sum (the two sum a row's contributions in other orders; measured 79
  of 16,000 entries differ, by at most 1.9e-6); the bf16 table's gradient,
  where both round the unique rows' f32 sums to bf16 before the second
  scatter, within one bf16 ulp of the row's abs-sum (an f32 sum near a
  rounding boundary may round to the other neighbour; measured bit for
  bit). The port's plan-driven gradient equals its plain lookup's bit for
  bit: both sum each id's rows in the same (stable sorted) order, and the
  second scatter moves each unique row once.
* DLRM's loss and gradients with and without a plan are the same, bit for
  bit, with f32 and bf16 tables (``tests/test_dedup.py::
  test_dlrm_grads_match_with_plan`` checks JAX's to 1e-5).
"""
import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.data import criteo as jax_criteo
from recommender_tpu.data import dedup as jax_dedup
from recommender_tpu.data import pipeline as jax_pipeline
from recommender_tpu_torch.data import criteo, dedup, pipeline
from recommender_tpu_torch.data.synthetic import SyntheticCTR
from recommender_tpu_torch.models import DLRM, make_ctr_task
from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    embedding_lookup_dedup,
    sorted_scatter_add,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread runs them faster, and test workers
    do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zipf_ids(seed, shape, vocab):
    return (np.random.default_rng(seed).zipf(1.3, size=shape) % vocab).astype(np.int32)


def _assert_same(a, b):
    """Equal nested structure and arrays bit for bit (dtype included)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ------------------------------------------------------------- build_plan
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_build_plan_matches_the_original(monkeypatch, native):
    if native:
        assert dedup.is_available() and jax_dedup.is_available()
    else:
        monkeypatch.setattr(dedup, "_load", lambda: None)
        monkeypatch.setattr(jax_dedup, "_load", lambda: None)
    assert dedup.PAD_ID == jax_dedup.PAD_ID == 2**30 and dedup.PAD_ID.dtype == np.int32
    for ids, cap in ((_zipf_ids(0, (64, 26), 500), 512), (_zipf_ids(1, 4096, 10_000), 4096),
                     (np.arange(100, dtype=np.int32), 50)):
        ours, theirs = dedup.build_plan(ids, cap), jax_dedup.build_plan(ids, cap)
        if theirs is None:  # more uniques than the cap
            assert ours is None
            continue
        assert type(ours).__name__ == "DedupPlan"
        _assert_same([ours.perm, ours.slot_sorted, ours.uniq, ours.n_unique],
                     [theirs.perm, theirs.slot_sorted, theirs.uniq, theirs.n_unique])
        flat = ids.reshape(-1)
        u = ours.n_unique
        np.testing.assert_array_equal(flat[ours.perm], ours.uniq[:u][ours.slot_sorted])


# ------------------------------------------------------- with_dedup_plans
def _ctr_batches():
    """Zipf batches whose second one overflows the first one's cap (8,192)
    and makes the adaptive cap grow once."""
    gen = SyntheticCTR(vocab_size=50_000, seed=0)
    small = gen.sample(64, seed=1)
    wide = {**gen.sample(512, seed=2)}
    wide["cat_features"] = np.arange(512 * 26, dtype=np.int32).reshape(512, 26)
    return [small, wide, gen.sample(64, seed=3)]


@pytest.mark.parametrize("u_cap", [None, 2048], ids=["adaptive", "fixed_cap"])
def test_with_dedup_plans_matches_the_original(u_cap):
    batches = _ctr_batches()
    ours = list(pipeline.with_dedup_plans(iter(batches), u_cap=u_cap))
    theirs = list(jax_pipeline.with_dedup_plans(iter(batches), u_cap=u_cap))
    _assert_same(ours, theirs)
    caps = [b["cat_dedup"]["uniq"].size if "cat_dedup" in b else None for b in ours]
    if u_cap is None:
        assert caps == [8192, 24576, 24576]  # grown once, to 13,312 x 1.25 rounded up
    else:
        assert caps == [2048, None, 2048]  # the wide batch overflows: no plan


# ----------------------------------------------------- Prefetcher et al.
def test_prefetcher_matches_the_original():
    batches = [{"a": np.arange(i, i + 3)} for i in range(7)]
    _assert_same(list(pipeline.Prefetcher(iter(batches), size=2)),
                 list(jax_pipeline.Prefetcher(iter(batches), size=2)))
    assert list(pipeline.prefetch_to_device(batches, size=2)) == batches  # a list is one stream
    fanned = list(pipeline.prefetch_to_device(
        workers=[iter(range(5)), iter(range(10, 15))], size=2, put_fn=lambda x: 2 * x))
    assert sorted(fanned) == sorted(2 * x for x in [*range(5), *range(10, 15)])
    with pytest.raises(ValueError, match="not both"):
        pipeline.Prefetcher(iter([1]), workers=[iter([2])])


def test_prefetcher_propagates_errors_and_closes():
    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(pipeline.Prefetcher(bad(), size=2))
    before = threading.active_count()
    pf = pipeline.Prefetcher(itertools.count(), size=2)
    assert next(pf) == 0
    pf.close()  # unblocks the producer parked on a full queue
    for t in pf._threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in pf._threads)
    assert threading.active_count() <= before


def _workers(w_count, start=(0, 0, 0)):
    return [iter(range(100 * w + start[w], 100 * w + 20)) for w in range(w_count)]


def test_interleave_ordered_matches_the_original():
    W = 3
    ours = list(pipeline.interleave_ordered(_workers(W)))
    assert ours == list(jax_pipeline.interleave_ordered(_workers(W)))
    assert ours == [100 * (j % W) + j // W for j in range(20 * W)]  # strict rotation
    # resume at global index k: each worker fast-forwards by what it had
    # delivered, the rotation restarts at k % W (cli.train_ctr's arithmetic)
    for k in (1, 4, 7, 38):
        start = [(k - 1 - w) // W + 1 if k > w else 0 for w in range(W)]
        resumed = list(pipeline.interleave_ordered(_workers(W, start), start_worker=k % W))
        assert resumed == ours[k:] == list(
            jax_pipeline.interleave_ordered(_workers(W, start), start_worker=k % W)), k
    # a worker that runs dry drops out; the rest keep their order
    uneven = [[1, 2], [10, 20, 30, 40]]
    assert (list(pipeline.interleave_ordered([iter(x) for x in uneven]))
            == list(jax_pipeline.interleave_ordered([iter(x) for x in uneven]))
            == [1, 10, 2, 20, 30, 40])


def test_interleave_ordered_propagates_producer_errors():
    def bad():
        yield 1
        raise ValueError("boom")

    merged = pipeline.interleave_ordered([bad(), iter(range(100))])
    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(merged)


# ------------------------------------------------------------------ criteo
def _criteo_lines(n, seed):
    """Criteo TSV rows: label, 13 ints (some missing or negative), 26 cats
    (some missing) drawn from a skewed pool so that the count filter bites."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ints = ["" if rng.random() < 0.1 else str(int(rng.integers(-2, 500))) for _ in range(13)]
        cats = ["" if rng.random() < 0.1 else f"{int(rng.zipf(1.5)) % 40:08x}" for _ in range(26)]
        lines.append("\t".join([str(int(rng.random() < 0.3)), *ints, *cats]) + "\n")
    return lines


def test_criteo_vocab_and_encoding_match_the_original(tmp_path):
    lines = _criteo_lines(300, 0)
    assert criteo.NUM_INT == 13 and criteo.NUM_CAT == 26
    vocab = criteo.build_vocab(lines)
    assert vocab == jax_criteo.build_vocab(lines) and len(vocab) > 10
    assert criteo.build_vocab(lines, min_count=3) == jax_criteo.build_vocab(lines, min_count=3)
    _assert_same(criteo.encode_lines(lines, vocab), jax_criteo.encode_lines(lines, vocab))
    criteo.save_vocab(vocab, str(tmp_path / "vocab.pkl"))
    assert jax_criteo.load_vocab(str(tmp_path / "vocab.pkl")) == vocab
    assert criteo.load_vocab(str(tmp_path / "vocab.pkl")) == vocab
    tsv = tmp_path / "day.tsv"
    tsv.write_text("".join(lines))
    native = criteo.encode_file_native(str(tsv), vocab)
    assert native is not None
    _assert_same(native, jax_criteo.encode_file_native(str(tsv), vocab))


def test_criteo_shard_stream_matches_the_original(tmp_path):
    lines = _criteo_lines(700, 1)
    vocab = criteo.build_vocab(lines)
    paths = criteo.write_shards(lines, vocab, str(tmp_path / "ours"), shard_rows=150)
    theirs = jax_criteo.write_shards(lines, vocab, str(tmp_path / "theirs"), shard_rows=150)
    assert [p.split("/")[-1] for p in paths] == [p.split("/")[-1] for p in theirs]
    assert [criteo.shard_rows(p) for p in paths] == [150, 150, 150, 150, 100]
    _assert_same(criteo.load_shards(paths), jax_criteo.load_shards(theirs))
    full = list(itertools.islice(criteo.shard_batches(paths, 32, seed=3, epochs=None), 50))
    _assert_same(full, list(itertools.islice(
        jax_criteo.shard_batches(paths, 32, seed=3, epochs=None), 50)))
    # start_batch fast-forwards to the same stream, across shards and epochs
    for k in (1, 4, 5, 23, 41):
        resumed = list(itertools.islice(
            criteo.shard_batches(paths, 32, seed=3, epochs=None, start_batch=k), 50 - k))
        _assert_same(resumed, full[k:])


# --------------------------------------------------- embedding_lookup_dedup
@pytest.fixture
def interpret_pallas(monkeypatch):
    """JAX's K1 is a TPU Pallas kernel: run it in interpret mode, as
    ``tests/test_dedup.py`` does."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


V, D = 2000, 8


def _lookup_case(table_dtype):
    rng = np.random.default_rng(2)
    ids = _zipf_ids(3, (32, 26), V)
    ids[0, :4] = V - 1  # the table's last row
    plan = dedup.build_plan(ids, 1024)
    table = rng.normal(size=(V, D)).astype(np.float32)
    return ids, plan, table, jnp.dtype(table_dtype)


def _jax_lookup_grad(ids, plan, table, dtype):
    from recommender_tpu.ops.embedding_kernels import embedding_lookup_dedup as jax_dedup_lookup

    args = [jnp.asarray(a) for a in (ids, plan.perm, plan.slot_sorted, plan.uniq)]

    def loss(t):
        e = jax_dedup_lookup(t, *args).astype(jnp.float32)
        return jnp.sum(jnp.sin(e) * e)

    t = jnp.asarray(table).astype(dtype)
    out = jax_dedup_lookup(t, *args)
    return np.asarray(out.astype(jnp.float32)), np.asarray(jax.grad(loss)(t).astype(jnp.float32))


def _port_lookup_grad(ids, plan, table, dtype, use_plan=True):
    t = torch.from_numpy(table).to(getattr(torch, dtype.name)).requires_grad_()
    tids = torch.from_numpy(ids)
    if use_plan:
        args = [torch.from_numpy(a) for a in (plan.perm, plan.slot_sorted, plan.uniq)]
        e = embedding_lookup_dedup(t, tids, *args)
    else:
        e = embedding_lookup(t, tids)
    ef = e.float()
    torch.sum(torch.sin(ef) * ef).backward()
    return ef.detach().numpy(), t.grad.float().numpy(), t.grad.dtype


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_lookup_dedup_matches_jax(interpret_pallas, table_dtype):
    ids, plan, table, dtype = _lookup_case(table_dtype)
    want_out, want_grad = _jax_lookup_grad(ids, plan, table, dtype)
    out, grad, grad_dtype = _port_lookup_grad(ids, plan, table, dtype)
    assert grad_dtype == getattr(torch, table_dtype)
    np.testing.assert_array_equal(out, want_out)
    # each row's abs-sum of the cotangent contributions
    cot = np.abs(np.cos(out) * out + np.sin(out)).reshape(-1, D)
    if table_dtype == "bfloat16":
        cot = torch.from_numpy(cot).to(torch.bfloat16).float().numpy()
    abs_sum = np.zeros((V, D), np.float32)
    np.add.at(abs_sum, ids.reshape(-1), cot)
    tol = 1e-5 if table_dtype == "float32" else 2.0**-8
    err = np.abs(grad - want_grad)
    assert (err <= tol * abs_sum + 1e-6).all(), float(err.max())
    assert (grad[abs_sum == 0] == 0).all()
    # the port's two lookups: the same gradient bit for bit
    _, plain, _ = _port_lookup_grad(ids, plan, table, dtype, use_plan=False)
    np.testing.assert_array_equal(grad, plain)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_lookup_dedup_backward_is_two_k1_calls(monkeypatch, table_dtype):
    """The segment sum (ids = slots, ``order`` = perm, into U_cap rows),
    then the unique rows rounded to the cotangent's dtype into the table."""
    ids, plan, table, dtype = _lookup_case(table_dtype)
    calls = []

    def spy(sorted_ids, updates, vocab_size, order=None, **kw):
        calls.append((sorted_ids.shape[0], updates.dtype, vocab_size, order is not None))
        return sorted_scatter_add(sorted_ids, updates, vocab_size, order=order, **kw)

    from recommender_tpu_torch.ops import embedding_kernels

    monkeypatch.setattr(embedding_kernels, "sorted_scatter_add", spy)
    _port_lookup_grad(ids, plan, table, dtype)
    cot_dtype = getattr(torch, table_dtype)
    assert calls == [(ids.size, cot_dtype, 1024, True), (1024, cot_dtype, V, False)]


def test_lookup_dedup_rejects_a_plan_of_other_ids():
    ids, plan, table, _ = _lookup_case("float32")
    args = [torch.from_numpy(a) for a in (plan.perm[:-1], plan.slot_sorted[:-1], plan.uniq)]
    with pytest.raises(ValueError, match="dedup plan"):
        embedding_lookup_dedup(torch.from_numpy(table), torch.from_numpy(ids), *args)


# ------------------------------------------------------------------- DLRM
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dlrm_loss_and_grads_match_with_plan(table_dtype):
    rng = np.random.default_rng(4)
    batch = {
        "int_features": rng.normal(size=(64, 13)).astype(np.float32),
        "cat_features": _zipf_ids(5, (64, 26), V),
        "label": (rng.random(64) < 0.5).astype(np.float32),
    }
    (planned,) = list(pipeline.with_dedup_plans(iter([batch])))
    runs = []
    for b in (batch, planned):
        model = DLRM(V, 8, bottom_units=(16, 8), top_units=(16, 1),
                     embed_param_dtype=table_dtype, generator=torch.Generator().manual_seed(0))
        loss_fn, _ = make_ctr_task(model)
        tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in b.items()}
        per_ex, _ = loss_fn(tb, True)
        per_ex.mean().backward()
        runs.append((per_ex.detach(), {n: p.grad.float() for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l1, l0)
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name
