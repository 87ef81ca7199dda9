"""Retrieval and serving in the port against the JAX package on the CPU:
``quantize_reprs`` and the int8 scores bit for bit; ``recommend_topk``,
``recommend_topk_from_queries`` and their int8 counterpart equal to JAX's
exact path (mask and id-list ``seen``, one block and many);
``_drop_excluded``; the Lloyd sweep and ``assign_clusters`` from JAX's
initial centroids; ``build_ivf``'s packing and ``search_ivf``'s ids from
one clustering; the k clamp that JAX's ``_search`` lacks; bundles written
by each package served by the other; ``full_corpus_reprs`` from a
converted PinSage init.

Data: Gaussian reprs, or clustered ones (``tests/test_ivf.py``'s), drawn
from a seed with numpy; the f32 scores of such data have no ties, so the
top-k ids must be equal, not just close. Tolerances: k-means centroids
within 1e-5 abs (f32 sums in another order); PinSage reprs within 1e-5 of
their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.retrieval import eval as jax_eval
from recommender_tpu.retrieval import export as jax_export
from recommender_tpu.retrieval import ivf as jax_ivf
from recommender_tpu.retrieval import quantize as jax_quantize
from recommender_tpu_torch.core.mesh import make_mesh
from recommender_tpu_torch.retrieval import eval as reval
from recommender_tpu_torch.retrieval import export, ivf, quantize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_blocks(monkeypatch):
    """Score blocks of a few hundred bytes, so that the blocked top-k takes
    many blocks and merges them."""
    monkeypatch.setattr(quantize, "SCORE_BLOCK_BYTES", 4 * 24 * 16)


def _clustered(V=2000, D=32, C=20, spread=0.3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, D)) * 3
    assign = rng.integers(0, C, V)
    return (centers[assign] + rng.normal(size=(V, D)) * spread).astype(np.float32)


def _seen(rng, U, V, S):
    dense = np.zeros((U, V), bool)
    lists = np.full((U, S), -1, np.int32)
    for u in range(U):
        ids = rng.choice(V, size=rng.integers(1, S), replace=False)
        dense[u, ids] = True
        lists[u, : len(ids)] = ids
    return dense, lists


# ------------------------------------------------------------ int8
def test_quantize_reprs_bit_for_bit():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(300, 24)).astype(np.float32) * rng.random((300, 1)).astype(np.float32)
    r[3] = 0.0
    r[7, 5] = -50.0
    for a, b in zip(quantize.quantize_reprs(r), jax_quantize.quantize_reprs(r)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("Q, V, D", [(1, 3706, 32), (5, 77, 12), (33, 200, 8), (17, 64, 128)])
def test_int8_scores_equal_jax_bit_for_bit(Q, V, D):
    """Queries padded to 17 rows, D and V to multiples of 8, and cut back
    (``int8_product``): the int32 sums are exact, so the scores are JAX's."""
    rng = np.random.default_rng(Q * V)
    qi, sc = quantize.quantize_reprs(rng.normal(size=(V, D)).astype(np.float32))
    qq = qi[rng.integers(0, V, Q)]
    got = quantize.scores_int8(torch.from_numpy(qq), torch.from_numpy(qi), torch.from_numpy(sc))
    want = np.asarray(jax_quantize._scores_int8(qq, qi, sc))
    assert got.shape == (Q, V) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blocks", ["one", "many"])
@pytest.mark.parametrize("form", ["mask", "ids"])
def test_recommend_topk_equals_jax(form, blocks, request):
    if blocks == "many":
        request.getfixturevalue("small_blocks")
    rng = np.random.default_rng(3)
    U, V, D, S = 40, 150, 16, 9
    reprs = rng.normal(size=(V, D)).astype(np.float32)
    latest = rng.integers(0, V, U)
    dense, lists = _seen(rng, U, V, S)
    seen = dense if form == "mask" else lists
    got = reval.recommend_topk(reprs, latest, seen, k=7, batch_size=17)
    want = jax_eval.recommend_topk(reprs, latest, seen, k=7, batch_size=17, exact=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    queries = rng.normal(size=(U, D)).astype(np.float32)
    np.testing.assert_array_equal(
        reval.recommend_topk_from_queries(queries, reprs, seen, k=7, batch_size=16),
        jax_eval.recommend_topk_from_queries(queries, reprs, seen, k=7, batch_size=16))
    q, sc = quantize.quantize_reprs(reprs)
    np.testing.assert_array_equal(
        quantize.recommend_topk_quantized(q, sc, latest, seen, k=7, batch_size=16),
        jax_quantize.recommend_topk_quantized(q, sc, latest, seen, k=7, batch_size=16,
                                              exact=True))


def test_topk_quantized_and_serve_topk_equal_jax(small_blocks):
    reprs = _clustered(V=600, D=16, C=12, spread=1.0, seed=2)
    q, sc = quantize.quantize_reprs(reprs)
    ids = np.arange(0, 600, 7)
    for mask_self in (True, False):
        np.testing.assert_array_equal(
            quantize.topk_quantized(q, sc, ids, k=10, mask_self=mask_self),
            jax_quantize.topk_quantized(q, sc, ids, k=10, mask_self=mask_self, exact=True))
    for bundle in ({"item_reprs": reprs}, {"item_reprs_int8": q, "item_scale": sc}):
        got = export.serve_topk(bundle, ids, k=10)
        np.testing.assert_array_equal(got, jax_export.serve_topk(bundle, ids, k=10, exact=True))
        on_device = export.device_bundle(bundle, "cpu")
        assert all(torch.is_tensor(v) for v in on_device.values())
        np.testing.assert_array_equal(export.serve_topk(on_device, ids, k=10), got)


def test_drop_excluded_equals_jax():
    idx = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
    got = quantize._drop_excluded(torch.from_numpy(idx), torch.tensor([[0], [9]]), 5)
    want = jax_quantize._drop_excluded(jnp.asarray(idx), jnp.asarray([[0], [9]]), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [2, 1, -1, -1, 0]
    # a 4-item corpus served at k 10 keeps width 10; -1 after the real ids
    rng = np.random.default_rng(30)
    b = {"item_reprs": rng.normal(size=(4, 8)).astype(np.float32)}
    recs = export.serve_topk(b, np.arange(4), k=10)
    np.testing.assert_array_equal(recs, jax_export.serve_topk(b, np.arange(4), k=10, exact=True))
    assert recs.shape == (4, 10) and (recs[:, 3:9] == -1).all()


def test_seen_format_and_hit_rate():
    rng = np.random.default_rng(7)
    U, V = 12, 60
    mask_int = (rng.random((U, V)) < 0.1).astype(np.int32)
    with pytest.raises(ValueError, match="ambiguous"):
        reval.resolve_seen_format(mask_int, V)
    assert reval.resolve_seen_format(mask_int.astype(bool), V) is False
    assert reval.resolve_seen_format(np.full((U, 5), -1, np.int32), V) is True
    assert reval.resolve_seen_format(mask_int, V, "mask") is False
    recs = rng.integers(0, V, (U, 5))
    gt = (rng.random((U, V)) < 0.2).astype(np.int8)
    assert reval.hit_rate(recs, gt) == jax_eval.hit_rate(recs, gt)
    # mesh= is data-parallel serving; a one-rank mesh serves as no mesh does
    reprs = rng.normal(size=(V, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        reval.recommend_topk(reprs, np.zeros(U, int), mask_int > 0, mesh=make_mesh()),
        reval.recommend_topk(reprs, np.zeros(U, int), mask_int > 0))


# ------------------------------------------------------------ IVF
def _jax_init_centroids(reprs, C, seed):
    pick = jax.random.choice(jax.random.PRNGKey(seed), reprs.shape[0], (C,), replace=False)
    return torch.from_numpy(reprs[np.asarray(pick)])


@pytest.mark.parametrize("chunk_rows", [64, None])
def test_lloyd_sweeps_and_assignment_equal_jax(chunk_rows):
    """From JAX's initial centroids, the port's sweeps give JAX's
    centroids, and the same assignment; an empty cluster takes the repair."""
    reprs = _clustered(V=1003, D=16, C=7, seed=11)
    cent_j, assign_j = jax_ivf.kmeans(reprs, num_clusters=7, iters=6, seed=1,
                                      chunk_rows=chunk_rows)
    r = torch.from_numpy(reprs)
    cent = _jax_init_centroids(reprs, 7, 1)
    chunk = chunk_rows or ivf._chunk_rows_for(1003, 7)
    for _ in range(6):
        cent = ivf.lloyd_sweep(cent, r, chunk)
    np.testing.assert_allclose(cent.numpy(), cent_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ivf.assign_clusters(cent_j, reprs, chunk_rows=chunk_rows),
                                  assign_j)
    # more clusters than distinct points: the empty-cluster repair
    pts = np.repeat(np.eye(3, 8, dtype=np.float32) * 5, 30, axis=0)
    cent_j, _ = jax_ivf.kmeans(pts, num_clusters=6, iters=3, seed=0)
    cent = _jax_init_centroids(pts, 6, 0)
    for _ in range(3):
        cent = ivf.lloyd_sweep(cent, torch.from_numpy(pts), 1024)
    np.testing.assert_allclose(cent.numpy(), cent_j, atol=1e-5, rtol=0)


def test_kmeans_draws_distinct_rows_and_converges():
    reprs = _clustered(V=800, D=16, C=8, spread=0.1, seed=4)
    cent, assign = ivf.kmeans(reprs, num_clusters=8, iters=8, seed=4)
    assert cent.shape == (8, 16) and assign.dtype == np.int32 and np.isfinite(cent).all()
    sim = reprs @ cent.T - 0.5 * (cent * cent).sum(1)[None, :]
    np.testing.assert_array_equal(assign, sim.argmax(1))
    init = ivf.init_centroids(torch.from_numpy(reprs), 8, seed=4)
    assert len({tuple(r) for r in init.numpy().tolist()}) == 8


def _jax_kmeans_in_port(monkeypatch, reprs, C, seed):
    """The port's build_ivf on JAX's clustering of ``reprs``."""
    result = jax_ivf.kmeans(reprs, C, iters=10, seed=seed)
    monkeypatch.setattr(ivf, "kmeans", lambda *a, **kw: result)


@pytest.mark.parametrize("capacity_factor", [1.5, 0.2])
def test_build_ivf_packing_and_search_equal_jax(monkeypatch, capacity_factor):
    reprs = _clustered(V=1000, C=6, D=16, seed=5)
    _jax_kmeans_in_port(monkeypatch, reprs, 6, 5)
    ours = ivf.build_ivf(reprs, 6, capacity_factor=capacity_factor, seed=5)
    theirs = jax_ivf.build_ivf(reprs, 6, capacity_factor=capacity_factor, seed=5)
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ours.nbytes() == theirs.nbytes()
    queries = reprs[::37] + 0.01
    for probes in (1, 3, 6, 99):
        got_ids, got_scores = ivf.search_ivf(ours, queries, k=5, probes=probes)
        want_ids, want_scores = jax_ivf.search_ivf(theirs, queries, k=5, probes=probes)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_scores.numpy(), np.asarray(want_scores))


def test_search_clamps_k_to_the_candidates():
    """probes=1 on a small index holds fewer than k candidates: JAX's
    ``_search`` raises; the port returns k columns, the tail -1 / -inf."""
    reprs = _clustered(V=40, D=8, C=2, seed=13)
    index = ivf.build_ivf(reprs, num_clusters=2, capacity_factor=2.0, seed=13)
    cands = index.cap + index.spill_ids.shape[0]
    assert cands < 60
    ids, scores = ivf.search_ivf(index, reprs[:4], k=60, probes=1)
    assert ids.shape == scores.shape == (4, 60)
    for row, sc in zip(ids.numpy(), scores.numpy()):
        real = row[row >= 0]
        assert len(np.unique(real)) == len(real) and (row[len(real):] == -1).all()
        assert np.isneginf(sc[len(real):]).all() and np.isfinite(sc[:len(real)]).all()
    with pytest.raises(Exception):
        jax_ivf.search_ivf(jax_ivf.IVFIndex(**dataclasses.asdict(index)), reprs[:4], k=60,
                           probes=1)
    # served through a bundle: k columns with -1 past the candidates
    bundle = {"item_reprs": reprs, **{f"ivf_{k}": v for k, v in dataclasses.asdict(index).items()}}
    recs = export.serve_topk(bundle, np.arange(3), k=50, probes=1)
    assert recs.shape == (3, 50) and (recs[:, -5:] == -1).all()


def test_ivf_full_probes_equal_int8_brute_force():
    reprs = _clustered(V=800, C=8, D=16)
    index = ivf.build_ivf(reprs, num_clusters=8, capacity_factor=2.0, seed=4)
    q, sc = quantize.quantize_reprs(reprs)
    bundle = {"item_reprs_int8": q, "item_scale": sc,
              **{f"ivf_{k}": v for k, v in dataclasses.asdict(index).items()}}
    ids = np.arange(0, 800, 9)
    np.testing.assert_array_equal(export.serve_topk(bundle, ids, k=10, probes=8),
                                  export.serve_topk(bundle, ids, k=10))


# ------------------------------------------------------------ bundles
@pytest.mark.parametrize("kind", ["f32", "int8", "ivf"])
def test_bundles_cross_serve(tmp_path, monkeypatch, kind):
    """A bundle written by either package is served by the other, with the
    writer's own ids."""
    reprs = _clustered(V=600, C=12, D=16, spread=0.5, seed=21)
    rng = np.random.default_rng(1)
    nbr = rng.integers(0, 600, (600, 3)).astype(np.int32)
    w = rng.random((600, 3)).astype(np.float32)
    kw = dict(metadata={"model": "pinsage", "k": 3}, quantize=kind != "f32",
              ivf_clusters=12 if kind == "ivf" else 0)
    _jax_kmeans_in_port(monkeypatch, reprs, 12, 0)
    export.export_serving_bundle(str(tmp_path / "ours.npz"), reprs, nbr, w, **kw)
    jax_export.export_serving_bundle(str(tmp_path / "theirs.npz"), reprs, nbr, w, **kw)
    ids = np.arange(0, 600, 11)
    serve = dict(k=8, probes=4 if kind == "ivf" else 0)
    for name in ("ours", "theirs"):
        path = str(tmp_path / f"{name}.npz")
        ours_b, theirs_b = export.load_serving_bundle(path), jax_export.load_serving_bundle(path)
        assert ours_b.keys() == theirs_b.keys() and ours_b["metadata"] == {"model": "pinsage",
                                                                          "k": 3}
        np.testing.assert_array_equal(export.serve_topk(ours_b, ids, **serve),
                                      jax_export.serve_topk(theirs_b, ids, exact=True, **serve))
    a = np.load(tmp_path / "ours.npz")
    b = np.load(tmp_path / "theirs.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in b.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_serve_without_an_ivf_index_refuses_probes():
    with pytest.raises(ValueError, match="ivf"):
        export.serve_topk({"item_reprs": np.ones((4, 8), np.float32)}, np.arange(2), probes=2)


def test_full_corpus_reprs_from_a_jax_init():
    from recommender_tpu.graph.bipartite import BipartiteGraph as JaxGraph
    from recommender_tpu.models.pinsage import ItemFeatures as JaxFeatures
    from recommender_tpu.models.pinsage import PinSage as JaxPinSage
    from recommender_tpu.models.pinsage_task import pinsage_train_batches as jax_batches
    from recommender_tpu.models.tasks import init_model as jax_init_model
    from recommender_tpu_torch.convert import load_flax_params
    from recommender_tpu_torch.graph.bipartite import BipartiteGraph
    from recommender_tpu_torch.models import ItemFeatures, PinSage

    rng = np.random.default_rng(0)
    us, its = rng.integers(0, 50, 400), rng.integers(0, 45, 400)
    year, genre = rng.integers(0, 4, 45).astype(np.int32), (rng.random((45, 5)) < 0.4)
    genre = genre.astype(np.float32)
    jg, g = JaxGraph(us, its, 50, 45), BipartiteGraph(us, its, 50, 45)
    jm = JaxPinSage(features=JaxFeatures(year, genre), embed_dim=4, conv_hidden=8, conv_out=8)
    params, _ = jax_init_model(jm, next(jax_batches(jg, 4, seed=0)))
    model = load_flax_params(PinSage(ItemFeatures(year, genre), embed_dim=4, conv_hidden=8,
                                     conv_out=8), jax.tree.map(np.asarray, params))
    got = reval.full_corpus_reprs(model, g, np.random.default_rng(1), batch_size=16)
    want = jax_eval.full_corpus_reprs(jm, params, jg, np.random.default_rng(1), batch_size=16)
    assert got.shape == want.shape == (45, 8)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
