"""The port's host-side copies against their originals, bit for bit: the
graph store (``WeightedGraph``, alias tables native and numpy), walks,
skip-gram pairs, the log-uniform sampler, ``skipgram_batches`` on the native
and the numpy path, ``amazon_meta`` on a metadata fixture, ``aliccp`` and
``cli.prepare_aliccp`` on a raw Ali-CCP fixture, and ``SyntheticMultiTask``
with every knob.
"""
import json

import numpy as np
import pytest

from recommender_tpu.cli import prepare_aliccp as jax_prepare_aliccp
from recommender_tpu.data import aliccp as jax_aliccp
from recommender_tpu.data import amazon_meta as jax_amazon_meta
from recommender_tpu.data.synthetic import SyntheticMultiTask as JaxSyntheticMultiTask
from recommender_tpu.graph import native as jax_native
from recommender_tpu.graph import store as jax_store
from recommender_tpu.graph import walks as jax_walks
from recommender_tpu_torch.cli import prepare_aliccp
from recommender_tpu_torch.data import SyntheticMultiTask, aliccp, amazon_meta
from recommender_tpu_torch.graph import native, store, walks


def _same(got, want):
    """Equal arrays (dtype, shape and every element), or equal containers
    of them."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _edges(num_nodes=120, per_node=6, seed=0):
    """Weighted undirected edges with a few dead ends (nodes with no edge)."""
    rng = np.random.default_rng(seed)
    src, dst, w = [], [], []
    for v in range(1, num_nodes - 5):
        for u in rng.integers(1, num_nodes - 5, per_node):
            if u != v:
                c = float(rng.integers(1, 9))
                src += [v, int(u)]
                dst += [int(u), v]
                w += [c, c]
    return src, dst, w, num_nodes


def _graphs(use_native):
    src, dst, w, n = _edges()
    ours = store.WeightedGraph.from_edges(src, dst, w, num_nodes=n)
    theirs = jax_store.WeightedGraph.from_edges(src, dst, w, num_nodes=n)
    if not use_native:  # rebuild both on the numpy path
        ours = store.WeightedGraph(ours.indptr, ours.indices, ours.weights, n, use_native=False)
        theirs = jax_store.WeightedGraph(theirs.indptr, theirs.indices, theirs.weights, n,
                                         use_native=False)
    assert ours.native == theirs.native == use_native
    return ours, theirs


def test_native_sampler_loads_for_both():
    assert native.is_available() and jax_native.is_available()
    assert native._LIB_PATH == jax_native._LIB_PATH


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_weighted_graph_and_alias_tables(use_native):
    ours, theirs = _graphs(use_native)
    for attr in ("indptr", "indices", "weights", "degrees", "alias_prob", "alias_idx"):
        _same(getattr(ours, attr), getattr(theirs, attr))
    assert ours.num_nodes == theirs.num_nodes
    _same(ours.neighbors(7), theirs.neighbors(7))
    nodes = np.arange(ours.num_nodes)
    _same(ours.sample_neighbors(nodes, np.random.default_rng(3)),
          theirs.sample_neighbors(nodes, np.random.default_rng(3)))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_random_walk_and_skipgram_pairs(use_native):
    ours, theirs = _graphs(use_native)
    seeds = np.arange(1, ours.num_nodes)
    got = walks.random_walk(ours, seeds, 9, np.random.default_rng(5))
    want = jax_walks.random_walk(theirs, seeds, 9, np.random.default_rng(5))
    _same(got, want)
    assert (want == -1).any()  # the dead ends are exercised
    _same(walks.skipgram_pairs(got, 3), jax_walks.skipgram_pairs(want, 3))


def test_log_uniform_sampler():
    ours, theirs = walks.LogUniformSampler(5000), jax_walks.LogUniformSampler(5000)
    _same(ours.sample((64, 5), np.random.default_rng(2)),
          theirs.sample((64, 5), np.random.default_rng(2)))
    ids = np.arange(0, 5000, 37)
    _same(ours.expected_prob(ids), theirs.expected_prob(ids))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_skipgram_batches(use_native):
    ours, theirs = _graphs(use_native)
    rng = np.random.default_rng(9)
    side = {"cat": rng.integers(0, 7, ours.num_nodes).astype(np.int32),
            "brand": rng.integers(0, 11, ours.num_nodes).astype(np.int32)}
    kw = dict(walk_length=6, window=2, num_negatives=4, batch_size=96, walks_per_round=16,
              side_info=side, seed=4)
    got_it, want_it = walks.skipgram_batches(ours, **kw), jax_walks.skipgram_batches(theirs, **kw)
    for _ in range(6):
        _same(next(got_it), next(want_it))


# ---------------------------------------------------------- amazon_meta
def _meta_lines(n=60, seed=0):
    """``tests/test_cli_rawformat.py``'s metadata fixture, with some items
    missing a brand or a category and unknown also-buy items."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        rec = {"asin": f"A{i}", "also_buy": [f"A{int(x)}" for x in rng.integers(0, n + 5, 4)]}
        if i % 9:
            rec["main_cat"] = f"cat{i % 5}"
        if i % 11:
            rec["brand"] = f"b{i % 7}"
        lines.append(json.dumps(rec))
    return lines


def test_amazon_meta():
    lines = _meta_lines()
    got = amazon_meta.load_metadata(lines)
    want = jax_amazon_meta.load_metadata(lines)
    assert got == want
    pairs, i2c, i2b = want
    split = amazon_meta.train_test_split(pairs, seed=3)
    assert split == jax_amazon_meta.train_test_split(pairs, seed=3)
    train_pairs, test_pairs = split
    vocab = amazon_meta.build_vocab(train_pairs, pairs, i2c, i2b)
    assert vocab == jax_amazon_meta.build_vocab(train_pairs, pairs, i2c, i2b)
    side = amazon_meta.side_info_arrays(*vocab, i2c, i2b)
    _same(side, jax_amazon_meta.side_info_arrays(*vocab, i2c, i2b))
    g = amazon_meta.build_train_graph(train_pairs, pairs, vocab[0])
    h = jax_amazon_meta.build_train_graph(train_pairs, pairs, vocab[0])
    for attr in ("indptr", "indices", "weights", "alias_prob", "alias_idx"):
        _same(getattr(g, attr), getattr(h, attr))
    for side_info in (None, side):
        _same(amazon_meta.link_prediction_triples(test_pairs, vocab[0],
                                                  np.random.default_rng(1), side_info),
              jax_amazon_meta.link_prediction_triples(test_pairs, vocab[0],
                                                      np.random.default_rng(1), side_info))


# --------------------------------------------------------------- aliccp
def _aliccp_raw(tmp_path, split, n, seed):
    """``tests/test_cli_rawformat.py``'s raw fixture: a common_features CSV
    (key,feat_num,kv) and a sample_skeleton CSV (sample_id,click,buy,
    common_key,feat_num,kv) with \\x01\\x02\\x03-separated k/v/weight
    triples; some rows click=0 ∧ buy=1 (dropped), some common keys unknown."""
    rng = np.random.default_rng(seed)
    common_cols, sample_cols = aliccp.USE_COLUMNS[:6], aliccp.USE_COLUMNS[6:]

    def kv_field(cols, tag):
        return "\x01".join(f"{c}\x02{tag}{c}_{int(rng.integers(4))}\x031.0" for c in cols)

    common_lines = [f"ck{g},{len(common_cols)},{kv_field(common_cols, 'u')}" for g in range(8)]
    skel_lines = []
    for i in range(n):
        click = int(rng.random() < 0.4)
        buy = int(rng.random() < 0.3) if click or i % 17 == 0 else 0
        skel_lines.append(f"{i},{click},{buy},ck{int(rng.integers(10))},"
                          f"{len(sample_cols)},{kv_field(sample_cols[:-1], 'i')}")
    common_f = tmp_path / f"common_{split}.csv"
    skel_f = tmp_path / f"skeleton_{split}.csv"
    common_f.write_text("\n".join(common_lines) + "\n")
    skel_f.write_text("\n".join(skel_lines) + "\n")
    return skel_f, common_f


def test_aliccp_functions(tmp_path):
    assert aliccp.USE_COLUMNS == jax_aliccp.USE_COLUMNS
    skel, common = _aliccp_raw(tmp_path, "train", 300, seed=0)
    field = skel.read_text().splitlines()[0].split(",")[5]
    assert aliccp.parse_kv_features(field) == jax_aliccp.parse_kv_features(field)
    c_ours = aliccp.load_common_features(common.read_text().splitlines())
    assert c_ours == jax_aliccp.load_common_features(common.read_text().splitlines())
    rows = list(aliccp.join_skeleton(skel.read_text().splitlines(), c_ours))
    assert rows == list(jax_aliccp.join_skeleton(skel.read_text().splitlines(), c_ours))
    assert len(rows) < 300  # click=0 ∧ buy=1 rows dropped
    vocab = aliccp.build_feature_vocab((v for _, _, v in rows), 3)
    assert vocab == jax_aliccp.build_feature_vocab((v for _, _, v in rows), 3)
    assert aliccp.vocab_sizes(vocab) == jax_aliccp.vocab_sizes(vocab)
    arrays = aliccp.encode_rows(rows, vocab)
    _same(arrays, jax_aliccp.encode_rows(rows, vocab))
    _same(aliccp.subsample_impressions(arrays, 3), jax_aliccp.subsample_impressions(arrays, 3))
    _same(aliccp.click_only(arrays), jax_aliccp.click_only(arrays))


def test_prepare_aliccp_writes_the_same_files(tmp_path, capsys):
    train = _aliccp_raw(tmp_path, "train", 400, seed=0)
    test = _aliccp_raw(tmp_path, "test", 200, seed=1)
    outs = {}
    for name, entry in (("ours", prepare_aliccp.main), ("theirs", jax_prepare_aliccp.main)):
        out = tmp_path / name
        entry(["--train_skeleton", str(train[0]), "--train_common", str(train[1]),
               "--test_skeleton", str(test[0]), "--test_common", str(test[1]),
               "--out_dir", str(out), "--min_count", "2", "--subsample", "4"])
        outs[name] = out
    printed = capsys.readouterr().out.splitlines()
    assert printed[:len(printed) // 2] == printed[len(printed) // 2:]
    for f in ("train_impressions.npz", "train_subsampled.npz", "train_clicks.npz", "test.npz"):
        _same(dict(np.load(outs["ours"] / f)), dict(np.load(outs["theirs"] / f)))
    assert (outs["ours"] / "vocab.json").read_text() == (outs["theirs"] / "vocab.json").read_text()


# ---------------------------------------------------- SyntheticMultiTask
@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_feats=5, vocab_sizes=(30, 7, 100, 2, 9), signal=2.3, seed=3),
    dict(click_bias=-2.5, buy_bias=-0.5, zipf_a=1.3, confounding=0.8, seed=1),
], ids=["defaults", "widths", "selection_bias"])
def test_synthetic_multitask(kw):
    ours, theirs = SyntheticMultiTask(**kw), JaxSyntheticMultiTask(**kw)
    assert ours.vocab_sizes == theirs.vocab_sizes
    for seed in (1, 2):
        _same(ours.sample(500, seed=seed), theirs.sample(500, seed=seed))
