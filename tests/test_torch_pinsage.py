"""PinSage in the port against the JAX package on the CPU: the copies of
``graph/bipartite.py`` (native and numpy sampler paths), the PinSage
bindings of ``graph/native.py`` and ``data/movielens.py`` bit for bit;
``FeatureProjector``, ``Convolve`` and ``get_repr`` from a converted JAX
init; the loss and gradients, and 20 Trainer steps, against JAX's;
``pinsage_train_batches``' leakage exclusion; the learning check of
``tests/test_pinsage.py``.

A 60-user, 40-item community graph (``tests/test_pinsage.py``'s), E 8,
conv 16 / 16, batch 16 pairs.

Tolerances: the model is f32 end to end, so the projector, Convolve and
``get_repr`` within 1e-5 of their largest magnitude; each gradient within
1e-4 of its own largest magnitude; the per-step losses of 20 Trainer steps
within 1e-4 abs (margin losses of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.core.train import TrainConfig as JaxTrainConfig
from recommender_tpu.core.train import Trainer as JaxTrainer
from recommender_tpu.data import movielens as jax_movielens
from recommender_tpu.graph import bipartite as jax_bipartite
from recommender_tpu.graph import native as jax_native
from recommender_tpu.models import pinsage as jax_pinsage
from recommender_tpu.models import pinsage_task as jax_pinsage_task
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu_torch.convert import load_flax_params
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import movielens
from recommender_tpu_torch.graph import bipartite, native
from recommender_tpu_torch.models import (
    Convolve,
    ItemFeatures,
    PinSage,
    init_model,
    make_pinsage_task,
    pinsage_train_batches,
)
from recommender_tpu_torch.nn.losses import margin_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread runs them several times
    faster than a pool does, and test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


E, HID, OUT, BATCH = 8, 16, 16, 16
GRAD_TOL = 1e-4


def _edges(num_users=60, num_items=40, num_comm=4, per_user=8, seed=0):
    """``tests/test_pinsage.py::_toy_graph``'s interactions and features."""
    rng = np.random.default_rng(seed)
    u_comm = rng.integers(0, num_comm, num_users)
    items_by_comm = np.array_split(np.arange(num_items), num_comm)
    us, its = [], []
    for u in range(num_users):
        pool = items_by_comm[u_comm[u]]
        for _ in range(per_user):
            it = int(rng.choice(pool)) if rng.random() < 0.9 else int(rng.integers(num_items))
            us.append(u)
            its.append(it)
    year = rng.integers(0, 5, num_items).astype(np.int32)
    genre = (rng.random((num_items, 6)) < 0.3).astype(np.float32)
    item_comm = np.zeros(num_items, np.int64)
    for c, block in enumerate(items_by_comm):
        item_comm[block] = c
    return (us, its, num_users, num_items), year, genre, item_comm


def _graphs(use_native=None):
    edges, year, genre, item_comm = _edges()
    ours = bipartite.BipartiteGraph(*edges, use_native=use_native)
    theirs = jax_bipartite.BipartiteGraph(*edges, use_native=use_native)
    return ours, theirs, (year, genre), item_comm


def _features(year, genre):
    return ItemFeatures(year=year, genre=genre), jax_pinsage.ItemFeatures(year=year, genre=genre)


def _assert_blocks_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-30))


def _torch_block(block):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in block.items()}


def _jax_pair(seed=0):
    """A JAX PinSage init and the port's PinSage loaded from it, with the
    JAX stream's first batch (the init example)."""
    ours_g, theirs_g, (year, genre), _ = _graphs()
    feats, jax_feats = _features(year, genre)
    jm = jax_pinsage.PinSage(features=jax_feats, embed_dim=E, conv_hidden=HID, conv_out=OUT)
    example = next(jax_pinsage_task.pinsage_train_batches(theirs_g, BATCH, seed=seed))
    params, _ = jax_init_model(jm, example, seed=seed)
    model = PinSage(feats, embed_dim=E, conv_hidden=HID, conv_out=OUT)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return model, jm, params, example, ours_g, theirs_g


# ------------------------------------------------------------ host copies
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_bipartite_copy_bit_for_bit(use_native):
    if use_native and not native.is_available():
        pytest.skip("native/libgraph_sampler.so did not build")
    ours, theirs, _, _ = _graphs(use_native)
    assert ours.native == theirs.native == use_native
    for name in ("u2i_indptr", "u2i_indices", "i2u_indptr", "i2u_indices"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for x, y in zip(ours.item2item_pairs(300, a), theirs.item2item_pairs(300, b)):
        np.testing.assert_array_equal(x, y)
    items = np.arange(40)
    excl = np.stack([(items + 1) % 40, (items + 2) % 40], axis=1)
    for kw in ({}, {"exclude": excl}, {"num_walks": 8, "walk_length": 3}):
        for x, y in zip(ours.importance_neighbors(items, rng=a, **kw),
                        theirs.importance_neighbors(items, rng=b, **kw)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    nodes = np.arange(12, dtype=np.int32)
    _assert_blocks_equal(
        bipartite.sample_block_batch(ours, nodes, a, exclude=excl[:12]).as_dict(),
        jax_bipartite.sample_block_batch(theirs, nodes, b, exclude=excl[:12]).as_dict())
    ours_it = pinsage_train_batches(ours, BATCH, seed=3)
    theirs_it = jax_pinsage_task.pinsage_train_batches(theirs, BATCH, seed=3)
    for _ in range(3):
        _assert_blocks_equal(next(ours_it), next(theirs_it))


def test_native_pinsage_bindings_equal_the_jax_packages():
    if not native.is_available():
        pytest.skip("native/libgraph_sampler.so did not build")
    g, _, _, _ = _graphs(True)
    csr = (g.i2u_indptr, g.i2u_indices, g.u2i_indptr, g.u2i_indices)
    items = np.arange(40)
    np.testing.assert_array_equal(native.metapath_i2u2i(*csr, items, 7),
                                  jax_native.metapath_i2u2i(*csr, items, 7))
    excl = np.stack([items[::-1], items], axis=1)
    for kw in ({}, {"exclude": excl}):
        for x, y in zip(native.pinsage_importance_neighbors(*csr, items, 3, 4, 2, 0.5, 11, **kw),
                        jax_native.pinsage_importance_neighbors(*csr, items, 3, 4, 2, 0.5, 11,
                                                                **kw)):
            np.testing.assert_array_equal(x, y)


def _movielens_lines(rng, users=30, movies=25):
    genres = ["Action", "Comedy", "Drama", "Children's", "Sci-Fi", "Film-Noir"]
    movie_lines = []
    for m in range(1, movies + 1):
        year = "(19%02d)" % rng.integers(0, 100) if rng.random() < 0.9 else "(no year)"
        gl = "|".join(sorted(set(rng.choice(genres, rng.integers(1, 4)).tolist())))
        movie_lines.append(f"{m}::Title {m} {year}::{gl}\n")
    rating_lines = []
    for u in range(1, users + 1):
        for _ in range(rng.integers(1, 9)):
            m = rng.integers(1, movies + 3)  # ids past the movie list are dropped
            rating_lines.append(f"{u}::{m}::{rng.integers(1, 6)}::{rng.integers(0, 10**6)}\n")
    return rating_lines, movie_lines


def test_movielens_copy_bit_for_bit():
    ratings = ["1::1::5::100", "1::2::4::300", "1::3::3::200", "1::4::5::400",
               "2::1::4::100", "2::2::3::200"]
    movies = ["1::Toy Story (1995)::Animation|Children's|Comedy",
              "2::Jumanji (1995)::Adventure|Children's|Fantasy",
              "3::Heat (1995)::Action|Crime|Thriller", "4::Old (1911)::Drama"]
    for r, m in ((ratings, movies), _movielens_lines(np.random.default_rng(0))):
        ours, theirs = movielens.parse_movielens(r, m), jax_movielens.parse_movielens(r, m)
        assert (ours.num_users, ours.num_items) == (theirs.num_users, theirs.num_items)
        for name in ("val_user_item", "test_user_item", "latest_train_item", "train_seen"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
        np.testing.assert_array_equal(ours.features.year, theirs.features.year)
        np.testing.assert_array_equal(ours.features.genre, theirs.features.genre)
        for name in ("u2i_indptr", "u2i_indices", "i2u_indptr", "i2u_indices"):
            np.testing.assert_array_equal(getattr(ours.graph, name), getattr(theirs.graph, name))
        for k in theirs.graph.edge_data:
            np.testing.assert_array_equal(ours.graph.edge_data[k], theirs.graph.edge_data[k])
        gt = movielens.ground_truth_matrix(ours.test_user_item, ours.num_items)
        np.testing.assert_array_equal(
            gt, jax_movielens.ground_truth_matrix(theirs.test_user_item, theirs.num_items))


# ------------------------------------------------------------ the model
def test_projector_convolve_and_get_repr_from_a_jax_init():
    model, jm, params, example, _, _ = _jax_pair()
    variables = {"params": params}
    ids = example["nbr2"]
    want = jm.apply(variables, jnp.asarray(ids), method=lambda m, x: m.projector(x))
    with torch.no_grad():
        got = model.projector(torch.from_numpy(ids))
    assert got.shape == want.shape and _rel_err(got, want) < 1e-5
    block = _torch_block(example)
    with torch.no_grad():
        got = model.get_repr(block)
        pos, neg = model(block)
    want = jm.apply(variables, example, method=jm.get_repr)
    assert got.shape == (3 * BATCH, OUT) and _rel_err(got, want) < 1e-5
    jpos, jneg = jm.apply(variables, example)
    assert _rel_err(pos, jpos) < 1e-5 and _rel_err(neg, jneg) < 1e-5
    # the feature arrays are buffers that no state_dict carries
    assert not any("item_" in k for k in model.state_dict())


def test_convolve_from_a_jax_init():
    rng = np.random.default_rng(0)
    dst = rng.normal(size=(5, 12)).astype(np.float32)
    nbr = rng.normal(size=(5, 3, 12)).astype(np.float32)
    w = rng.random((5, 3)).astype(np.float32)
    w[1] = 0.0  # the weight sum clipped to 1
    w[2] *= 10.0
    jlayer = jax_pinsage.Convolve(hidden=8, out=6)
    params = jlayer.init(jax.random.PRNGKey(0), dst, nbr, w)["params"]
    layer = load_flax_params(Convolve(12, 8, 6), jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = layer(*(torch.from_numpy(x) for x in (dst, nbr, w)))
    want = jlayer.apply({"params": params}, dst, nbr, w)
    assert _rel_err(got, want) < 1e-5
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-5)
    # zero weights: the output depends on dst only
    with torch.no_grad():
        a = layer(torch.from_numpy(dst), torch.from_numpy(nbr), torch.zeros(5, 3))
        b = layer(torch.from_numpy(dst), torch.from_numpy(nbr) * 100, torch.zeros(5, 3))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_task_loss_and_gradients_match_jax():
    model, jm, params, example, _, _ = _jax_pair()
    jloss = jax_pinsage_task.make_pinsage_task(jm)

    def mean_loss(p):
        per_ex, aux, _ = jloss(p, {}, example, jax.random.PRNGKey(0), True)
        return jnp.mean(per_ex), (per_ex, aux)

    (_, (jper_ex, jaux)), jgrads = jax.value_and_grad(mean_loss, has_aux=True)(params)
    per_ex, aux = make_pinsage_task(model)(_torch_block(example), True)
    per_ex.mean().backward()
    assert _rel_err(per_ex.detach(), jper_ex) < 1e-5
    for k in ("pos_score", "neg_score"):
        assert abs(float(aux[k]) - float(jaux[k])) < 1e-5
    flat = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    named = dict(model.named_parameters())
    assert len(flat) == len(named) == 15
    for name, want in flat.items():
        name = name.replace(".kernel", ".weight")
        got = named[name].grad.numpy()
        if got.ndim == 2 and name.endswith(".weight"):
            got = got.T
        assert _rel_err(got, want) < GRAD_TOL, name
    np.testing.assert_array_equal(
        margin_loss(torch.tensor([1.0, 0.0, 2.0]), torch.tensor([0.5, 0.5, 0.0])).numpy(),
        [0.5, 1.5, 0.0])


def test_twenty_trainer_steps_match_jax():
    model, jm, params, _, ours_g, theirs_g = _jax_pair()
    jtr = JaxTrainer(jax_pinsage_task.make_pinsage_task(jm),
                     JaxTrainConfig(learning_rate=3e-3, log_every=1))
    jit = jax_pinsage_task.pinsage_train_batches(theirs_g, BATCH, seed=0)
    next(jit)
    jstate = jtr.init_state(lambda: (params, {}))
    jstate, jhist = jtr.fit(jstate, jit, steps=20)
    tr = Trainer(make_pinsage_task(model), TrainConfig(learning_rate=3e-3, log_every=1),
                 device="cpu")
    it = pinsage_train_batches(ours_g, BATCH, seed=0)
    next(it)
    state = tr.init_state(lambda: model)
    state, hist = tr.fit(state, it, steps=20)
    ours = np.array([h["loss"] for h in hist])
    theirs = np.array([h["loss"] for h in jhist])
    assert len(ours) == len(theirs) == 20
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)


def test_train_batches_exclude_the_pairs_at_both_layers():
    """Each head's frontier, at layer 1 and in its whole layer-2 group,
    holds neither its positive nor its negative tail; each tail's holds
    not its head (``data_loader.py:34-39``)."""
    g, _, _, _ = _graphs()
    batch = next(pinsage_train_batches(g, BATCH, seed=1))
    n = BATCH
    nodes = batch["nodes"]
    heads, pos, neg = nodes[:n], nodes[n:2 * n], nodes[2 * n:]
    T = batch["nbr1"].shape[1]
    for i in range(3 * n):
        j = i % n
        banned = {int(pos[j]), int(neg[j])} if i < n else {int(heads[j])}
        assert not banned & set(batch["nbr1"][i][batch["w1"][i] > 0].tolist())
        for r in range(i * (1 + T), (i + 1) * (1 + T)):
            assert not banned & set(batch["nbr2"][r][batch["w2"][r] > 0].tolist())
    # an unused neighbour slot holds the item itself with weight 0
    pad = batch["w1"] == 0
    assert (batch["nbr1"][pad] == np.repeat(nodes[:, None], T, axis=1)[pad]).all()


def test_pinsage_learns_communities():
    """``tests/test_pinsage.py::test_pinsage_trains_and_retrieves``: after
    120 steps, items of one community are closer than across communities."""
    from recommender_tpu_torch.retrieval.eval import full_corpus_reprs

    g, _, (year, genre), item_comm = _graphs()
    feats, _ = _features(year, genre)
    model = init_model(PinSage(feats, embed_dim=8, conv_hidden=16, conv_out=16), seed=0)
    tr = Trainer(make_pinsage_task(model), TrainConfig(learning_rate=3e-3, log_every=10**9),
                 device="cpu")
    it = pinsage_train_batches(g, 32, seed=0)
    next(it)
    state = tr.init_state(lambda: model)
    state, _ = tr.fit(state, it, steps=120)
    reprs = full_corpus_reprs(state.model, g, np.random.default_rng(1), batch_size=40)
    assert reprs.shape == (g.num_items, 16)
    sims = reprs @ reprs.T
    intra = sims[item_comm[:, None] == item_comm[None, :]].mean()
    inter = sims[item_comm[:, None] != item_comm[None, :]].mean()
    assert intra > inter, (intra, inter)


def test_num_layers_other_than_two_is_refused():
    _, _, (year, genre), _ = _graphs()
    with pytest.raises(ValueError, match="num_layers"):
        PinSage(ItemFeatures(year, genre), num_layers=3)

