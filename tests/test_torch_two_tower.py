"""The two-tower model in the port against the JAX package on the CPU: the
towers and the in-batch softmax loss from a converted JAX init (with and
without the category feature), unit-norm reprs, ``corpus_item_reprs``
against a direct call, the copy of ``interaction_batches`` bit for bit, and
the learning floor of ``tests/test_two_tower.py``.

Tolerances: the towers compute in bf16 (``nn/mlp.py``, as JAX's ``MLP``)
from the same f32 params, and the reprs came out bit for bit equal; they
are held within 1e-6 abs, the per-example losses within 1e-5 of the
largest (measured 1e-7). Gradients within 1e-2 of each one's largest
magnitude: a tower bias's gradient is a sum of bf16 cotangents over the
batch, which the two libraries round differently (measured up to 8e-3;
every other gradient equal). The loss against its own definition within
1e-5 relative. Across data ranks (``torch_dist_workers``, CPU gloo ranks)
the loss's negatives are the global batch's items, gathered: N ranks equal
one rank as the last test states.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from recommender_tpu.models import two_tower as jax_two_tower
from recommender_tpu.models.tasks import init_model as jax_init_model
from recommender_tpu_torch.convert import load_flax_params
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.graph.bipartite import BipartiteGraph
from recommender_tpu_torch.models import (
    TwoTower,
    corpus_item_reprs,
    init_model,
    interaction_batches,
    make_two_tower_task,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(user_vocab=50, item_vocab=40, embed_dim=8, repr_dim=8, tower_units=(16,))


def _batch(n=6, cats=False):
    rng = np.random.default_rng(0)
    b = {"user_id": rng.integers(0, 50, n).astype(np.int32),
         "item_id": rng.integers(0, 40, n).astype(np.int32)}
    if cats:
        b["item_cat"] = rng.integers(0, 5, n).astype(np.int32)
    return b


def _pair(cat_vocab=0):
    jm = jax_two_tower.TwoTower(cat_vocab=cat_vocab, **KW)
    params, _ = jax_init_model(jm, _batch(cats=bool(cat_vocab)))
    model = load_flax_params(TwoTower(cat_vocab=cat_vocab, **KW), jax.tree.map(np.asarray, params))
    return model, jm, params


@pytest.mark.parametrize("cat_vocab", [0, 5])
def test_towers_and_loss_from_a_jax_init(cat_vocab):
    model, jm, params = _pair(cat_vocab)
    batch = _batch(n=12, cats=bool(cat_vocab))
    ju, jv = jm.apply({"params": params}, batch)
    with torch.no_grad():
        u, v = model({k: torch.from_numpy(x) for k, x in batch.items()})
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    jloss, _ = jax_two_tower.make_two_tower_task(jm)

    def mean_loss(p):
        per_ex, _, _ = jloss(p, {}, batch, jax.random.PRNGKey(0), True)
        return per_ex.mean(), per_ex

    (_, jper_ex), jgrads = jax.value_and_grad(mean_loss, has_aux=True)(params)
    loss_fn, eval_fn = make_two_tower_task(model)
    per_ex, aux = loss_fn({k: torch.from_numpy(x) for k, x in batch.items()}, True)
    per_ex.mean().backward()
    want = np.asarray(jper_ex)
    assert np.max(np.abs(per_ex.detach().numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    assert 0.0 <= float(aux["inbatch_top1"]) <= 1.0
    named = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(named)
    for path, g in flat:
        name = ".".join(str(getattr(p, "key", p)) for p in path).replace(".kernel", ".weight")
        got = named[name].grad.numpy()
        got = got.T if name.endswith(".weight") else got
        assert np.max(np.abs(got - np.asarray(g))) <= 1e-2 * np.max(np.abs(np.asarray(g))), name
    hit, ones = eval_fn({k: torch.from_numpy(x) for k, x in batch.items()})
    assert hit.shape == ones.shape == (12,) and set(hit.tolist()) <= {0.0, 1.0}


def test_inbatch_softmax_loss_math_and_unit_norms():
    model = init_model(TwoTower(**KW), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss_fn, _ = make_two_tower_task(model)
    per_ex, _ = loss_fn(batch, False)
    with torch.no_grad():
        u, v = model(batch)
    logits = (u @ v.T).numpy().astype(np.float64) / model.temperature
    want = -np.log(np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    np.testing.assert_allclose(per_ex.detach().numpy(), np.diag(want), rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(v.numpy(), axis=1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="item_cat"):
        TwoTower(cat_vocab=3, **KW).item_repr(torch.arange(2))


def test_corpus_reprs_match_a_direct_call():
    model = init_model(TwoTower(**KW), seed=1)
    corpus = corpus_item_reprs(model, 40, batch_size=16)
    with torch.no_grad():
        direct = model.item_repr(torch.arange(40)).numpy()
    assert corpus.shape == (40, 8)
    np.testing.assert_allclose(corpus, direct, atol=5e-3, rtol=0)  # bf16 towers, other M
    cats = np.arange(40) % 3
    model = init_model(TwoTower(cat_vocab=3, **KW), seed=1)
    with torch.no_grad():
        direct = model.item_repr(torch.arange(40), torch.from_numpy(cats)).numpy()
    np.testing.assert_allclose(corpus_item_reprs(model, 40, item_cat=cats, batch_size=16),
                               direct, atol=5e-3, rtol=0)


def test_interaction_batches_copy_bit_for_bit():
    from recommender_tpu.graph.bipartite import BipartiteGraph as JaxGraph

    rng = np.random.default_rng(2)
    us, its = rng.integers(0, 30, 300), rng.integers(0, 20, 300)
    cats = rng.integers(0, 4, 20)
    ours = interaction_batches(BipartiteGraph(us, its, 30, 20), 64, seed=3, item_cat=cats)
    theirs = jax_two_tower.interaction_batches(JaxGraph(us, its, 30, 20), 64, seed=3,
                                               item_cat=cats)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_two_tower_learns_communities():
    """``tests/test_two_tower.py``'s learning floor: embed 16, repr 16,
    tower (32,), b256, lr 3e-3, 800 steps on the entry point's synthetic
    set; the full-corpus hit rate must clear 0.25 (random is ~0.05)."""
    from recommender_tpu_torch.cli.train_twotower import _synthetic, user_reprs
    from recommender_tpu_torch.data.movielens import ground_truth_matrix
    from recommender_tpu_torch.retrieval.eval import hit_rate, recommend_topk_from_queries

    g, test_item, seen = _synthetic(seed=0)
    m = init_model(TwoTower(user_vocab=g.num_users, item_vocab=g.num_items, embed_dim=16,
                            repr_dim=16, tower_units=(32,)), seed=0)
    loss_fn, eval_fn = make_two_tower_task(m)
    tr = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=10**9), eval_fn,
                 device="cpu")
    it = interaction_batches(g, 256, seed=0)
    next(it)
    state = tr.init_state(lambda: m)
    state, _ = tr.fit(state, it, steps=800)
    reprs = corpus_item_reprs(m, g.num_items)
    recs = recommend_topk_from_queries(user_reprs(m, g.num_users), reprs, seen, k=10)
    hr = hit_rate(recs, ground_truth_matrix(test_item, g.num_items))
    assert hr > 0.25, hr
    for u in range(0, g.num_users, 37):
        assert not seen[u][recs[u]].any()



# ------------------------------------------------------- across data ranks
def _global_batch(n=16):
    rng = np.random.default_rng(3)
    return {"user_id": rng.integers(0, W.TT_KW["user_vocab"], n).astype(np.int32),
            "item_id": rng.integers(0, W.TT_KW["item_vocab"], n).astype(np.int32)}


@pytest.fixture(scope="module")
def tt_init():
    jm = jax_two_tower.TwoTower(**W.TT_KW)
    batch = _global_batch()
    params, _ = jax_init_model(jm, batch)
    jloss, _ = jax_two_tower.make_two_tower_task(jm)
    want = float(jloss(params, {}, batch, jax.random.PRNGKey(0), True)[0].mean())
    return jax.tree.map(np.asarray, params), batch, want


@pytest.mark.parametrize("f32_towers", [True, False], ids=["f32_towers", "bf16_towers"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_data_ranks_give_one_ranks_loss_and_gradients(tmp_path, tt_init, ranks, f32_towers):
    """N ranks of b/N rows, the item reprs gathered across them, against
    one rank of b: the same loss within 1e-6, and (the Trainer's average
    over ranks) the same gradients within 1e-6 of each one's largest entry
    with f32 towers; with the shipped bf16 towers each rank's tower
    gradients are rounded before the average: within 1e-2, the bound
    against JAX above. The shipped towers' loss equals JAX's single-device
    loss on the converted weights within 1e-5 relative."""
    params, batch, want_loss = tt_init
    one = W.two_tower_grads(0, 1, "", params, batch, f32_towers)
    many = W.spawn(W.two_tower_grads, ranks, tmp_path, params, batch, f32_towers)
    tol = 1e-6 if f32_towers else 1e-2
    for r in many:
        assert abs(r["loss"] - one["loss"]) <= 1e-6
        for name, g in one["grads"].items():
            assert np.max(np.abs(r["grads"][name] - g)) <= tol * np.max(np.abs(g)), name
    hits = np.concatenate([r["hits"] for r in many])  # the labels follow the global rows
    np.testing.assert_array_equal(hits, one["hits"])
    assert abs(np.mean([r["top1"] for r in many]) - one["top1"]) <= 1e-6
    if not f32_towers:
        assert abs(one["loss"] - want_loss) <= 1e-5 * abs(want_loss)
