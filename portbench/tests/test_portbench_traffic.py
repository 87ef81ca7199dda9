"""The frozen traffic generators against the port's."""
import numpy as np
import pytest

from portbench.generators import ctr, sequence
from recommender_tpu_torch.data.synthetic import SyntheticCTR, SyntheticSequence


def test_ctr_generator_is_the_ports():
    ours = ctr.SyntheticCTR(vocab_size=5000, seed=11).sample(256, seed=7)
    theirs = SyntheticCTR(vocab_size=5000, seed=11).sample(256, seed=7)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k])


def test_sequence_generator_is_the_ports():
    kw = dict(num_items=3000, num_cats=40, max_len=30, num_topics=8, seed=5)
    ours = sequence.SyntheticSequence(**kw).sample(64, seed=9)
    theirs = SyntheticSequence(**kw).sample(64, seed=9)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k])


def test_pools_follow_the_seed():
    traffic = dict(batch=16, pool_batches=5, zipf_a=1.2, signal=2.0)
    model = dict(num_int=13, num_cat=26, vocab_size=1000)
    a, b = ctr.pool(traffic, model, 2**33 + 5), ctr.pool(traffic, model, 2**33 + 5)
    c = ctr.pool(traffic, model, 6)
    assert len(a) == 5 and all(np.array_equal(x["cat_features"], y["cat_features"])
                               for x, y in zip(a, b))
    assert not np.array_equal(a[0]["cat_features"], c[0]["cat_features"])
    first = ctr.pool(traffic, model, 2**33 + 5, count=2)
    assert len(first) == 2 and np.array_equal(first[1]["int_features"], a[1]["int_features"])
    # the check's steps see different rows
    assert not np.array_equal(a[0]["cat_features"], a[1]["cat_features"])


def test_sequence_pool_drops_unread_keys():
    traffic = dict(batch=8, pool_batches=4, history=12, num_topics=8,
                   drop=["neg_his_item", "neg_his_cat"])
    pool = sequence.pool(traffic, dict(item_vocab=500, cat_vocab=20), 3)
    assert set(pool[0]) == {"target_item", "target_cat", "pos_his_item", "pos_his_cat", "label"}
    lengths = (pool[0]["pos_his_item"] != 0).sum(1)
    assert lengths.min() >= 6 and lengths.max() <= 12


def test_ctr_pool_lays_each_feature_into_its_own_rows():
    counts = [3, 50, 7, 1000]
    traffic = dict(batch=512, pool_batches=4, zipf_a=1.2, signal=2.0)
    model = dict(num_int=13, num_cat=4, vocab_size=sum(counts), cardinalities=counts)
    cat = ctr.pool(traffic, model, 2**35 + 1)[0]["cat_features"]
    starts = np.cumsum([0] + counts)
    for f in range(4):
        assert starts[f] <= cat[:, f].min() and cat[:, f].max() < starts[f + 1]
    assert len(np.unique(cat[:, 3])) > 50  # the large feature reaches past its head
    with pytest.raises(ValueError):
        ctr.pool(traffic, {**model, "vocab_size": 999}, 1)
