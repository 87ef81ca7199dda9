"""Behaviour sequences in the DIEN batch schema: a target item and
category, a post-padded history of ``history`` steps (its length uniform
in [history / 2, history]), a negative history and a label.

``SyntheticSequence`` is a frozen copy of the port's
``recommender_tpu_torch/data/synthetic.py::SyntheticSequence``: for the
same seeds the arrays are the same (``portbench/tests``).

Traffic keys: ``batch``, ``pool_batches``, ``history`` (T, the padded
history length), ``num_topics``, and ``drop`` (keys the model does not
read, left out of the batches so that they are not copied to the card).
The vocabularies are the model's (``item_vocab``, ``cat_vocab``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticSequence:
    num_items: int = 1000
    num_cats: int = 50
    max_len: int = 20
    num_topics: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.item_topic = rng.integers(0, self.num_topics, size=self.num_items)
        self.item_topic[0] = -1  # pad row
        cats_per_topic = max((self.num_cats - 1) // self.num_topics, 1)
        self.item_cat = np.clip(
            1
            + self.item_topic * cats_per_topic
            + rng.integers(0, cats_per_topic, size=self.num_items),
            1,
            self.num_cats - 1,
        ).astype(np.int32)
        self.item_cat[0] = 0
        self._by_topic = [
            np.where(self.item_topic == t)[0] for t in range(self.num_topics)
        ]

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        T = self.max_len
        topics = rng.integers(0, self.num_topics, size=n)
        his_item = np.zeros((n, T), np.int32)
        his_cat = np.zeros((n, T), np.int32)
        neg_item = np.zeros((n, T), np.int32)
        neg_cat = np.zeros((n, T), np.int32)
        target_item = np.zeros((n,), np.int32)
        target_cat = np.zeros((n,), np.int32)
        label = np.zeros((n,), np.float32)
        for i in range(n):
            t = topics[i]
            pool = self._by_topic[t]
            ln = rng.integers(T // 2, T + 1)
            hist = rng.choice(pool, size=ln)
            his_item[i, :ln] = hist
            his_cat[i, :ln] = self.item_cat[hist]
            negs = rng.integers(1, self.num_items, size=ln)
            neg_item[i, :ln] = negs
            neg_cat[i, :ln] = self.item_cat[negs]
            pos = rng.random() < 0.5
            label[i] = pos
            tgt = rng.choice(pool) if pos else rng.integers(1, self.num_items)
            target_item[i] = tgt
            target_cat[i] = self.item_cat[tgt]
        return {
            "target_item": target_item,
            "target_cat": target_cat,
            "pos_his_item": his_item,
            "pos_his_cat": his_cat,
            "neg_his_item": neg_item,
            "neg_his_cat": neg_cat,
            "label": label,
        }


def pool(traffic: dict, model: dict, seed: int, count: int | None = None) -> list[dict]:
    """The first ``count`` (all where None) of the traffic's pool of batches."""
    world, *batch_seeds = np.random.SeedSequence(seed).generate_state(1 + traffic["pool_batches"])
    gen = SyntheticSequence(num_items=model["item_vocab"], num_cats=model["cat_vocab"],
                            max_len=traffic["history"], num_topics=traffic["num_topics"],
                            seed=int(world))
    drop = set(traffic.get("drop", ()))
    return [{k: v for k, v in gen.sample(traffic["batch"], seed=int(s)).items() if k not in drop}
            for s in batch_seeds[:count]]
