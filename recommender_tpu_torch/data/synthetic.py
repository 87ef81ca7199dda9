"""Synthetic datasets with planted structure.

Copies of ``recommender_tpu/data/synthetic.py::SyntheticCTR`` and
``SyntheticSequence``: the JAX package's ``data`` namespace imports jax on
load, and the port must run where jax is not installed. For the same seeds
the arrays are bit-identical to the originals' (``tests/test_torch_synthetic.py``,
``tests/test_torch_sequence.py``).

``SyntheticCTR`` (Criteo schema): each categorical value carries a latent
logistic weight, dense features add a linear term, and labels are Bernoulli
of the sigmoid, so a CTR model with embeddings can push AUC toward the
planted ceiling while a bias-only model stays at 0.5.

``SyntheticSequence`` (the DIEN batch schema) draws its examples in a
Python loop, one example at a time: sample once, outside any timed window.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCTR:
    num_int: int = 13
    num_cat: int = 26
    vocab_size: int = 100_000
    seed: int = 0
    zipf_a: float = 1.2  # power-law id popularity like real CTR traffic
    signal: float = 2.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._cat_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_cat), size=(self.vocab_size,)).astype(np.float32)
        self._int_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_int), size=(self.num_int,)).astype(np.float32)
        self._bias = -0.5

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        # Zipf-ish ids clipped to vocab (mimics log-uniform popularity)
        cat = rng.zipf(self.zipf_a, size=(n, self.num_cat)) % self.vocab_size
        cat = cat.astype(np.int32)
        ints = rng.normal(0.0, 1.0, size=(n, self.num_int)).astype(np.float32)
        logits = (
            self._cat_weights[cat].sum(axis=1)
            + ints @ self._int_weights
            + self._bias
        )
        p = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(n) < p).astype(np.float32)
        return {"int_features": ints, "cat_features": cat, "label": label}


@dataclasses.dataclass
class SyntheticSequence:
    """Amazon-Books-like behavior sequences (``dien/data_loader.py`` schema):
    target item/cat + padded positive history + sampled negative history.

    Ground truth: each user has a latent topic; history items and positive
    targets share it, negative targets don't — so attention models can
    separate them.
    """

    num_items: int = 1000
    num_cats: int = 50
    max_len: int = 20
    num_topics: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.item_topic = rng.integers(0, self.num_topics, size=self.num_items)
        self.item_topic[0] = -1  # pad row
        # categories correlate with topics (as in real catalogues), so models
        # can generalize topic-match structure instead of memorizing item ids
        cats_per_topic = max((self.num_cats - 1) // self.num_topics, 1)
        # clip to the vocab: with num_cats <= num_topics the affine map would
        # emit id == num_cats, and the JAX package's jnp.take fills out-of-range
        # gathers with NaN (an index error in the port)
        self.item_cat = np.clip(
            1
            + self.item_topic * cats_per_topic
            + rng.integers(0, cats_per_topic, size=self.num_items),
            1,
            self.num_cats - 1,
        ).astype(np.int32)
        self.item_cat[0] = 0
        # items grouped by topic for sampling
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
