"""Synthetic datasets with planted structure.

Copies of ``recommender_tpu/data/synthetic.py::SyntheticCTR``,
``SyntheticSequence`` and ``SyntheticMultiTask``: the JAX package's ``data``
namespace imports jax on load, and the port must run where jax is not
installed. For the same seeds the arrays are bit-identical to the
originals' (``tests/test_torch_synthetic.py``, ``tests/test_torch_sequence.py``,
``tests/test_torch_graph_data.py``).

``SyntheticCTR`` (Criteo schema): each categorical value carries a latent
logistic weight, dense features add a linear term, and labels are Bernoulli
of the sigmoid, so a CTR model with embeddings can push AUC toward the
planted ceiling while a bias-only model stays at 0.5.

``SyntheticSequence`` (the DIEN batch schema) draws its examples in a
Python loop, one example at a time: sample once, outside any timed window.

``SyntheticMultiTask`` (the Ali-CCP schema: 18 categorical columns, click
and purchase labels) plants per-value logistic weights for both labels, and
optionally the sample-selection-bias regime ESMM exists for.
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


@dataclasses.dataclass
class SyntheticMultiTask:
    """Ali-CCP-like impression records with (click, purchase) labels
    (``esmm/tfrecord_io.py:116-138`` schema: 18 categorical columns).

    Defaults reproduce the easy fully-observed regime (dense small vocabs,
    ~27% click rate) where any full- or click-space trainer learns the
    logistic structure. The extra knobs plant the SAMPLE-SELECTION-BIAS
    regime the ESMM decomposition exists for (``esmm/README.md:17-23``;
    paper's "data sparsity" + "sample selection bias" claims):

    * ``click_bias`` low (e.g. -2.5) → clicks are a few % of impressions,
      so a CVR model trained on clicks only (the Base two-model protocol,
      ``esmm/train.py:14-91``) sees ~20× less data than the impression
      space it is evaluated on;
    * ``zipf_a`` > 0 → Zipf id popularity: the long tail of feature values
      carries real probability mass in impressions but is barely present in
      the clicked subset, so click-space embeddings are undertrained exactly
      where the impression-wide CTCVR eval needs them (ESMM's shared
      embedding trains on ALL impressions through the CTR head);
    * ``confounding`` > 0 → a latent per-impression ``u ~ N(0,1)`` added to
      both logits: clicked impressions are tilted toward high ``u``, so
      ``E[buy | x, click=1] != E[buy | x]`` and the click-space conditional
      is a non-additive function of both planted scores (learnable only
      with data the clicked subset doesn't have).

    Note (honest mechanism accounting, r3 cold-start-study style): with an
    expressive model and infinite clicked data, ``p_ctr(x)·p_cvr_click(x)``
    converges to the true CTCVR even under confounding — the planted harm
    is the finite-sample interaction of the three knobs, which is exactly
    the published mechanism, not a straw man.
    """

    num_feats: int = 18
    vocab_sizes: tuple = ()
    signal: float = 1.6
    seed: int = 0
    click_bias: float = -1.0
    buy_bias: float = -1.5
    confounding: float = 0.0
    zipf_a: float = 0.0  # 0 = uniform ids; >0 = Zipf popularity

    def __post_init__(self):
        if not self.vocab_sizes:
            # small per-feature vocabs: every value is seen often enough that
            # generalization beats memorization within a few hundred steps
            self.vocab_sizes = tuple([50] * self.num_feats)
        rng = np.random.default_rng(self.seed)
        self._w_click = [
            rng.normal(0, self.signal / np.sqrt(self.num_feats), size=v).astype(np.float32)
            for v in self.vocab_sizes
        ]
        self._w_buy = [
            rng.normal(0, self.signal / np.sqrt(self.num_feats), size=v).astype(np.float32)
            for v in self.vocab_sizes
        ]

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        if self.zipf_a > 0:
            feats = np.stack(
                [rng.zipf(self.zipf_a, size=n) % v for v in self.vocab_sizes],
                axis=1,
            ).astype(np.int32)
        else:
            feats = np.stack(
                [rng.integers(0, v, size=n) for v in self.vocab_sizes], axis=1
            ).astype(np.int32)
        logit_click = sum(
            self._w_click[j][feats[:, j]] for j in range(self.num_feats)
        ) + self.click_bias
        logit_buy = (
            sum(self._w_buy[j][feats[:, j]] for j in range(self.num_feats))
            + self.buy_bias
        )
        if self.confounding > 0:
            u = rng.normal(0.0, 1.0, size=n).astype(np.float32)
            logit_click = logit_click + self.confounding * u
            logit_buy = logit_buy + self.confounding * u
        click = (rng.random(n) < 1 / (1 + np.exp(-logit_click))).astype(np.float32)
        buy_given_click = (rng.random(n) < 1 / (1 + np.exp(-logit_buy))).astype(
            np.float32
        )
        buy = click * buy_given_click  # no click ⇒ no purchase (ESMM assumption)
        return {"features": feats, "click": click, "purchase": buy}
