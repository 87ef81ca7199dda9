"""Synthetic datasets with planted structure.

Copies of ``recommender_tpu/data/synthetic.py::SyntheticCTR``,
``SyntheticSequence``, ``SyntheticInterestDrift``, ``SyntheticMultiInterest``
and ``SyntheticMultiTask``: the JAX package's ``data``
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

``SyntheticInterestDrift`` (histories whose label rides on their order)
and ``SyntheticMultiInterest`` (unordered multi-interest histories, the
label set membership) take the DIEN batch schema too, drawn vectorized.

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
class SyntheticInterestDrift:
    """Behavior sequences whose label depends on the ORDER of the history —
    the regime the reference's +0.045 DIEN-over-BASE separation rides on
    (``dien/README.md:19-23``; mechanism ladder ``dien/layers.py:76-204``).

    Each user's interest DRIFTS mid-history: items before a changepoint come
    from topic A, items after it from topic B (oldest-first, post-padded, so
    the most recent real item sits at position ``len-1``). The target is

    * **positive** — drawn from the RECENT topic B,
    * **hard negative** (``hard_neg_frac`` of negatives) — drawn from the
      STALE topic A: topic-match against the history *bag* is identical to a
      positive; only the segment's position in time tells them apart,
    * **easy negative** — drawn from a topic in neither segment.

    Mean pooling (BASE) and attention pooling (DIN) are permutation-invariant
    in the history, so on hard negatives they are capped at the weak
    segment-mass signal (the changepoint is uniform in the middle half, so
    topic-B mass spans 25–75%); a recurrence (DIEN's GRU→AUGRU) can read the
    order and separate them. Distractor noise (``noise`` per position) is
    what DIN's attention filters but BASE's mean dilutes — the DIN-over-BASE
    margin. Expected ordering: BASE < DIN << DIEN, with the DIEN gap set by
    ``hard_neg_frac``.

    ``oracle_aucs`` computes the two planted ceilings (bag-match vs recency)
    so tests can certify the mechanism without training anything.

    Items are assigned to topics round-robin (item i>0 → topic (i-1) % P) so
    sampling vectorizes; categories correlate with topics as in
    ``SyntheticSequence``. Schema matches ``dien/data_loader.py:35-63``.
    """

    num_items: int = 20_000
    num_cats: int = 200
    max_len: int = 50
    num_topics: int = 8
    noise: float = 0.2
    hard_neg_frac: float = 0.5
    seed: int = 0

    def __post_init__(self):
        assert self.num_topics >= 3, "easy negatives need a third topic"
        rng = np.random.default_rng(self.seed)
        P = self.num_topics
        self.pool_size = (self.num_items - 1) // P
        idx = np.arange(self.num_items)
        self.item_topic = ((idx - 1) % P).astype(np.int32)
        self.item_topic[0] = -1  # pad row
        cats_per_topic = max((self.num_cats - 1) // P, 1)
        self.item_cat = np.clip(
            1
            + self.item_topic * cats_per_topic
            + rng.integers(0, cats_per_topic, size=self.num_items),
            1,
            self.num_cats - 1,
        ).astype(np.int32)
        self.item_cat[0] = 0

    def _item_from_topic(self, topic, rng):
        k = rng.integers(0, self.pool_size, size=topic.shape)
        return (1 + topic + self.num_topics * k).astype(np.int32)

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        P, T = self.num_topics, self.max_len
        A = rng.integers(0, P, size=n)
        B = (A + rng.integers(1, P, size=n)) % P  # drift target, != A
        ln = rng.integers(T // 2, T + 1, size=n)
        cut = np.clip(
            (ln * rng.uniform(0.25, 0.75, size=n)).astype(np.int64), 1, ln - 1
        )
        pos_grid = np.arange(T)[None, :]
        valid = pos_grid < ln[:, None]
        recent = pos_grid >= cut[:, None]
        topic_mat = np.where(recent, B[:, None], A[:, None])
        his_item = self._item_from_topic(topic_mat, rng)
        distract = rng.random((n, T)) < self.noise
        his_item = np.where(
            distract, rng.integers(1, self.num_items, size=(n, T)), his_item
        )
        his_item = np.where(valid, his_item, 0).astype(np.int32)
        his_cat = self.item_cat[his_item]

        label = (rng.random(n) < 0.5).astype(np.float32)
        hard = rng.random(n) < self.hard_neg_frac
        # easy-negative topic: uniform over the P-2 topics that are neither A
        # nor B (order-free insertion trick, valid because A != B)
        e = rng.integers(0, P - 2, size=n)
        lo, hi = np.minimum(A, B), np.maximum(A, B)
        e = e + (e >= lo)
        e = e + (e >= hi)
        tgt_topic = np.where(label > 0, B, np.where(hard, A, e))
        target_item = self._item_from_topic(tgt_topic, rng)
        target_cat = self.item_cat[target_item]

        neg_item = np.where(
            valid, rng.integers(1, self.num_items, size=(n, T)), 0
        ).astype(np.int32)
        return {
            "target_item": target_item,
            "target_cat": target_cat,
            "pos_his_item": his_item,
            "pos_his_cat": his_cat,
            "neg_his_item": neg_item,
            "neg_his_cat": self.item_cat[neg_item],
            "label": label,
        }

    def oracle_aucs(self, batch: dict) -> dict:
        """AUCs of the two planted-mechanism oracles on a sampled batch.

        * ``bag`` — fraction of (valid) history items whose topic matches the
          target's: the sufficient statistic any permutation-invariant pooler
          (BASE's mean, DIN's attention sum) can extract. High on easy
          negatives, weak on hard ones.
        * ``recency`` — topic-match fraction of the LAST ``k`` real
          positions: what an order-aware model reads. Separates hard
          negatives too.

        The gap between them is the planted DIEN headroom; tests assert it.
        """
        his = batch["pos_his_item"]
        valid = his != 0
        his_topic = self.item_topic[his]
        tgt_topic = self.item_topic[batch["target_item"]][:, None]
        match = (his_topic == tgt_topic) & valid
        bag = match.sum(1) / np.maximum(valid.sum(1), 1)
        # last-5-positions match fraction (vectorized tail gather)
        ln = valid.sum(1)
        k = 5
        tail_pos = np.clip(
            ln[:, None] - 1 - np.arange(k)[None, :], 0, his.shape[1] - 1
        )
        tail_match = np.take_along_axis(match, tail_pos, axis=1)
        recency = tail_match.mean(1)
        from recommender_tpu_torch.core.metrics import exact_auc

        return {
            "bag": float(exact_auc(bag.astype(np.float64), batch["label"])),
            "recency": float(
                exact_auc(recency.astype(np.float64), batch["label"])
            ),
        }


@dataclasses.dataclass
class SyntheticMultiInterest:
    """Unordered MULTI-interest histories where the label is fine-grained
    set membership — the regime that separates DIN from BASE (the middle
    link of the reference's mechanism ladder, ``dien/layers.py:76-204``).

    Each user follows ``hist_cats`` distinct categories (a random subset of
    the ``num_cats-1`` real ones), one history item per category. The
    target is **positive** iff its category is one of the user's — so the
    permutation-invariant *membership* oracle is a PERFECT classifier
    (AUC 1.0 for BASE, DIN and DIEN alike; contrast ``SyntheticInterestDrift``
    where the poolers' ceiling is informational). What separates the
    architectures is the BOTTLENECK: BASE must detect a 1-of-``hist_cats``
    component inside a ``cat_dim``-dimensional MEAN, where the other
    ``hist_cats-1`` embeddings are interference (per-position SNR
    ~ sqrt(cat_dim)/sqrt(hist_cats) for random tables — well below
    separability at 50/18); DIN's LocalActivationUnit sees the
    ``target*his`` elementwise product PER POSITION before pooling
    (``nn/sequence.py``), so match detection happens before the mean
    dilutes it. Items round-robin over categories so sampling vectorizes;
    schema matches ``dien/data_loader.py:35-63`` like the other sequence
    generators.

    ``oracle_aucs`` reports the membership ceiling (1.0 by construction)
    and the MEAN-READOUT proxy — AUC of ``e_target · mean(history)`` under
    a random fixed table — the quantitative form of BASE's handicap.
    """

    num_items: int = 20_000
    num_cats: int = 200
    max_len: int = 50
    hist_cats: int = 50
    seed: int = 0

    def __post_init__(self):
        C = self.num_cats - 1  # real categories (row 0 = pad)
        assert self.hist_cats <= self.max_len <= C
        # hist_cats == C leaves no negative pool (sample's integers(K, C)
        # raises 'low >= high'); num_items-1 < C gives items_per_cat == 0
        # and breaks _item_from_cat (advisor r4)
        assert self.hist_cats < C, "need at least one non-interest category"
        assert self.num_items - 1 >= C, "need at least one item per category"
        self.items_per_cat = (self.num_items - 1) // C
        idx = np.arange(self.num_items)
        self.item_cat = (1 + (idx - 1) % C).astype(np.int32)
        self.item_cat[0] = 0

    def _item_from_cat(self, cat, rng):
        """Uniform item within category (cats are 1-based round-robin)."""
        k = rng.integers(0, self.items_per_cat, size=cat.shape)
        return ((cat - 1) + (self.num_cats - 1) * k + 1).astype(np.int32)

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        C, T, K = self.num_cats - 1, self.max_len, self.hist_cats
        # per-user random permutation of the real cats: first K = the
        # user's interest set, the rest = the negative pool
        perm = rng.permuted(
            np.tile(np.arange(1, C + 1), (n, 1)), axis=1
        ).astype(np.int32)
        his_cat = np.zeros((n, T), np.int32)
        his_cat[:, :K] = perm[:, :K]
        his_item = np.where(
            his_cat > 0, self._item_from_cat(his_cat, rng), 0
        ).astype(np.int32)

        label = (rng.random(n) < 0.5).astype(np.float32)
        pos_col = rng.integers(0, K, size=n)
        neg_col = rng.integers(K, C, size=n)
        rows = np.arange(n)
        tgt_cat = np.where(label > 0, perm[rows, pos_col], perm[rows, neg_col])
        target_item = self._item_from_cat(tgt_cat, rng)

        valid = np.arange(T)[None, :] < K
        neg_item = np.where(
            valid, rng.integers(1, self.num_items, size=(n, T)), 0
        ).astype(np.int32)
        return {
            "target_item": target_item,
            "target_cat": tgt_cat.astype(np.int32),
            "pos_his_item": his_item,
            "pos_his_cat": his_cat,
            "neg_his_item": neg_item,
            "neg_his_cat": self.item_cat[neg_item],
            "label": label,
        }

    def oracle_aucs(self, batch: dict, dim: int = 18) -> dict:
        """Planted ceilings: exact set membership (1.0 by construction —
        shared by all three architectures) and the mean-readout proxy
        (``e_tgt · mean(his)`` under a fixed random ``dim``-d table): what a
        bilinear readout of BASE's pooled representation can see through
        the interference of the other ``hist_cats-1`` embeddings."""
        from recommender_tpu_torch.core.metrics import exact_auc

        his_cat = batch["pos_his_cat"]
        valid = his_cat != 0
        member = (his_cat == batch["target_cat"][:, None]) & valid
        membership = member.any(1).astype(np.float64)

        rng = np.random.default_rng(self.seed + 1)
        table = rng.standard_normal((self.num_cats, dim)) / np.sqrt(dim)
        table[0] = 0.0
        pooled = table[his_cat].sum(1) / np.maximum(
            valid.sum(1, keepdims=True), 1
        )
        readout = np.einsum("nd,nd->n", table[batch["target_cat"]], pooled)
        return {
            "membership": float(exact_auc(membership, batch["label"])),
            "mean_readout": float(exact_auc(readout, batch["label"])),
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
