"""Streaming metrics (AUC, accuracy, mean) accumulated on the device.

Port of ``recommender_tpu/core/metrics.py``. The metric state is a tiny
tuple of tensors that lives on the device beside the model, is updated
inside the eval loop without a host round trip, and is finalized with a
closed-form trapezoid. ``exact_auc`` is the host numpy computation, copied
unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_BINS = 8192


class AUCState(NamedTuple):
    """Histogram sufficient statistics for ROC-AUC."""

    pos: torch.Tensor  # [bins] weight of positive examples per score bin
    neg: torch.Tensor  # [bins] weight of negative examples per score bin

    @staticmethod
    def init(bins: int = DEFAULT_BINS, dtype=torch.float32, device=None) -> "AUCState":
        z = torch.zeros((bins,), dtype=dtype, device=device)
        return AUCState(pos=z, neg=z.clone())

    def merge(self, other: "AUCState") -> "AUCState":
        return AUCState(self.pos + other.pos, self.neg + other.neg)


def auc_update(
    state: AUCState,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> AUCState:
    """Accumulate a batch of ``scores`` in [0, 1] against binary ``labels``."""
    bins = state.pos.shape[0]
    scores = scores.reshape(-1).to(torch.float32)
    labels = labels.reshape(-1).to(torch.float32)
    w = torch.ones_like(scores) if weights is None else weights.reshape(-1).to(torch.float32)
    idx = torch.clamp((scores * bins).to(torch.int32), 0, bins - 1)
    pos = state.pos.index_add(0, idx, labels * w)
    neg = state.neg.index_add(0, idx, (1.0 - labels) * w)
    return AUCState(pos, neg)


def auc_from_state(state: AUCState) -> torch.Tensor:
    """Closed-form ROC-AUC from score histograms:
    P(score_pos > score_neg) + 0.5 * P(tie) on the binned distribution."""
    pos, neg = state.pos, state.neg
    total_pos = torch.sum(pos)
    total_neg = torch.sum(neg)
    neg_below = torch.cumsum(neg, 0) - neg  # neg mass strictly below each bin
    wins = torch.sum(pos * neg_below)
    ties = torch.sum(pos * neg)
    denom = torch.clamp(total_pos * total_neg, min=1.0)
    return (wins + 0.5 * ties) / denom


class MeanState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(dtype=torch.float32, device=None) -> "MeanState":
        return MeanState(
            torch.zeros((), dtype=dtype, device=device),
            torch.zeros((), dtype=dtype, device=device),
        )

    def merge(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)


def mean_update(state: MeanState, values: torch.Tensor, weights=None) -> MeanState:
    values = values.reshape(-1).to(torch.float32)
    w = torch.ones_like(values) if weights is None else weights.reshape(-1)
    return MeanState(state.total + torch.sum(values * w), state.count + torch.sum(w))


def mean_from_state(state: MeanState) -> torch.Tensor:
    return state.total / torch.clamp(state.count, min=1.0)


def accuracy_update(
    state: MeanState, scores: torch.Tensor, labels: torch.Tensor, threshold=0.5
) -> MeanState:
    pred = (scores.reshape(-1) >= threshold).to(torch.float32)
    correct = (pred == labels.reshape(-1).to(torch.float32)).to(torch.float32)
    return mean_update(state, correct)


def exact_auc(scores, labels, weights=None) -> float:
    """Exact (sort-based, tie-averaged) ROC-AUC on the host.

    The histogram ``AUCState`` (8192 bins, error ≲2e-3) is fine for in-loop
    eval but too coarse to certify small separations, so final evals gather
    scores to the host and compute the exact Mann-Whitney U statistic:

        AUC = (Σ_pos rank_avg − P(P+1)/2) / (P·N)

    with average ranks over ties. O(n log n).
    """
    s = np.asarray(scores, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1) > 0.5
    w = None if weights is None else np.asarray(weights, np.float64).reshape(-1)
    if w is None:
        _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
        cum = np.cumsum(counts)
        avg_rank = (cum - counts + 1 + cum) / 2.0  # 1-based average rank
        r = avg_rank[inv]
        p = float(y.sum())
        n = float(y.size - p)
        if p == 0 or n == 0:
            return 0.5
        u = float(r[y].sum()) - p * (p + 1) / 2.0
        return u / (p * n)
    # weighted: P(s_pos > s_neg) + 0.5 P(tie) over example weights
    order = np.argsort(s, kind="mergesort")
    s, y, w = s[order], y[order], w[order]
    wp = np.where(y, w, 0.0)
    wn = np.where(y, 0.0, w)
    # group ties: boundaries where the score changes
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] != s[:-1]
    gid = np.cumsum(new) - 1
    gp = np.bincount(gid, weights=wp)
    gn = np.bincount(gid, weights=wn)
    neg_below = np.cumsum(gn) - gn
    p, n = wp.sum(), wn.sum()
    if p == 0 or n == 0:
        return 0.5
    return float((gp * neg_below).sum() + 0.5 * (gp * gn).sum()) / (p * n)


class StreamingAUC:
    """Stateful wrapper mirroring ``keras.metrics.AUC`` usage:
    ``update_state`` accumulates on the scores' device, ``result``
    finalizes, ``reset_state`` starts over."""

    def __init__(self, bins: int = DEFAULT_BINS, device=None):
        self._bins = bins
        self._device = device
        self._state = AUCState.init(bins, device=device)

    def update_state(self, labels, scores, weights=None) -> None:
        self._state = auc_update(
            self._state,
            torch.as_tensor(scores, device=self._state.pos.device),
            torch.as_tensor(labels, device=self._state.pos.device),
            None if weights is None else torch.as_tensor(weights, device=self._state.pos.device),
        )

    def result(self) -> float:
        return float(auc_from_state(self._state))

    def reset_state(self) -> None:
        self._state = AUCState.init(self._bins, device=self._device)
