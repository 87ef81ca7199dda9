"""Losses: port of ``recommender_tpu/nn/losses.py`` (the BCE pair, the
sampled-softmax mean, PinSage's margin loss and DIEN's masked auxiliary
loss).

All return **per-example** losses, so callers control batch scaling.
"""
from __future__ import annotations

import torch

EPS = 1e-7


def binary_cross_entropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities in (0,1). Matches keras BinaryCrossentropy."""
    p = torch.clamp(probs, EPS, 1.0 - EPS)
    labels = labels.to(p.dtype)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable sigmoid CE (tf.nn.sigmoid_cross_entropy_with_logits)."""
    labels = labels.to(logits.dtype)
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits))
    )


def sampled_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid-CE over the candidate axis: [B, 1+k] logits/labels → [B]."""
    return torch.mean(bce_with_logits(logits, labels), dim=-1)


def margin_loss(
    pos_score: torch.Tensor, neg_score: torch.Tensor, delta: float = 1.0
) -> torch.Tensor:
    """Max-margin: max(0, neg + delta - pos), per example."""
    return torch.clamp(neg_score + delta - pos_score, min=0.0)


def masked_auxiliary_loss(
    pos_logits: torch.Tensor,  # [B, T-1]
    neg_logits: torch.Tensor,  # [B, T-1]
    mask: torch.Tensor,  # [B, T-1] (1 = real step)
) -> torch.Tensor:
    """DIEN auxiliary loss: per-example mean over valid steps of
    BCE(pos→1) and BCE(neg→0). Returns [B]; a row with no valid step gives 0
    (the denominator is ``max(2·Σmask, 1)``)."""
    m = mask.to(torch.float32)
    pos_l = bce_with_logits(pos_logits, torch.ones_like(pos_logits)) * m
    neg_l = bce_with_logits(neg_logits, torch.zeros_like(neg_logits)) * m
    denom = torch.clamp(torch.sum(m, dim=-1) * 2.0, min=1.0)
    return (torch.sum(pos_l, dim=-1) + torch.sum(neg_l, dim=-1)) / denom
