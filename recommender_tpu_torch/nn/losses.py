"""Losses: port of ``recommender_tpu/nn/losses.py`` (the BCE pair).

Both return **per-example** losses, so callers control batch scaling.
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
