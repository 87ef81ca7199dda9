"""Behavior-sequence layers.

Port of ``recommender_tpu/nn/sequence.py``: so far only ``masked_mean_pool``,
the readout of BST. ``LocalActivationUnit``, ``AuxiliaryNet`` and
``DIENAttention`` come with the DIN/DIEN slice.
"""
from __future__ import annotations

import torch


def masked_mean_pool(his: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, T] → [B, D]: average over real (unmasked) steps; an
    all-pad history pools to zeros (the count is clamped to at least 1)."""
    m = mask.to(his.dtype)[..., None]  # [B, T, 1]
    s = torch.sum(his * m, dim=1)
    n = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return s / n
