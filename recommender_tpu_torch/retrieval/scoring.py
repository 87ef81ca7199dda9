"""Offline batch scoring for ranking models (DLRM, DeepFM, DCN, DIN, DIEN, BST).

Port of ``recommender_tpu/retrieval/scoring.py``: restore a training
checkpoint, then stream fixed-size feature batches through the model's
eval forward (``cli/predict.py`` is the entry point). The last partial
batch is padded up to the batch size by repeating its last row and sliced
back, as in JAX, so every call sees one shape.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn


def make_scorer(model: nn.Module) -> Callable[[dict], object]:
    """``host batch -> scores``: the model in eval mode under
    ``torch.no_grad``, each batch copied to the device of the model's
    params. The model's output passes through unchanged: [B] probs for CTR
    models, ``(prob, aux)`` for DIEN."""
    device = next(model.parameters()).device
    model.eval()

    @torch.no_grad()
    def score(batch: dict):
        return model({k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()})

    return score


def score_batches(
    scorer: Callable,
    batches: Iterable[dict],
    batch_size: int,
) -> dict[str, np.ndarray]:
    """Run ``scorer`` over host batches; returns the stacked score arrays
    (``{"score": [N]}`` for a model with one head)."""
    chunks: dict[str, list[np.ndarray]] = {}
    for batch in batches:
        n = len(next(iter(batch.values())))
        if n < batch_size:
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)])
                for k, v in batch.items()
            }
        out = scorer(batch)
        if isinstance(out, tuple):  # DIEN returns (prob, aux_loss): keep prob
            out = out[0]
        if not isinstance(out, dict):
            out = {"score": out}
        for k, v in out.items():
            chunks.setdefault(k, []).append(v.cpu().numpy()[:n])
    return {k: np.concatenate(v) for k, v in chunks.items()}
