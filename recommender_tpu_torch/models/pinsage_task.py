"""PinSage training glue: batch assembly + margin-loss task.

Port of ``recommender_tpu/models/pinsage_task.py``. ``pinsage_train_batches``
is the host sampler's stream, a copy of the original (the same blocks, bit
for bit, for the same seed); ``make_pinsage_task`` binds the model to the
Trainer's ``loss_fn(batch, train)`` protocol with the margin loss
``max(0, neg + δ - pos)``, δ = 1.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.graph.bipartite import BipartiteGraph, sample_block_batch
from recommender_tpu_torch.models.tasks import pop_diagnostics
from recommender_tpu_torch.nn.losses import margin_loss


def pinsage_train_batches(
    g: BipartiteGraph,
    batch_size: int,
    seed: int = 0,
    **sampler_kw,
) -> Iterator[dict]:
    """Endless {block tensors for [heads; pos; neg]} batches.

    Leakage parity (``data_loader.py:34-39``): each head's sampled frontier
    excludes its pos/neg tail and vice versa."""
    rng = np.random.default_rng(seed)
    while True:
        heads, pos, neg = g.item2item_pairs(batch_size, rng)
        n = len(heads)
        if n < batch_size:  # pad dropped -1 walks to keep shapes static
            extra = batch_size - n
            heads = np.concatenate([heads, heads[:1].repeat(extra)])
            pos = np.concatenate([pos, pos[:1].repeat(extra)])
            neg = np.concatenate([neg, neg[:1].repeat(extra)])
        nodes = np.concatenate([heads, pos, neg]).astype(np.int32)
        exclude = np.concatenate(
            [
                np.stack([pos, neg], axis=1),  # heads exclude their tails
                np.stack([heads, heads], axis=1),  # pos tails exclude head
                np.stack([heads, heads], axis=1),  # neg tails exclude head
            ],
            axis=0,
        )
        block = sample_block_batch(g, nodes, rng, exclude=exclude, **sampler_kw)
        yield block.as_dict()


def make_pinsage_task(model: nn.Module, delta: float = 1.0):
    """``loss_fn(batch, train) -> (per-pair margin loss [B], aux)``, aux the
    batch means of ``pos_score`` and ``neg_score``. There is no eval_fn:
    retrieval quality is the offline hit rate (``retrieval.eval``)."""

    def loss_fn(batch, train):
        model.train(train)
        pos_score, neg_score = model(batch)
        per_ex = margin_loss(pos_score, neg_score, delta)
        aux = {
            "pos_score": torch.mean(pos_score.detach()),
            "neg_score": torch.mean(neg_score.detach()),
        }
        return per_ex, pop_diagnostics(model, aux)

    return loss_fn
