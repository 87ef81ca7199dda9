"""Task wrappers: bind a model to the Trainer's (loss_fn, eval_fn) protocol.

Port of ``recommender_tpu/models/tasks.py`` (``init_model``,
``make_ctr_task``, ``make_aux_loss_task``). The JAX functions take ``(params, model_state, batch,
rng, train)``; a torch module holds its own parameters, and its mutable
state (BatchNorm's running stats, flax's ``batch_stats``) as buffers that
its forward updates in ``train()`` mode. The models of the port use no
randomness at train time, so here

* ``loss_fn(batch, train) -> (per_example_loss [B], aux dict)``
* ``eval_fn(batch) -> (scores [B], labels [B])``

close over the model.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from recommender_tpu_torch.nn.losses import binary_cross_entropy


def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Re-draw the model's parameters from a ``torch.Generator`` seeded with
    ``seed``, on the parameters' device, and reset its running stats. The
    draws differ from
    ``jax.random``'s for the same seed; ``convert.py`` carries a JAX init
    over exactly."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    model.reset_parameters(generator)
    return model


def make_ctr_task(model: nn.Module) -> tuple[Callable, Callable]:
    """Binary CTR on ``batch['label']`` with model(batch) → prob [B]."""

    def loss_fn(batch, train):
        model.train(train)
        prob = model(batch)
        per_ex = binary_cross_entropy(prob, batch["label"])
        aux = {"prob_mean": torch.mean(prob.detach())}
        return per_ex, aux

    def eval_fn(batch):
        model.eval()
        prob = model(batch)
        return prob, batch["label"]

    return loss_fn, eval_fn


def make_aux_loss_task(model: nn.Module, aux_weight: float = 1.0) -> tuple[Callable, Callable]:
    """CTR where model(batch) → (prob [B], per-example aux loss [B]) — DIEN."""

    def loss_fn(batch, train):
        model.train(train)
        prob, aux_loss = model(batch)
        per_ex = binary_cross_entropy(prob, batch["label"]) + aux_weight * aux_loss
        return per_ex, {"aux_loss": torch.mean(aux_loss.detach())}

    def eval_fn(batch):
        model.eval()
        prob, _ = model(batch)
        return prob, batch["label"]

    return loss_fn, eval_fn
