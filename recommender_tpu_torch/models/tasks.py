"""Task wrappers: bind a model to the Trainer's (loss_fn, eval_fn) protocol.

Port of ``recommender_tpu/models/tasks.py`` (``init_model``,
``make_ctr_task``, ``make_aux_loss_task``, ``make_multitask_task``,
``make_head_eval``, ``evaluate_head``, ``make_skipgram_task``,
``link_prediction_auc``, and ``pop_diagnostics`` for ``_pop_diagnostics``).
The JAX functions take ``(params, model_state, batch, rng, train)``; a
torch module holds its own parameters, and its mutable state (BatchNorm's running stats, flax's ``batch_stats``) as buffers that
its forward updates in ``train()`` mode. The models of the port use no
randomness at train time, so here

* ``loss_fn(batch, train) -> (per_example_loss [B], aux dict)``
* ``eval_fn(batch) -> (scores [B], labels [B])``

close over the model.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.core.metrics import AUCState, auc_from_state, auc_update, exact_auc
from recommender_tpu_torch.nn.losses import binary_cross_entropy, sampled_sigmoid_ce


def pop_diagnostics(model: nn.Module, aux: dict) -> dict:
    """Move the diagnostics a training forward left on the model's tables
    into the step's metrics: ``a2a_overflow``, the ids served a 0 vector by
    the all-to-all exchange, summed over the tables that take it (JAX's
    sown ``diagnostics`` collection). ``aux`` is unchanged where no table
    takes that exchange."""
    total = None
    for module in model.modules():
        dropped = getattr(module, "a2a_overflow", None)
        if dropped is not None:
            total = dropped if total is None else total + dropped
            module.a2a_overflow = None
    if total is not None:
        aux["a2a_overflow"] = total
    return aux


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
        return per_ex, pop_diagnostics(model, aux)

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
        return per_ex, pop_diagnostics(model, {"aux_loss": torch.mean(aux_loss.detach())})

    def eval_fn(batch):
        model.eval()
        prob, _ = model(batch)
        return prob, batch["label"]

    return loss_fn, eval_fn


def make_multitask_task(model: nn.Module) -> tuple[Callable, Callable]:
    """ESMM / MMOE joint training: the mean of BCE(ctr head, click) and
    BCE(ctcvr head, purchase); the eval scores the ctcvr head."""

    def loss_fn(batch, train):
        model.train(train)
        heads = model(batch)
        l_ctr = binary_cross_entropy(heads["ctr"], batch["click"])
        l_ctcvr = binary_cross_entropy(heads["ctcvr"], batch["purchase"])
        aux = {"ctr_loss": torch.mean(l_ctr.detach()),
               "ctcvr_loss": torch.mean(l_ctcvr.detach())}
        return 0.5 * (l_ctr + l_ctcvr), pop_diagnostics(model, aux)

    def eval_fn(batch):
        model.eval()
        return model(batch)["ctcvr"], batch["purchase"]

    return loss_fn, eval_fn


def make_head_eval(model: nn.Module, head: str, label_key: str) -> Callable:
    """An eval fn scoring one named head of a dict-output model against a
    label: the CVR-on-clicks and CTCVR-on-impressions evals."""

    def eval_fn(batch):
        model.eval()
        return model(batch)[head], batch[label_key]

    return eval_fn


@torch.no_grad()
def evaluate_head(trainer, state, batches: Iterable, head_eval_fn: Callable,
                  exact: bool = False) -> float:
    """One AUC over ``batches`` with a custom ``(scores, labels)`` fn: the
    streaming histogram on the device, summed over the trainer's data
    group, or with ``exact=True`` (one data rank) the sort-based exact AUC
    of the scores gathered to the host. ``state`` is unused (the model holds
    its params); it stays for the JAX signature."""
    del state
    mesh = trainer.mesh
    auc = AUCState.init(device=trainer.device)
    all_s, all_l = [], []
    for batch in batches:
        scores, labels = head_eval_fn(trainer.put_batch(batch))
        auc = auc_update(auc, scores, labels)
        if exact:
            all_s.append(scores.reshape(-1).cpu().numpy())
            all_l.append(labels.reshape(-1).cpu().numpy())
    if exact and mesh.data == 1:
        return float(exact_auc(np.concatenate(all_s), np.concatenate(all_l)))
    if mesh.data > 1:
        both = distributed.all_reduce(torch.cat([auc.pos, auc.neg]), group=mesh.data_group)
        auc = AUCState(*both.chunk(2))
    return float(auc_from_state(auc))


def make_skipgram_task(model: nn.Module) -> tuple[Callable, Callable]:
    """EGES-family sampled-softmax training: model(batch) → logits
    [B, 1+k], per-example loss the mean sigmoid CE against
    ``batch['label']``. The eval returns flattened [B·(1+k)] scores and
    labels."""

    def loss_fn(batch, train):
        model.train(train)
        logits = model(batch)
        return sampled_sigmoid_ce(logits, batch["label"]), pop_diagnostics(model, {})

    def eval_fn(batch):
        model.eval()
        logits = model(batch)
        return torch.sigmoid(logits.reshape(-1)), batch["label"].reshape(-1)

    return loss_fn, eval_fn


@torch.no_grad()
def link_prediction_auc(model: nn.Module, triples: dict, batch_size: int = 4096,
                        exact: bool = True) -> float:
    """Link prediction: score held-out edges and negatives by
    sigmoid(hidden_q · hidden_x) through ``model.get_hidden``, AUC of
    positives against negatives. ``triples``: host arrays ``query``,
    ``pos``, ``neg`` (and ``<role>_cat`` / ``<role>_brand`` for side info).
    ``exact=True`` (the default) is the sort-based exact AUC on the host;
    ``exact=False`` the streaming histogram on the device."""
    device = next(model.parameters()).device
    model.eval()

    def hidden_for(role, batch):
        sub = {"target": batch[role]}
        for k, v in batch.items():
            if k.startswith(f"{role}_"):
                sub["target_" + k[len(role) + 1:]] = v
        return model.get_hidden(sub)

    auc = AUCState.init(device=device)
    all_pos, all_neg = [], []
    total = len(triples["query"])
    for s in range(0, total, batch_size):
        batch = {k: torch.as_tensor(np.asarray(v[s:s + batch_size])).to(device)
                 for k, v in triples.items()}
        q = hidden_for("query", batch)
        pos = torch.sigmoid(torch.sum(q * hidden_for("pos", batch), dim=-1))
        neg = torch.sigmoid(torch.sum(q * hidden_for("neg", batch), dim=-1))
        if exact:
            all_pos.append(pos.cpu().numpy())
            all_neg.append(neg.cpu().numpy())
        else:
            auc = auc_update(auc, pos, torch.ones_like(pos))
            auc = auc_update(auc, neg, torch.zeros_like(neg))
    if not exact:
        return float(auc_from_state(auc))
    pos, neg = np.concatenate(all_pos), np.concatenate(all_neg)
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
    return float(exact_auc(scores, labels))
