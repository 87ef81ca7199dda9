"""Two-tower retrieval — in-batch-softmax dual encoders.

Port of ``recommender_tpu/models/two_tower.py`` (replicated tables), with the
flax names (``user_embedding``, ``item_embedding``, ``cat_embedding``,
``user_tower``, ``item_tower``), so ``convert.py`` maps a JAX init one to
one. Each table is an ``Embedding`` whose backward is the sorted
scatter-add kernel (K1): a step launches it twice (three times with
``cat_vocab``). The towers are ``MLP``s computing in bf16, as JAX's.

The item tower exports a corpus exactly like PinSage's reprs
(``corpus_item_reprs`` → ``retrieval.export``), and the user tower gives
the query vectors (``retrieval.eval.recommend_topk_from_queries``).

Loss: softmax cross-entropy on the similarity matrix of the user reprs
against every item repr of the global batch, the matching item as the
label, temperature-scaled; per example. The JAX package's data-parallel
run gets the global batch's item reprs from XLA's all-gather; here, on a
mesh with a data axis wider than 1, ``make_two_tower_task`` all-gathers
them over the data group explicitly (``_GatherRows``, whose backward is a
reduce-scatter sum of the cotangent), so rank ``r``'s logits are
``[B_local, B_global]`` with its labels at ``r * B_local + i``. N ranks of
``B/N`` rows give one rank's loss and gradients at ``B``
(``tests/test_torch_two_tower.py``).

``partition``, ``lookup_mode``, ``mesh`` and ``capacity_factor`` go to the
three tables (``embedding.table.Embedding``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.models.tasks import pop_diagnostics
from recommender_tpu_torch.nn.mlp import MLP


class TwoTower(nn.Module):
    def __init__(self, user_vocab: int, item_vocab: int, cat_vocab: int = 0,
                 embed_dim: int = 32, repr_dim: int = 32, tower_units: Sequence[int] = (64,),
                 temperature: float = 0.05, partition: Optional[str] = None,
                 lookup_mode: str = "gspmd", embed_param_dtype: torch.dtype = torch.float32,
                 mesh=None, capacity_factor: float = 2.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cat_vocab = cat_vocab
        self.temperature = temperature
        self.mesh = mesh
        kw = dict(partition=partition, lookup_mode=lookup_mode, param_dtype=embed_param_dtype,
                  mesh=mesh, capacity_factor=capacity_factor, device=device,
                  generator=generator)
        self.user_embedding = Embedding(user_vocab, embed_dim, **kw)
        self.item_embedding = Embedding(item_vocab, embed_dim, **kw)
        if cat_vocab:
            self.cat_embedding = Embedding(cat_vocab, embed_dim, **kw)
        units = (*tower_units, repr_dim)
        item_in = embed_dim * (2 if cat_vocab else 1)
        self.user_tower = MLP(embed_dim, units, device=device, generator=generator)
        self.item_tower = MLP(item_in, units, device=device, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name in ("user_embedding", "item_embedding", "cat_embedding",
                     "user_tower", "item_tower"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)

    @staticmethod
    def _unit(r: torch.Tensor) -> torch.Tensor:
        return r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-6)

    def user_repr(self, user_id: torch.Tensor) -> torch.Tensor:
        """[B] user ids → [B, repr_dim], L2-normalized (cosine scoring)."""
        x = self.user_embedding(user_id).to(torch.float32)
        return self._unit(self.user_tower(x))

    def item_repr(self, item_id: torch.Tensor,
                  item_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.item_embedding(item_id).to(torch.float32)
        if self.cat_vocab:
            if item_cat is None:
                raise ValueError("model built with cat_vocab: item_cat is required")
            x = torch.cat([x, self.cat_embedding(item_cat).to(torch.float32)], dim=-1)
        return self._unit(self.item_tower(x))

    def forward(self, batch: dict):
        return self.user_repr(batch["user_id"]), self.item_repr(batch["item_id"],
                                                                batch.get("item_cat"))


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows, concatenated in data order; the backward
    sums the cotangent over the ranks and keeps this rank's block (a
    reduce-scatter), since each rank's loss reads every rank's rows."""

    @staticmethod
    def forward(ctx, rows, group, n):
        ctx.group, ctx.n = group, n
        out = torch.empty((rows.shape[0] * n, *rows.shape[1:]), dtype=rows.dtype,
                          device=rows.device)
        return distributed.all_gather_into_tensor(out, rows.contiguous(), group=group)

    @staticmethod
    def backward(ctx, cot):
        out = torch.empty((cot.shape[0] // ctx.n, *cot.shape[1:]), dtype=cot.dtype,
                          device=cot.device)
        return distributed.reduce_scatter_tensor(out, cot.contiguous(), group=ctx.group), None, None


def make_two_tower_task(model: TwoTower):
    """(loss_fn, eval_fn) for the Trainer: in-batch softmax CE against the
    global batch's items (module docstring).

    eval_fn returns (diagonal-is-top1 indicator, ones) — an in-batch
    retrieval accuracy proxy for train-time monitoring; certified quality
    uses the full-corpus hit-rate protocol (``retrieval.eval``) offline."""
    mesh = model.mesh

    def logits_and_labels(batch, train):
        model.train(train)
        u, v = model(batch)
        first = 0
        if mesh is not None and mesh.data > 1:
            v = _GatherRows.apply(v, mesh.data_group, mesh.data)
            first = mesh.data_index * u.shape[0]
        labels = torch.arange(first, first + u.shape[0], device=u.device)
        return (u @ v.T) / model.temperature, labels  # [B_local, B_global]

    def loss_fn(batch, train):
        logits, labels = logits_and_labels(batch, train)
        rows = torch.arange(logits.shape[0], device=logits.device)
        per_ex = -torch.log_softmax(logits, dim=-1)[rows, labels]
        top1 = torch.mean((torch.argmax(logits.detach(), dim=-1) == labels).to(torch.float32))
        return per_ex, pop_diagnostics(model, {"inbatch_top1": top1})

    def eval_fn(batch):
        logits, labels = logits_and_labels(batch, False)
        hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
        return hit, torch.ones_like(hit)

    return loss_fn, eval_fn


def interaction_batches(graph, batch_size: int, seed: int = 0, item_cat=None):
    """Infinite iid stream of (user_id, item_id[, item_cat]) training
    pairs sampled uniformly over a ``BipartiteGraph``'s edges — a copy of
    the JAX function (the same batches for the same seed)."""
    users = np.repeat(
        np.arange(graph.num_users, dtype=np.int32),
        np.diff(graph.u2i_indptr),
    )
    items = graph.u2i_indices.astype(np.int32)
    cats = None if item_cat is None else np.asarray(item_cat, np.int32)
    rng = np.random.default_rng(seed)
    n = len(items)
    while True:
        sel = rng.integers(0, n, batch_size)
        batch = {"user_id": users[sel], "item_id": items[sel]}
        if cats is not None:
            batch["item_cat"] = cats[items[sel]]
        yield batch


@torch.no_grad()
def corpus_item_reprs(model: TwoTower, num_items: int, item_cat=None,
                      batch_size: int = 8192) -> np.ndarray:
    """[V, repr_dim] item-tower corpus — the serving export input
    (``export_serving_bundle``); the eval forward in blocks of
    ``batch_size`` ids on the model's device."""
    device = next(model.parameters()).device
    model.eval()
    out = []
    for s in range(0, num_items, batch_size):
        ids = torch.arange(s, min(s + batch_size, num_items), device=device)
        cats = None if item_cat is None else torch.as_tensor(
            np.asarray(item_cat)[s:s + len(ids)], device=device)
        out.append(model.item_repr(ids, cats).cpu().numpy())
    return np.concatenate(out, axis=0)
