"""Behavior-sequence CTR models: the shared base of the BASE/DIN/DIEN/BST family.

Port of ``recommender_tpu/models/dien.py::SequenceBase``: the shared item
and category tables (id 0 = pad), ``embed`` (the two lookups concatenated
per step, cast to f32), ``embed_sets`` on its default per-set path, and
``head`` (the input-BatchNorm MLP with a sigmoid). ``BaseModel``, ``DIN``
and ``DIEN`` come with their slice.

Not ported yet, and raising ``NotImplementedError``: ``shared_gather=True``
(one gather per table for all id sets), row-sharded tables (``partition``),
a ``lookup_mode`` other than the default, and ``mesh``.

Batch schema (``dien/data_loader.py``): target_item, target_cat,
pos_his_item, pos_his_cat, [neg_his_item, neg_his_cat], label; histories
post-padded with 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.mlp import MLP


class SequenceBase(nn.Module):
    """Shared embeddings + helpers for the sequence family. Train or eval
    mode of the head's BatchNorm follows the module's ``train()`` mode."""

    def __init__(
        self,
        item_vocab: int,
        cat_vocab: int,
        item_dim: int = 18,
        cat_dim: int = 18,
        mlp_units: Sequence[int] = (200, 80, 1),
        partition: Optional[str] = None,
        lookup_mode: str = "gspmd",
        mesh: Optional[object] = None,
        shared_gather: bool = False,
        embed_param_dtype: torch.dtype = torch.float32,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if shared_gather:
            raise NotImplementedError("shared_gather=True is not ported yet")
        if mesh is not None:
            raise NotImplementedError("a mesh (sharded-table exchanges) is not ported yet")
        self.dim = item_dim + cat_dim
        self.item_embedding = Embedding(
            item_vocab, item_dim, partition=partition, lookup_mode=lookup_mode,
            param_dtype=embed_param_dtype, device=device, generator=generator,
        )
        self.cat_embedding = Embedding(
            cat_vocab, cat_dim, partition=partition, lookup_mode=lookup_mode,
            param_dtype=embed_param_dtype, device=device, generator=generator,
        )
        # head input: [target ∥ history representation], each `dim` wide
        self.mlp = MLP(
            2 * self.dim, mlp_units, final_activation=torch.sigmoid,
            input_batch_norm=True, device=device, generator=generator,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.item_embedding.reset_parameters(generator)
        self.cat_embedding.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def embed(self, item: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
        """[*ids.shape] item and cat ids → [*ids.shape, item_dim + cat_dim]
        f32 (bf16 tables: the gathered rows are upcast, and the cast's
        backward rounds the cotangent to bf16 before the scatter)."""
        out = torch.cat([self.item_embedding(item), self.cat_embedding(cat)], dim=-1)
        return out.to(torch.float32)

    def embed_sets(self, items, cats) -> list[torch.Tensor]:
        """Embed several (item_ids, cat_ids) sets — [B] target, [B, T]
        histories — with one lookup per table and set."""
        return [self.embed(i, c) for i, c in zip(items, cats)]

    def head(self, target_emb: torch.Tensor, history_repr: torch.Tensor) -> torch.Tensor:
        prob = self.mlp(torch.cat([target_emb, history_repr], dim=-1))
        return torch.squeeze(prob, dim=-1)
