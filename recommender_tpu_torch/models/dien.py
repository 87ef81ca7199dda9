"""Behavior-sequence CTR models: BASE (mean-pool), DIN, DIEN, and the base
they share with BST.

Port of ``recommender_tpu/models/dien.py``:

* ``SequenceBase``: the shared item and category tables (id 0 = pad, masks
  are ``item_id != 0``), ``embed`` (the two lookups concatenated per step,
  cast to f32), ``embed_sets`` (one lookup per table and id set, or with
  ``shared_gather=True`` one per table for all sets of the step), and
  ``head`` (the input-BatchNorm MLP with a sigmoid);
* ``BaseModel``: masked mean-pool of the history ∥ target → head;
* ``DIN``: ``LocalActivationUnit`` attention pooling;
* ``DIEN``: masked GRU interest extractor with the per-step auxiliary loss
  on the positive and negative next items, bilinear attention, AUGRU
  interest evolution; returns ``(prob, aux_loss)``.

Submodules carry the names of flax's ``setup`` (``local_activation_unit``,
``extract_gru``, ``auxiliary_net``, ``attention``, ``evolve``), so
``convert.py`` maps a JAX tree one to one.

``partition``, ``lookup_mode`` and ``mesh`` go to both tables
(``embedding.table.Embedding``), as in JAX.

Batch schema (``dien/data_loader.py``): target_item, target_cat,
pos_his_item, pos_his_cat, [neg_his_item, neg_his_cat], label; histories
post-padded with 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.losses import masked_auxiliary_loss
from recommender_tpu_torch.nn.mlp import MLP
from recommender_tpu_torch.nn.recurrent import AUGRU, GRU
from recommender_tpu_torch.nn.sequence import (
    AuxiliaryNet,
    DIENAttention,
    LocalActivationUnit,
    masked_mean_pool,
)


class SequenceBase(nn.Module):
    """Shared embeddings + helpers for the sequence family. Train or eval
    mode of the head's BatchNorm follows the module's ``train()`` mode.
    ``history_dim`` is the width of the history representation the head
    takes beside the target (default: ``item_dim + cat_dim``)."""

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
        history_dim: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dim = item_dim + cat_dim
        self.shared_gather = shared_gather
        self.item_embedding = Embedding(
            item_vocab, item_dim, partition=partition, lookup_mode=lookup_mode, mesh=mesh,
            param_dtype=embed_param_dtype, device=device, generator=generator,
        )
        self.cat_embedding = Embedding(
            cat_vocab, cat_dim, partition=partition, lookup_mode=lookup_mode, mesh=mesh,
            param_dtype=embed_param_dtype, device=device, generator=generator,
        )
        # head input: [target ∥ history representation]
        self.mlp = MLP(
            self.dim + (self.dim if history_dim is None else history_dim), mlp_units,
            final_activation=torch.sigmoid, input_batch_norm=True, mesh=mesh,
            device=device, generator=generator,
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
        histories — with one lookup per table and set, or under
        ``shared_gather`` one lookup per table over the concatenated ids
        (the same values, and one scatter-add backward per table). Returns
        one [..., item_dim + cat_dim] f32 tensor per input set."""
        if not self.shared_gather:
            return [self.embed(i, c) for i, c in zip(items, cats)]
        emb_i = self.item_embedding(torch.cat([i.reshape(-1) for i in items]))
        emb_c = self.cat_embedding(torch.cat([c.reshape(-1) for c in cats]))
        out, off = [], 0
        for ids in items:
            n = ids.numel()
            rows = torch.cat([emb_i[off : off + n], emb_c[off : off + n]], dim=-1)
            out.append(rows.reshape(*ids.shape, -1).to(torch.float32))
            off += n
        return out

    def head(self, target_emb: torch.Tensor, history_repr: torch.Tensor) -> torch.Tensor:
        prob = self.mlp(torch.cat([target_emb, history_repr], dim=-1))
        return torch.squeeze(prob, dim=-1)


def _history_mask(batch: dict) -> torch.Tensor:
    return (batch["pos_his_item"] != 0).to(torch.float32)  # [B, T]


class BaseModel(SequenceBase):
    def forward(self, batch: dict) -> torch.Tensor:
        target, his = self.embed_sets(
            [batch["target_item"], batch["pos_his_item"]],
            [batch["target_cat"], batch["pos_his_cat"]],
        )  # [B, D], [B, T, D]
        pooled = masked_mean_pool(his, _history_mask(batch))
        return self.head(target, pooled)


class DIN(SequenceBase):
    def __init__(self, *args, device=None, generator: Optional[torch.Generator] = None, **kw):
        super().__init__(*args, device=device, generator=generator, **kw)
        self.local_activation_unit = LocalActivationUnit(
            self.dim, device=device, generator=generator
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        self.local_activation_unit.reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        target, his = self.embed_sets(
            [batch["target_item"], batch["pos_his_item"]],
            [batch["target_cat"], batch["pos_his_cat"]],
        )
        pooled = self.local_activation_unit(target, his, _history_mask(batch))
        return self.head(target, pooled)


class DIEN(SequenceBase):
    """``remat`` rematerializes the recurrences' steps on the backward pass:
    ``None`` = auto, on for T > ``nn.recurrent.REMAT_MIN_T``. The head takes
    ``target ∥ final state``: ``item_dim + cat_dim + evolve_hidden`` wide."""

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
        extract_hidden: int = 36,
        evolve_hidden: int = 36,
        remat: Optional[bool] = None,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            item_vocab, cat_vocab, item_dim, cat_dim, mlp_units, partition,
            lookup_mode, mesh, shared_gather, embed_param_dtype,
            history_dim=evolve_hidden, device=device, generator=generator,
        )
        made = dict(device=device, generator=generator)
        self.extract_gru = GRU(self.dim, extract_hidden, remat=remat, **made)
        # one set of weights, applied to the positive and the negative next items
        self.auxiliary_net = AuxiliaryNet(extract_hidden + self.dim, **made)
        self.attention = DIENAttention(extract_hidden, self.dim, **made)
        self.evolve = AUGRU(extract_hidden, evolve_hidden, remat=remat, **made)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        for part in (self.extract_gru, self.auxiliary_net, self.attention, self.evolve):
            part.reset_parameters(generator)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        mask = _history_mask(batch)
        target, pos_his, neg_his = self.embed_sets(
            [batch["target_item"], batch["pos_his_item"], batch["neg_his_item"]],
            [batch["target_cat"], batch["pos_his_cat"], batch["neg_his_cat"]],
        )  # [B, D], [B, T, D], [B, T, D]

        hidden = self.extract_gru(pos_his, mask)  # [B, T, H]
        # auxiliary loss: h(t) against the positive and negative item at t+1
        h_t = hidden[:, :-1, :]
        pos_logits = self.auxiliary_net(torch.cat([h_t, pos_his[:, 1:, :]], dim=-1))
        neg_logits = self.auxiliary_net(torch.cat([h_t, neg_his[:, 1:, :]], dim=-1))
        aux_loss = masked_auxiliary_loss(pos_logits, neg_logits, mask[:, 1:])

        score = self.attention(target, hidden, mask)  # [B, T, 1]
        final = self.evolve(hidden, score, mask)  # [B, H]
        return self.head(target, final), aux_loss
