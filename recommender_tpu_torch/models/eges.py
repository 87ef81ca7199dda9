"""Graph item-embedding models: DeepWalk (BGE), GES, EGES.

Port of ``recommender_tpu/models/eges.py``:

* ``DeepWalk`` — input and output tables; logits = context rows · hidden
  (the sampled-softmax dot products);
* ``GES``      — hidden = mean of the id, cat and brand rows;
* ``EGES``     — per-item softmax weights over the [id, cat, brand] rows
  from a ``[V, num_side]`` weight table.

Every table is an ``Embedding`` whose backward is the sorted scatter-add
kernel (K1), EGES's 3-wide weight table included. Batch schema (from
``graph.walks.skipgram_batches``): ``target`` [B], ``context`` [B, 1+k]
(1 positive + k negatives), ``label`` [B, 1+k]; GES and EGES add
``target_cat`` / ``target_brand`` [B]. ``get_hidden`` is the item
representation that link prediction and cold-start inference read.
``partition``, ``lookup_mode`` and ``mesh`` go to the big id-keyed tables
(the input or id table and the output table), as in JAX; the side tables
and EGES's weight table stay replicated, and take ``mesh`` for a data
axis, whose lookups average every table's gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from recommender_tpu_torch.embedding.table import Embedding


class _GraphModel(nn.Module):
    def _add_tables(self, specs, device, generator):
        for name, vocab, dim, kw in specs:
            self.add_module(name, Embedding(vocab, dim, device=device, generator=generator, **kw))
        self._table_names = [s[0] for s in specs]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name in self._table_names:
            getattr(self, name).reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        hidden = self.get_hidden(batch)  # [B, D]
        ctx = self.output_embedding(batch["context"])  # [B, 1+k, D]
        return torch.einsum("bkd,bd->bk", ctx, hidden)


class DeepWalk(_GraphModel):
    def __init__(self, vocab_size: int, embed_dim: int = 128, partition: Optional[str] = None,
                 lookup_mode: str = "gspmd", *, mesh=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        big = dict(partition=partition, lookup_mode=lookup_mode, mesh=mesh)
        self._add_tables([("input_embedding", vocab_size, embed_dim, big),
                          ("output_embedding", vocab_size, embed_dim, big)], device, generator)

    def get_hidden(self, batch: dict) -> torch.Tensor:
        return self.input_embedding(batch["target"])


class GES(_GraphModel):
    def __init__(self, vocab_size: int, cat_vocab: int, brand_vocab: int, embed_dim: int = 128,
                 partition: Optional[str] = None, lookup_mode: str = "gspmd", *, mesh=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        big = dict(partition=partition, lookup_mode=lookup_mode, mesh=mesh)
        self._add_tables([("id_embedding", vocab_size, embed_dim, big),
                          ("cat_embedding", cat_vocab, embed_dim, dict(mesh=mesh)),
                          ("brand_embedding", brand_vocab, embed_dim, dict(mesh=mesh)),
                          ("output_embedding", vocab_size, embed_dim, big)], device, generator)

    def side_stack(self, batch: dict) -> torch.Tensor:
        """[B, 3, D]: the id, cat and brand rows."""
        return torch.stack([
            self.id_embedding(batch["target"]),
            self.cat_embedding(batch["target_cat"]),
            self.brand_embedding(batch["target_brand"]),
        ], dim=1)

    def get_hidden(self, batch: dict) -> torch.Tensor:
        return torch.mean(self.side_stack(batch), dim=1)


class EGES(GES):
    def __init__(self, vocab_size: int, cat_vocab: int, brand_vocab: int, embed_dim: int = 128,
                 partition: Optional[str] = None, lookup_mode: str = "gspmd",
                 num_side: int = 3, *, mesh=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vocab_size, cat_vocab, brand_vocab, embed_dim, partition, lookup_mode,
                         mesh=mesh, device=device, generator=generator)
        self.weight_embedding = Embedding(vocab_size, num_side, mesh=mesh, device=device,
                                          generator=generator)
        self._table_names.append("weight_embedding")

    def get_hidden(self, batch: dict) -> torch.Tensor:
        stack = self.side_stack(batch)  # [B, 3, D]
        w = torch.softmax(self.weight_embedding(batch["target"]), dim=-1)  # [B, 3]
        return torch.einsum("bs,bsd->bd", w, stack)
