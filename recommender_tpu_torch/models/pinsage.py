"""PinSage — importance-pooling graph convolution for item retrieval.

Port of ``recommender_tpu/models/pinsage.py`` (replicated tables), with the
flax names, so ``convert.py`` maps a JAX init one to one:

* ``FeatureProjector`` — the ``year`` and ``id`` tables (``Embedding``, so
  each lookup's backward is the sorted scatter-add kernel, K1) and the
  ``genre_embedding`` param, whose rows are averaged over an item's genre
  multi-hot (``multihot @ table / count``); concat dim 3·E. The items'
  year index and genre multi-hot are non-persistent buffers
  (``item_year``, ``item_genre``): data, not state, so no checkpoint or
  converted init carries them.
* ``Convolve`` — ``Dense_0`` on the neighbours → importance-weighted mean
  with the weight sum clipped to ≥ 1 → concat the destination → ``Dense_1``
  → per-row L2 normalization with a floor of 1e-12.
* ``PinSage`` — ``conv_0`` over the layer-2 frontier, ``conv_1`` over the
  seeds' neighbours, then ``fc1`` and ``fc2``; the forward scores the
  stacked [heads; pos; neg] pairs by dot product.

``get_repr`` projects the features twice (``flat1`` and ``nbr2``): in flax
both calls share the ``year`` and ``id`` tables and their gradients add; here
autograd adds the two lookups' K1 outputs. A train step therefore launches
K1 four times (two lookups into each of the two tables).

Batch schema: the dense ``BlockBatch`` tree of
``graph.bipartite.sample_block_batch`` (``nodes``, ``nbr1``, ``w1``,
``flat1``, ``nbr2``, ``w2``). ``partition``, ``lookup_mode`` and ``mesh``
go to the item id table (``embedding.table.Embedding``), as in JAX; the
year table stays replicated, and takes ``mesh`` for a data axis, whose
lookups average every table's gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.embedding.table import Embedding
from recommender_tpu_torch.nn.mlp import lecun_normal_


@dataclasses.dataclass(frozen=True)
class ItemFeatures:
    """Static per-item features (MovieLens: id implicit, year idx, genre multi-hot)."""

    year: np.ndarray  # [V] int32
    genre: np.ndarray  # [V, G] float32 multi-hot

    @property
    def num_items(self) -> int:
        return len(self.year)


def _dense(in_features: int, out_features: int, device) -> nn.Linear:
    """An f32 ``nn.Linear``, left uninitialized: the owner draws flax
    ``Dense``'s init (lecun-normal kernel, zero bias)."""
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device=torch.device("cpu") if device is None else device,
                              dtype=torch.float32)


def _reset_dense(layer: nn.Linear, generator):
    lecun_normal_(layer.weight, generator)
    layer.bias.zero_()


class FeatureProjector(nn.Module):
    def __init__(self, features: ItemFeatures, embed_dim: int = 8,
                 partition: Optional[str] = None, lookup_mode: str = "gspmd", *,
                 mesh=None, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        year_vocab = int(features.year.max()) + 1
        num_genres = features.genre.shape[1]
        self.embed_dim = embed_dim
        self.year = Embedding(year_vocab, embed_dim, mesh=mesh, device=device, generator=generator)
        self.genre_embedding = nn.Parameter(
            torch.empty((num_genres, embed_dim), dtype=torch.float32, device=device)
        )
        self.id = Embedding(features.num_items, embed_dim, partition=partition,
                            lookup_mode=lookup_mode, mesh=mesh, device=device,
                            generator=generator)
        self.register_buffer("item_year", torch.as_tensor(
            np.asarray(features.year, np.int64), device=device), persistent=False)
        self.register_buffer("item_genre", torch.as_tensor(
            np.asarray(features.genre, np.float32), device=device), persistent=False)
        self._reset_genre(generator)

    @torch.no_grad()
    def _reset_genre(self, generator):
        """flax ``variance_scaling(1.0, "fan_in", "uniform", out_axis=0)`` on
        [G, E]: fan_in is E, so U(-√(3/E), √(3/E)), as ``Embedding``."""
        bound = math.sqrt(3.0 / self.embed_dim)
        self.genre_embedding.uniform_(-bound, bound, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.year.reset_parameters(generator)
        self._reset_genre(generator)
        self.id.reset_parameters(generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """``[*ids.shape]`` item ids → ``[*ids.shape, 3·E]``."""
        year_emb = self.year(self.item_year[ids])
        multihot = self.item_genre[ids]  # [..., G]
        genre_emb = torch.matmul(multihot, self.genre_embedding) / torch.clamp(
            torch.sum(multihot, dim=-1, keepdim=True), min=1.0
        )
        id_emb = self.id(ids)
        return torch.cat([year_emb, genre_emb, id_emb], dim=-1)


class Convolve(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """``in_features``: the width of the neighbour and destination rows
        (flax infers it at init)."""
        super().__init__()
        self.Dense_0 = _dense(in_features, hidden, device)
        self.Dense_1 = _dense(hidden + in_features, out, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_dense(self.Dense_0, generator)
        _reset_dense(self.Dense_1, generator)

    def forward(self, dst_h: torch.Tensor, nbr_h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """dst_h [..., D], nbr_h [..., T, D], w [..., T] → [..., out]."""
        u = F.relu(self.Dense_0(nbr_h))  # neighbor transform
        ws = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)  # clip ≥ 1
        pooled = torch.einsum("...td,...t->...d", u, w) / ws  # importance pooling
        new = F.relu(self.Dense_1(torch.cat([pooled, dst_h], dim=-1)))
        norm = torch.clamp(torch.linalg.vector_norm(new, dim=-1, keepdim=True), min=1e-12)
        return new / norm  # per-row L2


class PinSage(nn.Module):
    def __init__(self, features: ItemFeatures, embed_dim: int = 8, conv_hidden: int = 64,
                 conv_out: int = 32, num_layers: int = 2, partition: Optional[str] = None,
                 lookup_mode: str = "gspmd", *, mesh=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_layers != 2:
            # get_repr is the dense two-layer tree of BlockBatch
            raise ValueError(f"num_layers must be 2 (the block tree's depth), got {num_layers}")
        self.projector = FeatureProjector(features, embed_dim, partition=partition,
                                          lookup_mode=lookup_mode, mesh=mesh, device=device,
                                          generator=generator)
        kw = dict(device=device, generator=generator)
        self.conv_0 = Convolve(3 * embed_dim, conv_hidden, conv_out, **kw)
        self.conv_1 = Convolve(conv_out, conv_hidden, conv_out, **kw)
        self.fc1 = _dense(conv_out, conv_hidden, device)
        self.fc2 = _dense(conv_hidden, conv_out, device)
        with torch.no_grad():
            _reset_dense(self.fc1, generator)
            _reset_dense(self.fc2, generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.projector.reset_parameters(generator)
        self.conv_0.reset_parameters(generator)
        self.conv_1.reset_parameters(generator)
        _reset_dense(self.fc1, generator)
        _reset_dense(self.fc2, generator)

    def get_repr(self, block: dict) -> torch.Tensor:
        """Dense 2-layer tree → final reprs for ``block['nodes']`` [N, out]."""
        n = block["nodes"].shape[0]
        t = block["nbr1"].shape[1]
        h0_dst = self.projector(block["flat1"])  # [N*(1+T), 3E]
        h0_nbr = self.projector(block["nbr2"])  # [N*(1+T), T, 3E]
        h1 = self.conv_0(h0_dst, h0_nbr, block["w2"])  # [N*(1+T), out]
        h1 = h1.reshape(n, 1 + t, -1)
        h2 = self.conv_1(h1[:, 0, :], h1[:, 1:, :], block["w1"])  # [N, out]
        return self.fc2(F.relu(self.fc1(h2)))

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: block tensors for the stacked [heads; pos; neg] node list
        → (pos_score, neg_score) per pair."""
        reprs = self.get_repr(batch)
        n = reprs.shape[0] // 3
        h, p, ng = reprs[:n], reprs[n:2 * n], reprs[2 * n:]
        return torch.sum(h * p, dim=-1), torch.sum(h * ng, dim=-1)
