"""Embedding tables.

Port of ``recommender_tpu/embedding/table.py``: ``EmbeddingSpec``, the
declarative record of a table, and ``bag_combine``, the weighted pooling of
a bag of vectors, are copied. In ``Embedding`` the table is one
parameter named ``embedding`` (the flax param name) in ``param_dtype`` (f32
or bf16). A replicated lookup goes through
``ops.embedding_kernels.embedding_lookup``, whose backward is the sorted
scatter-add kernel (K1), or, with a dedup plan, through
``embedding_lookup_dedup``, whose backward calls that kernel twice.

``partition="model"`` with a ``mesh`` whose model axis is wider than 1
row-shards the table: the parameter holds this rank's rows ``[lo, lo +
V/m)`` of the whole ``[V, D]`` table (``row_shards`` says so to
``parallel.partitioning``), and ``lookup_mode`` picks the exchange
(``embedding.sharded``):

* ``"psum"``: masked gather and all-reduce over the model group; the
  backward is K1 on this shard, with no collective;
* ``"a2a"``: ids routed to their owners and vectors back, with buckets of
  ``capacity_factor`` times the fair share; ids past a full bucket are
  served a 0 vector, and a training forward leaves their count in
  ``a2a_overflow`` (``models.tasks`` moves it into the step's metrics);
* ``"gspmd"``: XLA's partitioned gather has no torch counterpart; a sharded
  table takes the psum exchange (the same forward, and a backward that
  stays shard-local).

Without a mesh, or on a one-wide model axis, a partitioned table is whole,
as a sharding over one device is in JAX. On a mesh with a data axis wider
than 1 every lookup's backward gathers the data group's ids and cotangents
and computes the averaged gradient itself (``data_gathered``; whole tables
through ``embedding.sharded.data_parallel_lookup``): a table on a data
axis is built with the Trainer's ``mesh``. A dedup plan applies to whole
tables on one data rank only (JAX ignores it for a partitioned one).

The init (``init_rows``) is drawn over the whole ``[V, D]`` table in row
chunks of at most ``INIT_CHUNK_ELEMENTS`` values, in order, and a shard
keeps the chunks' rows that are its own: every mesh starts from the same
table, and no device holds more than its shard and one chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from recommender_tpu_torch.embedding.sharded import (
    all_to_all_lookup,
    data_parallel_lookup,
    shard_rows,
    sharded_lookup,
)
from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    embedding_lookup_dedup,
)

LOOKUP_MODES = ("gspmd", "psum", "a2a")


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Declarative spec used by planners/checkpointing."""

    name: str
    vocab_size: int
    features: int
    combiner: Optional[str] = None  # None | 'sum' | 'mean'
    sharded: bool = False
INIT_CHUNK_ELEMENTS = 1 << 22  # 16 MiB of f32 draws at a time


@torch.no_grad()
def init_rows(out: torch.Tensor, vocab_size: int, first_row: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``out`` [rows, D] with rows ``[first_row, first_row + rows)``
    of the flax table init ``variance_scaling(1.0, "fan_in", "uniform",
    out_axis=0)``: U(-√(3/D), √(3/D)), drawn in f32 over all
    ``vocab_size`` rows in chunks of whole rows, in order (on the CPU the
    chunks' draws are the whole table's draw), then cast to ``out``'s
    dtype."""
    rows, dim = out.shape
    bound = math.sqrt(3.0 / dim)
    chunk = max(1, min(vocab_size, INIT_CHUNK_ELEMENTS // dim))
    buf = torch.empty((chunk, dim), dtype=torch.float32, device=out.device)
    for a in range(0, vocab_size, chunk):
        b = min(a + chunk, vocab_size)
        drawn = buf[:b - a].uniform_(-bound, bound, generator=generator)
        lo, hi = max(a, first_row), min(b, first_row + rows)
        if lo < hi:
            out[lo - first_row:hi - first_row].copy_(drawn[lo - a:hi - a])
    return out


class Embedding(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        features: int,
        *,
        partition: Optional[str] = None,
        param_dtype: torch.dtype = torch.float32,
        lookup_mode: str = "gspmd",
        mesh=None,
        capacity_factor: float = 2.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if partition not in (None, "model"):
            raise ValueError(f"partition must be None or 'model', got {partition!r}")
        if lookup_mode not in LOOKUP_MODES:
            raise ValueError(f"lookup_mode must be one of {LOOKUP_MODES}, got {lookup_mode!r}")
        if mesh is not None and not hasattr(mesh, "model_group"):
            raise TypeError(f"mesh must be a core.mesh.Mesh, got {type(mesh).__name__}")
        if param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype}")
        self.vocab_size = vocab_size
        self.features = features
        self.partition = partition
        self.lookup_mode = lookup_mode
        self.capacity_factor = float(capacity_factor)
        self.mesh = mesh
        self.sharded = partition == "model" and mesh is not None and mesh.model > 1
        rows = shard_rows(vocab_size, mesh) if self.sharded else vocab_size
        self.row_offset = mesh.model_index * rows if self.sharded else 0
        self.row_shards = {"embedding": (self.row_offset, vocab_size)} if self.sharded else {}
        self.data_gathered = {"embedding"} if mesh is not None and mesh.data > 1 else set()
        self.a2a_overflow: Optional[torch.Tensor] = None
        self.embedding = nn.Parameter(
            torch.empty((rows, features), dtype=param_dtype, device=device)
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax init of the whole table; a shard keeps its rows
        (``init_rows``)."""
        init_rows(self.embedding.data, self.vocab_size, self.row_offset, generator)

    def forward(self, ids: torch.Tensor, dedup_plan: Optional[dict] = None):
        """``[*ids.shape]`` int ids → ``[*ids.shape, features]`` rows in the
        table dtype. ``dedup_plan`` ``{"perm", "slot", "uniq"}`` (int32
        tensors, ``data.pipeline.with_dedup_plans``) takes the dedup'd
        backward of a whole table."""
        if self.sharded:
            if self.lookup_mode != "a2a":
                return sharded_lookup(self.embedding, ids, self.mesh)
            vecs, dropped = all_to_all_lookup(
                self.embedding, ids, self.mesh, capacity_factor=self.capacity_factor,
                return_overflow=True,
            )
            if self.training:
                self.a2a_overflow = dropped
            return vecs
        if self.data_gathered:
            return data_parallel_lookup(self.embedding, ids, self.mesh)
        if dedup_plan is not None:
            return embedding_lookup_dedup(
                self.embedding, ids, dedup_plan["perm"], dedup_plan["slot"], dedup_plan["uniq"]
            )
        return embedding_lookup(self.embedding, ids)


def bag_combine(emb: torch.Tensor, weights: torch.Tensor, combiner: str) -> torch.Tensor:
    """Combine a bag of embeddings [..., K, D] with weights [..., K] → [..., D].

    ``mean`` divides by the weight sum clipped to >= 1 (multi-hot pooling).
    """
    w = weights.to(emb.dtype)[..., None]
    s = torch.sum(emb * w, dim=-2)
    if combiner == "sum":
        return s
    if combiner == "mean":
        return s / torch.clamp(torch.sum(w, dim=-2), min=1.0)
    raise ValueError(f"unknown combiner {combiner}")
