"""Embedding tables.

Port of ``recommender_tpu/embedding/table.py::Embedding``, replicated tables
only. The table is one ``[vocab_size, features]`` parameter named
``embedding`` (the flax param name) in ``param_dtype`` (f32 or bf16). Every
lookup goes through ``ops.embedding_kernels.embedding_lookup``, whose
backward is the sorted scatter-add kernel, or, with a dedup plan, through
``embedding_lookup_dedup``, whose backward calls that kernel twice.
Row-sharded tables (``partition``) and the psum / all-to-all exchanges
(``lookup_mode``) are later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    embedding_lookup_dedup,
)


class Embedding(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        features: int,
        *,
        partition: Optional[str] = None,
        param_dtype: torch.dtype = torch.float32,
        lookup_mode: str = "gspmd",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if partition is not None:
            raise NotImplementedError("row-sharded embedding tables are not ported yet")
        if lookup_mode != "gspmd":
            raise NotImplementedError(f"lookup_mode={lookup_mode!r} is not ported yet")
        if param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype}")
        self.vocab_size = vocab_size
        self.features = features
        self.embedding = nn.Parameter(
            torch.empty((vocab_size, features), dtype=param_dtype, device=device)
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``variance_scaling(1.0, "fan_in", "uniform", out_axis=0)``:
        fan_in is ``features``, so U(-√(3/D), √(3/D)). Sampled in f32 and
        cast to the table dtype."""
        bound = math.sqrt(3.0 / self.features)
        table = torch.empty(
            self.embedding.shape, dtype=torch.float32, device=self.embedding.device
        )
        table.uniform_(-bound, bound, generator=generator)
        self.embedding.copy_(table)

    def forward(self, ids: torch.Tensor, dedup_plan: Optional[dict] = None):
        """``[*ids.shape]`` int ids → ``[*ids.shape, features]`` rows in the
        table dtype. ``dedup_plan`` ``{"perm", "slot", "uniq"}`` (int32
        tensors, ``data.pipeline.with_dedup_plans``) takes the dedup'd
        backward."""
        if dedup_plan is not None:
            return embedding_lookup_dedup(
                self.embedding, ids, dedup_plan["perm"], dedup_plan["slot"], dedup_plan["uniq"]
            )
        return embedding_lookup(self.embedding, ids)
