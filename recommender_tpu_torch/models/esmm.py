"""Multi-task CTR/CVR models: BASE, ESMM, MMOE (Ali-CCP).

Port of ``recommender_tpu/models/esmm.py``:

* ``FeatureEmbedder`` — one table per categorical feature (``feat_{j}``),
  concatenated to ``[B, F*D]`` f32; or, with ``stack=True``, all F tables
  as one ``stacked_embedding`` ``[ΣV, D]`` f32 param with feature ``j``'s
  rows at offset ``Σ_{i<j} V_i``: one lookup of ``[B, F]`` shifted ids,
  whose backward is one sorted scatter-add (K1) call instead of F. Each
  table's ``partition``, ``lookup_modes`` and ``capacity_factors`` may be
  one value for all or a tuple per feature (the planner's output,
  ``embedding.planner.module_kwargs``); a tuple makes the tables separate
  even with ``stack``. A partitioned table is row-sharded on ``mesh``
  (``embedding.table.Embedding``); so is the stacked table, whose lookup
  is then the psum exchange;
* ``MultiTaskBase`` — embedder → MLP with a 2-unit softmax head, the
  probability of class 1 (one model of the two-model BASE protocol);
* ``ESMM`` — shared embedder, CTR and CVR towers, pCTCVR = pCTR · pCVR;
* ``MMOE`` — an ``ExpertBank``, one softmax ``MMOEGate`` and one tower per
  task, head 1 coupled to head 0 as in ESMM.

ESMM and MMOE return ``{"ctr", "cvr", "ctcvr"}``. Submodule and parameter
names follow the flax tree (``embedder/feat_{j}/embedding``,
``embedder/stacked_embedding``, ``ctr_tower/Dense_i``, ``expert_bank/
experts/Dense_i``, ``gate_{i}``, ``tower_{i}``; ``FeatureEmbedder_0`` and
``MLP_0`` in ``MultiTaskBase``), so ``convert.py`` maps a JAX param tree
onto ``state_dict()`` directly.

Batch schema: ``features`` [B, F] int32, labels ``click`` / ``purchase``
[B].
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.embedding.sharded import (
    data_parallel_lookup,
    shard_rows,
    sharded_lookup,
)
from recommender_tpu_torch.embedding.table import Embedding, init_rows
from recommender_tpu_torch.nn.mlp import MLP
from recommender_tpu_torch.nn.moe import ExpertBank, MMOEGate
from recommender_tpu_torch.ops.embedding_kernels import embedding_lookup

def _softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


class FeatureEmbedder(nn.Module):
    """Per-feature embedding tables → concatenated ``[B, F*D]`` f32.

    ``stack=True`` keeps one f32 ``stacked_embedding`` (bf16 with ``stack``
    raises, as in JAX; so does a lookup mode other than ``gspmd``). Each
    feature's ids are clipped into its own segment before its offset is
    added, so an out-of-range id lands on its own table's last row, not on
    the next feature's rows."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 18,
        partition: Optional[str] | Sequence[Optional[str]] = None,
        stack: bool = False,
        lookup_modes: str | Sequence[str] = "gspmd",
        param_dtype: torch.dtype = torch.float32,
        *,
        capacity_factors: float | Sequence[float] = 2.0,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        per_table = any(isinstance(v, (list, tuple))
                        for v in (partition, lookup_modes, capacity_factors))
        self.stack = stack and not per_table
        if not self.stack:
            parts, modes, caps = (self._per_feat(v)
                                  for v in (partition, lookup_modes, capacity_factors))
            for j, v in enumerate(self.vocab_sizes):
                self.add_module(f"feat_{j}", Embedding(
                    v, embed_dim, partition=parts[j], lookup_mode=modes[j],
                    capacity_factor=float(caps[j]), mesh=mesh, param_dtype=param_dtype,
                    device=device, generator=generator))
            return
        if lookup_modes != "gspmd":
            raise ValueError(
                "stacked tables support only the gspmd lookup; use per-table mode "
                f"(stack=False) for lookup_modes={lookup_modes!r}"
            )
        if param_dtype != torch.float32:
            raise ValueError(
                "stacked tables are f32-only; use per-table mode (stack=False) for "
                f"param_dtype={param_dtype}"
            )
        total = sum(self.vocab_sizes)
        self.partition, self.mesh = partition, mesh
        self.sharded = partition == "model" and mesh is not None and mesh.model > 1
        rows = shard_rows(total, mesh) if self.sharded else total
        self.row_shards = (
            {"stacked_embedding": (mesh.model_index * rows, total)} if self.sharded else {})
        self.data_gathered = (
            {"stacked_embedding"} if mesh is not None and mesh.data > 1 else set())
        self.stacked_embedding = nn.Parameter(
            torch.empty((rows, embed_dim), dtype=torch.float32, device=device)
        )
        # not in the state_dict: they follow from vocab_sizes
        sizes = np.asarray(self.vocab_sizes)
        self.register_buffer("_offsets", torch.tensor(
            np.cumsum([0, *sizes[:-1]]), dtype=torch.int32, device=device), persistent=False)
        self.register_buffer("_maxima", torch.tensor(
            sizes - 1, dtype=torch.int32, device=device), persistent=False)
        self.reset_parameters(generator)

    def _per_feat(self, v) -> tuple:
        n = len(self.vocab_sizes)
        if isinstance(v, (list, tuple)):
            if len(v) != n:
                raise ValueError(f"{len(v)} per-feature values for {n} features")
            return tuple(v)
        return (v,) * n

    def tables(self) -> list[Embedding]:
        return [getattr(self, f"feat_{j}") for j in range(len(self.vocab_sizes))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each table's (each segment's) flax init: U(-√(3/D), √(3/D)),
        drawn over the whole stacked table; a shard keeps its rows."""
        if not self.stack:
            for table in self.tables():
                table.reset_parameters(generator)
            return
        lo = self.row_shards.get("stacked_embedding", (0, 0))[0]
        init_rows(self.stacked_embedding.data, sum(self.vocab_sizes), lo, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if not self.stack:
            cols = [table(features[:, j]) for j, table in enumerate(self.tables())]
            # a bf16 table's rows are upcast; the cast's backward rounds the
            # cotangent back to bf16 before each scatter
            return torch.cat(cols, dim=-1).to(torch.float32)
        local = torch.minimum(torch.clamp(features, min=0), self._maxima)
        ids = (local + self._offsets).to(features.dtype)  # [B, F] global rows
        if self.sharded:
            emb = sharded_lookup(self.stacked_embedding, ids, self.mesh)
        elif self.data_gathered:
            emb = data_parallel_lookup(self.stacked_embedding, ids, self.mesh)
        else:
            emb = embedding_lookup(self.stacked_embedding, ids)
        return emb.reshape(features.shape[0], len(self.vocab_sizes) * self.embed_dim)


class MultiTaskBase(nn.Module):
    """Single-head model (CTR-only or CVR-only in the BASE protocol)."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 18,
        mlp_units: Sequence[int] = (360, 200, 80, 2),
        partition: Optional[str] | Sequence[Optional[str]] = None,
        stack_tables: bool = False,
        lookup_modes: str | Sequence[str] = "gspmd",
        embed_param_dtype: torch.dtype = torch.float32,
        *,
        capacity_factors: float | Sequence[float] = 2.0,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.FeatureEmbedder_0 = FeatureEmbedder(
            vocab_sizes, embed_dim, partition, stack_tables, lookup_modes, embed_param_dtype,
            capacity_factors=capacity_factors, mesh=mesh, device=device, generator=generator)
        self.MLP_0 = MLP(len(vocab_sizes) * embed_dim, mlp_units, final_activation=_softmax,
                         device=device, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.FeatureEmbedder_0.reset_parameters(generator)
        self.MLP_0.reset_parameters(generator)

    def forward(self, batch: dict) -> torch.Tensor:
        out = self.MLP_0(self.FeatureEmbedder_0(batch["features"]))
        # the reference's 2-unit softmax head: the probability of class 1
        return out[:, 1] if out.shape[-1] == 2 else torch.squeeze(torch.sigmoid(out), -1)


class ESMM(nn.Module):
    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 18,
        mlp_units: Sequence[int] = (360, 200, 80, 1),
        partition: Optional[str] | Sequence[Optional[str]] = None,
        stack_tables: bool = False,
        lookup_modes: str | Sequence[str] = "gspmd",
        embed_param_dtype: torch.dtype = torch.float32,
        *,
        capacity_factors: float | Sequence[float] = 2.0,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embedder = FeatureEmbedder(
            vocab_sizes, embed_dim, partition, stack_tables, lookup_modes, embed_param_dtype,
            capacity_factors=capacity_factors, mesh=mesh, device=device, generator=generator)
        width = len(vocab_sizes) * embed_dim
        self.ctr_tower = MLP(width, mlp_units, final_activation=torch.sigmoid,
                             device=device, generator=generator)
        self.cvr_tower = MLP(width, mlp_units, final_activation=torch.sigmoid,
                             device=device, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedder.reset_parameters(generator)
        self.ctr_tower.reset_parameters(generator)
        self.cvr_tower.reset_parameters(generator)

    def forward(self, batch: dict) -> dict:
        x = self.embedder(batch["features"])
        p_ctr = torch.squeeze(self.ctr_tower(x), -1)
        p_cvr = torch.squeeze(self.cvr_tower(x), -1)
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}


class MMOE(nn.Module):
    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 18,
        num_tasks: int = 2,
        num_experts: int = 8,
        expert_units: Sequence[int] = (200, 80),
        tower_units: Sequence[int] = (40, 1),
        partition: Optional[str] | Sequence[Optional[str]] = None,
        stack_tables: bool = False,
        lookup_modes: str | Sequence[str] = "gspmd",
        embed_param_dtype: torch.dtype = torch.float32,
        *,
        capacity_factors: float | Sequence[float] = 2.0,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_tasks = num_tasks
        self.embedder = FeatureEmbedder(
            vocab_sizes, embed_dim, partition, stack_tables, lookup_modes, embed_param_dtype,
            capacity_factors=capacity_factors, mesh=mesh, device=device, generator=generator)
        width = len(vocab_sizes) * embed_dim
        self.expert_bank = ExpertBank(num_experts, width, expert_units, device=device,
                                      generator=generator)
        for i in range(num_tasks):
            self.add_module(f"gate_{i}", MMOEGate(width, num_experts, device=device,
                                                  generator=generator))
            self.add_module(f"tower_{i}", MLP(expert_units[-1], tower_units,
                                              final_activation=torch.sigmoid,
                                              device=device, generator=generator))

    def heads(self) -> list[tuple[MMOEGate, MLP]]:
        return [(getattr(self, f"gate_{i}"), getattr(self, f"tower_{i}"))
                for i in range(self.num_tasks)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedder.reset_parameters(generator)
        self.expert_bank.reset_parameters(generator)
        for gate, tower in self.heads():
            gate.reset_parameters(generator)
            tower.reset_parameters(generator)

    def forward(self, batch: dict) -> dict:
        x = self.embedder(batch["features"])
        experts = self.expert_bank(x)  # [B, E, H]
        heads = [torch.squeeze(tower(gate(x, experts)), -1) for gate, tower in self.heads()]
        p_ctr, p_cvr = heads[0], heads[1]
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}
