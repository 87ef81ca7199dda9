"""Embedding sharding planner — pick a layout per table from its statistics.

A copy of ``recommender_tpu/embedding/planner.py`` (numpy only; the JAX
package's ``embedding/__init__.py`` imports jax, so the port cannot import
it). ``tests/test_torch_planner.py`` holds the copy's plans equal to the
original's. In the port a ``psum`` plan is the explicit masked gather and
all-reduce over the model group, and ``all_to_all`` the id and vector
exchange (``embedding.sharded``); a row-sharded table whose plan names
neither takes the psum exchange, whose backward stays shard-local.

The heuristics, as in the original:

* tiny tables (fit comfortably replicated, high-QPS) → **replicate**:
  lookups are local, no collective at all;
* large tables → **row-shard** over ``model``; choose the exchange:
  - ``psum`` (masked-gather + all-reduce) when the per-step lookup count is
    small relative to batch×dim (comm ≈ B·F·D regardless of m);
  - ``all_to_all`` when batches are large (comm ≈ 2·B·F·D/m);
* skew-aware capacity: the all-to-all bucket capacity is sized from the
  observed id-frequency skew (hot-shard mass), not a blind constant.

Outputs a plain dict plan usable to set each table's ``partition`` and
lookup strategy; `plan_summary` renders it for logs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TableStats:
    name: str
    vocab_size: int
    dim: int
    lookups_per_example: int = 1
    # optional empirical id distribution (counts or probabilities); used for
    # skew-aware all-to-all capacity
    id_freq: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class TablePlan:
    name: str
    partition: Optional[str]  # None = replicate, 'model' = row-shard
    lookup: str  # 'local' | 'psum' | 'all_to_all'
    capacity_factor: float = 2.0

    @property
    def bytes_per_device(self) -> int:  # filled by planner
        return self._bytes

    _bytes: int = 0


def plan_tables(
    tables: Sequence[TableStats],
    num_model_shards: int,
    batch_per_device: int,
    *,
    replicate_below_bytes: int = 32 << 20,  # 32 MB
    dtype_bytes: int = 4,
) -> list[TablePlan]:
    plans = []
    for t in tables:
        size = t.vocab_size * t.dim * dtype_bytes
        # a row-sharded table needs vocab divisible by the shard count:
        # device_put with a NamedSharding refuses uneven dimensions (and the
        # a2a route needs equal shards anyway) — pad the vocab to a multiple
        # of the mesh at table-build time if sharding such a table matters
        if (
            size <= replicate_below_bytes
            or num_model_shards == 1
            or t.vocab_size % num_model_shards
        ):
            if size > replicate_below_bytes and num_model_shards > 1:
                # row-sharding (both the a2a shard_map and device_put with a
                # NamedSharding) needs vocab % shards == 0; a big table that
                # misses it replicates on EVERY device — pad the vocab to a
                # multiple of the mesh at build time to unlock sharding
                import warnings

                warnings.warn(
                    f"table {t.name!r} ({size >> 20} MB) replicates on every "
                    f"device only because vocab_size={t.vocab_size} is not "
                    f"divisible by {num_model_shards} shards; pad the vocab "
                    "to a mesh multiple to row-shard it",
                    stacklevel=2,
                )
            plans.append(
                TablePlan(t.name, None, "local", _bytes=size)
            )
            continue
        # sharded: pick the exchange by comm volume per step
        n_lookups = batch_per_device * t.lookups_per_example
        psum_comm = batch_per_device * t.lookups_per_example * t.dim  # per device
        a2a_comm = 2 * n_lookups * t.dim // num_model_shards + n_lookups
        lookup = "all_to_all" if a2a_comm < psum_comm else "psum"
        cap = 2.0
        if t.id_freq is not None and lookup == "all_to_all":
            # capacity must cover the hottest shard's share of lookups
            freq = np.asarray(t.id_freq, np.float64)
            freq = freq / freq.sum()
            shard_mass = np.add.reduceat(
                freq, np.arange(0, len(freq), -(-len(freq) // num_model_shards))
            )
            cap = float(
                np.clip(shard_mass.max() * num_model_shards * 1.25, 1.25, 8.0)
            )
        plans.append(
            TablePlan(
                t.name, "model", lookup, capacity_factor=cap,
                _bytes=size // num_model_shards,
            )
        )
    return plans


def module_kwargs(plans: Sequence[TablePlan], mesh=None) -> dict:
    """Render a plan list into model/``FeatureEmbedder`` kwargs — the
    consumer side of the planner loop: ``partition`` (where each table
    lives), ``lookup_modes`` (the planned exchange: 'all_to_all' → the
    explicit a2a route; 'psum' → the explicit shard_map masked-gather+psum,
    whose backward stays shard-local — the GSPMD route's backward
    replicates the full-table scatter per device, see Embedding.lookup_mode),
    and the skew-aware ``capacity_factors``. ``mesh`` is attached when some
    table takes an explicit exchange (it is a static module attribute);
    without a mesh, planned psum tables fall back to the GSPMD route."""
    lookups = tuple(
        {"all_to_all": "a2a", "psum": "psum"}.get(p.lookup, "gspmd")
        if mesh is not None or p.lookup == "all_to_all"
        else "gspmd"
        for p in plans
    )
    return dict(
        partition=tuple(p.partition for p in plans),
        lookup_modes=lookups,
        capacity_factors=tuple(float(p.capacity_factor) for p in plans),
        mesh=mesh if any(l in ("a2a", "psum") for l in lookups) else None,
    )


def capacity_factor_from_ids(
    ids: np.ndarray,
    num_shards: int,
    vocab_size: int,
    headroom: float = 1.25,
) -> float:
    """Smallest all-to-all ``capacity_factor`` that is LOSSLESS on this
    sample of real lookup ids, times ``headroom`` (capped at ``num_shards``,
    which is lossless for any skew).

    The bucket capacity is ``ceil(n/m · factor)``, so losslessness requires
    ``factor ≥ max_shard_count / (n/m)``. Feed a representative batch (or a
    few) and wire the result into ``Embedding.capacity_factor`` /
    ``--a2a_capacity_factor``; the train metrics' ``a2a_overflow`` counter
    (``sharded.all_to_all_lookup(return_overflow=True)``) then verifies the
    choice live."""
    flat = np.asarray(ids).reshape(-1)
    rows = max(vocab_size // num_shards, 1)
    owner = np.clip(flat // rows, 0, num_shards - 1)
    counts = np.bincount(owner, minlength=num_shards)
    fair = flat.size / num_shards
    need = counts.max() / max(fair, 1.0)
    return float(min(need * headroom, float(num_shards)))


def plan_summary(plans: Sequence[TablePlan]) -> str:
    lines = []
    for p in plans:
        mb = p.bytes_per_device / (1 << 20)
        lines.append(
            f"{p.name}: {'replicated' if p.partition is None else 'row-sharded'}"
            f" / {p.lookup} ({mb:.1f} MB/device"
            + (f", capacity x{p.capacity_factor:.2f}" if p.lookup == "all_to_all" else "")
            + ")"
        )
    return "\n".join(lines)
