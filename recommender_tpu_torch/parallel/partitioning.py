"""Which parameters are row-sharded over the mesh's ``model`` axis.

Port of ``recommender_tpu/parallel/partitioning.py``. JAX reads a param's
layout from flax's partitioning metadata; here a module that row-shards a
parameter says so in ``row_shards``, ``{attribute: (first_row,
whole_rows)}`` (``embedding.table.Embedding`` with ``partition="model"`` on
a mesh whose model axis is wider than 1, and ``FeatureEmbedder``'s stacked
table). Everything else is replicated. The optimizer state mirrors the
parameters: Adam's moments of a shard are the shard's, so the update is
shard-local; its stochastic rounding draws each element's noise by the
element's index in the whole table (``element_offsets``).

On a data axis wider than 1 every table averages its own gradient over
the data group in its lookup's backward (``embedding.sharded``): its
module lists the parameter in ``data_gathered`` (``data_gathered_params``),
and the Trainer averages every other gradient. A table on a data axis must
be built on the Trainer's mesh (``Trainer.init_state`` checks it), so no
table's gradient takes the Trainer's all-reduce.

A checkpoint holds whole tables (``core.train.Trainer.save``): the rows of
a shard are gathered over ``model`` in chunks into rank 0's host memory to
write it and cut again to restore it, so a checkpoint restores onto any
mesh whose model axis divides the vocabulary (``validate_divisibility``).
"""
from __future__ import annotations

from torch import nn


def row_sharded_params(model: nn.Module) -> dict[str, tuple[int, int]]:
    """``{param name: (first_row, whole_rows)}`` of every row-sharded
    parameter of ``model``, by its ``state_dict`` name."""
    out = {}
    for prefix, module in model.named_modules():
        for attr, rows in getattr(module, "row_shards", {}).items():
            out[f"{prefix}.{attr}" if prefix else attr] = rows
    return out


def data_gathered_params(model: nn.Module) -> set[str]:
    """Names of the parameters whose gradient their lookup has already
    averaged over the data group."""
    out = set()
    for prefix, module in model.named_modules():
        for attr in getattr(module, "data_gathered", ()):
            out.add(f"{prefix}.{attr}" if prefix else attr)
    return out


def element_offsets(model: nn.Module, names) -> list[int]:
    """For each param name in ``names``, the flat index of its first element
    in its whole table: ``first_row * D`` for a row shard, else 0."""
    shards = row_sharded_params(model)
    params = dict(model.named_parameters())
    out = []
    for name in names:
        lo = shards.get(name, (0, 0))[0]
        row = params[name][0].numel() if params[name].dim() > 1 else 1
        out.append(lo * row)
    return out


def validate_divisibility(vocab_size: int, mesh, name: str = "table") -> None:
    """Raise a clear error where a row-sharded table's vocabulary does not
    divide the mesh's model axis: a shard of unequal rows would address
    rows that are not there (a wrong result, not a crash). Checked when a
    table is built, so fresh runs and cross-mesh restores fail at once."""
    if vocab_size % mesh.model:
        raise ValueError(
            f"{name} ({vocab_size} rows) is row-sharded over mesh axis 'model' (size "
            f"{mesh.model}) but is not divisible by it; pad the vocab to a multiple of the "
            "axis size or restore onto a compatible mesh"
        )
