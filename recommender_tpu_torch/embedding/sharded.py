"""Row-sharded embedding exchanges over the mesh's ``model`` group.

Port of ``recommender_tpu/embedding/sharded.py``. A row-sharded table keeps
rows ``[lo, lo + rows)`` on each rank of a model group, ``lo = model_index
* rows``; the ranks of a model group hold the same ids (the rows of their
data coordinate), and each exchange gives every one of them the same
``[*ids.shape, D]`` vectors. Each is an ``autograd.Function`` whose
backward is the sorted scatter-add kernel (K1) on this rank's shard, with
no collective over ``model`` for the psum exchange (each shard owns its
rows, and every rank of the group holds the same cotangent):

* ``sharded_lookup`` (psum): gather the rows this shard owns, zero the
  rest, ``all_reduce(SUM)`` over the model group. The backward hands K1 the
  ids shifted by ``-lo``, unmasked: the ids of other shards fall below 0 or
  at or above ``rows``, where K1 drops them, and every id keeps the sorted
  position it has in the whole table's backward. K1's sums depend only on
  those positions, so this rank's rows of the gradient equal the
  replicated lookup's bit for bit.
* ``all_to_all_lookup``: JAX's routing (``_a2a_local``). Stable sort by
  owner, a fixed capacity ``ceil(n / m * capacity_factor)`` per owner, ids
  then vectors by ``all_to_all_single``; ids past an owner's capacity are
  served a 0 vector and counted (``return_overflow``). The backward sends
  the vectors' cotangent back by the reverse ``all_to_all_single`` and
  runs K1 on the served ids. Every rank of the group routes its own copy of
  the ids, so an owner receives each cotangent ``m`` times; it is scaled
  by ``1 / m`` on the way back, as JAX's ``shard_map`` transpose scales the
  cotangent of an output replicated over ``model``.
* ``sort_coalesced_lookup``: a gather through the sorted id order.

On a data axis wider than 1 each backward first gathers the ids and the
cotangent rows of every data rank of the group (``_gather_over_data``:
``all_gather_into_tensor``, the cotangents scaled by ``1 / data``) and runs
K1 once over all of them: the table's gradient arrives averaged over the
data axis, summed in one f32 pass and rounded to the table's dtype once, as
one rank holding the global batch would compute it, and the exchange moves
the batch's rows instead of the ``[V, D]`` gradient. A replicated table
takes this path through ``data_parallel_lookup``. Such a table says so in
``data_gathered``, and the Trainer leaves its gradient alone.

The TPU's shape gates (``_masked_gather``, ``PADDED_BWD_*``,
``PALLAS_BWD_MAX_ROWS``) and ``padded_scatter_add`` are not ported: every
shard-local backward is K1.
"""
from __future__ import annotations

import numpy as np
import torch

from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.core.mesh import Mesh
from recommender_tpu_torch.parallel.partitioning import validate_divisibility
from recommender_tpu_torch.ops.embedding_kernels import embedding_lookup, scatter_add_dense


def shard_table(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a whole ``[V, D]`` table: ``[V/m, D]``, rows
    ``[model_index * V/m, (model_index + 1) * V/m)``."""
    rows = shard_rows(table.shape[0], mesh)
    lo = mesh.model_index * rows
    return table[lo:lo + rows]


def shard_rows(vocab_size: int, mesh: Mesh) -> int:
    """Rows of each shard of a ``vocab_size`` table over ``model``; the
    vocabulary must divide evenly."""
    validate_divisibility(vocab_size, mesh)
    return vocab_size // mesh.model


def _gather_over_data(ids: torch.Tensor, cot: torch.Tensor, mesh: Mesh):
    """Every data rank's flat ``ids`` and ``[n, D]`` cotangent rows, in data
    order, the rows scaled by ``1 / data``: each rank's cotangent is of its
    local mean, and their average is the global batch's. The ranks of a
    data group hold equal ``n``."""
    if mesh.data == 1:
        return ids, cot
    group = mesh.data_group
    ids = ids.reshape(-1).contiguous()
    cot = cot.reshape(ids.numel(), -1).contiguous()
    all_ids = torch.empty(ids.numel() * mesh.data, dtype=ids.dtype, device=ids.device)
    all_cot = torch.empty((all_ids.numel(), cot.shape[1]), dtype=cot.dtype, device=cot.device)
    distributed.all_gather_into_tensor(all_ids, ids, group=group)
    distributed.all_gather_into_tensor(all_cot, cot, group=group)
    return all_ids, all_cot / mesh.data


class _DataParallelLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.vocab, ctx.table_dtype = mesh, table.shape[0], table.dtype
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        all_ids, all_cot = _gather_over_data(ids, cot, ctx.mesh)
        grad = scatter_add_dense(all_ids, all_cot, ctx.vocab)
        return grad.to(ctx.table_dtype), None, None


def data_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``table[ids]`` of a whole table on a data axis wider than 1; its
    gradient is the data group's average (module docstring)."""
    return _DataParallelLookup.apply(table, ids, mesh)


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ids, mesh):
        rows, d = shard.shape
        local = ids.reshape(-1) - mesh.model_index * rows
        valid = (local >= 0) & (local < rows)
        got = shard.index_select(0, local.clamp(0, rows - 1))
        out = torch.where(valid[:, None], got, torch.zeros((), dtype=got.dtype, device=got.device))
        distributed.all_reduce(out, group=mesh.model_group)
        ctx.save_for_backward(local)
        ctx.rows, ctx.table_dtype, ctx.mesh = rows, shard.dtype, mesh
        return out.reshape(*ids.shape, d)

    @staticmethod
    def backward(ctx, cot):
        (local,) = ctx.saved_tensors
        local, cot = _gather_over_data(local, cot, ctx.mesh)
        grad = scatter_add_dense(local, cot, ctx.rows)
        return grad.to(ctx.table_dtype), None, None


def sharded_lookup(shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Lookup global ``ids`` [...] in a row-sharded table whose rows here are
    ``shard`` [V/m, D] → [..., D], the same on every rank of the model
    group. Differentiable; the table gradient is this shard's rows only."""
    return _PsumLookup.apply(shard, ids, mesh)


def a2a_capacity(n_local: int, num_shards: int, capacity_factor: float) -> int:
    """Ids each rank sends each owner a step: ``ceil(n / m * factor)``."""
    return int(np.ceil(n_local / num_shards * capacity_factor))


def _route(flat: torch.Tensor, m: int, rows: int, capacity: int):
    """JAX's packing: ids stably sorted by owner, each owner's first
    ``capacity`` in slots ``owner * capacity + within``. Returns the
    ``[m * capacity]`` ids to send (pad ``m * rows``, past every shard) and
    each position's slot, -1 where its owner's bucket overflowed."""
    n = flat.numel()
    owner = torch.clamp(torch.div(flat, rows, rounding_mode="floor"), 0, m - 1)
    sorted_owner, order = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=m)
    start = torch.cumsum(counts, 0) - counts
    within = torch.arange(n, device=flat.device) - start[sorted_owner]
    ok = within < capacity
    slot_sorted = torch.where(ok, sorted_owner * capacity + within, -1)
    send = torch.full((m * capacity,), m * rows, dtype=flat.dtype, device=flat.device)
    send[slot_sorted[ok]] = flat[order][ok]
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return send, slot


class _A2AExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, send_ids, slot, mesh):
        rows, d = shard.shape
        group = mesh.model_group
        recv_ids = distributed.all_to_all_single(torch.empty_like(send_ids), send_ids, group)
        local = recv_ids - mesh.model_index * rows
        valid = (local >= 0) & (local < rows)
        served = shard.index_select(0, local.clamp(0, rows - 1))
        zero = torch.zeros((), dtype=served.dtype, device=served.device)
        served = torch.where(valid[:, None], served, zero)
        vecs = distributed.all_to_all_single(torch.empty_like(served), served, group)
        ok = slot >= 0
        out = torch.where(ok[:, None], vecs.index_select(0, slot.clamp(min=0)), zero)
        ctx.save_for_backward(local, slot)
        ctx.rows, ctx.table_dtype, ctx.mesh = rows, shard.dtype, mesh
        return out

    @staticmethod
    def backward(ctx, cot):
        local, slot = ctx.saved_tensors
        mesh = ctx.mesh
        ok = slot >= 0
        back = torch.zeros((local.numel(), cot.shape[-1]), dtype=cot.dtype, device=cot.device)
        # each of the m ranks of the model group sends its copy back
        back[slot[ok]] = cot[ok] / mesh.model
        served_cot = distributed.all_to_all_single(torch.empty_like(back), back, mesh.model_group)
        local, served_cot = _gather_over_data(local, served_cot, mesh)
        grad = scatter_add_dense(local, served_cot, ctx.rows)
        return grad.to(ctx.table_dtype), None, None, None


def all_to_all_lookup(
    shard: torch.Tensor,
    ids: torch.Tensor,
    mesh: Mesh,
    capacity_factor: float = 2.0,
    return_overflow: bool = False,
):
    """Row-sharded lookup by the all-to-all id and vector exchange over
    ``model`` → ``[*ids.shape, D]``; with ``return_overflow`` also the
    number of ids served a 0 vector because an owner's bucket was full,
    summed over every rank the ids span (the whole mesh when ``data`` > 1,
    else the model group), as a 0-dim int64 tensor on the ids' device."""
    rows, d = shard.shape
    flat = ids.reshape(-1)
    capacity = a2a_capacity(flat.numel(), mesh.model, capacity_factor)
    send, slot = _route(flat, mesh.model, rows, capacity)
    out = _A2AExchange.apply(shard, send, slot, mesh).reshape(*ids.shape, d)
    if not return_overflow:
        return out
    dropped = (slot < 0).sum().to(torch.int64)
    group = mesh.world_group if mesh.data > 1 else mesh.model_group
    return out, distributed.all_reduce(dropped, group=group)


def a2a_overflow_fraction(
    ids: np.ndarray, num_shards: int, vocab_size: int, capacity_factor: float
) -> float:
    """Host-side diagnostic (a copy of the JAX function): the fraction of
    lookups the all-to-all exchange would drop (serve a 0 vector) at this
    capacity, given a sample of real ids. ``capacity_factor >= num_shards``
    is always 0."""
    flat = np.asarray(ids).reshape(-1)
    rows = vocab_size // num_shards
    owner = np.clip(flat // max(rows, 1), 0, num_shards - 1)
    capacity = int(np.ceil(flat.size / num_shards * capacity_factor))
    counts = np.bincount(owner, minlength=num_shards)
    return float(np.maximum(counts - capacity, 0).sum() / max(flat.size, 1))


def sort_coalesced_lookup(
    table: torch.Tensor, ids: torch.Tensor, mesh: Mesh | None = None
) -> torch.Tensor:
    """Gather through the sorted id order (duplicates adjacent): all N
    positions are still gathered (and, sharded, all-reduced); the sorted
    order is what K1's backward wants. ``table`` is this rank's shard when
    ``mesh`` has a model axis wider than 1, else the whole table."""
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    if mesh is not None and mesh.model > 1:
        gathered = sharded_lookup(table, sorted_ids, mesh)
    else:
        gathered = embedding_lookup(table, sorted_ids)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return gathered.index_select(0, inv).reshape(*ids.shape, table.shape[-1])

