"""Embedding hot path: gather forward, sorted scatter-add backward.

Port of ``recommender_tpu/ops/embedding_kernels.py``. The backward of every
embedding lookup is one hand-written CUDA kernel, ``csrc/sorted_scatter_add.cu``
(it replaces the Pallas ``_packed_scatter_kernel``): a deterministic sorted
segment sum of the cotangent rows into a fresh f32 ``[V, D]`` table. The
JAX package's other backward routes (the padded-width XLA scatter and the
row and volume gates that choose between routes) exist for the TPU's lane
width and are not ported.

``embedding_lookup_dedup`` is the JAX package's dedup'd lookup: its
backward follows a host-precomputed plan with two kernel calls, a segment
sum into the batch's unique ids and a scatter of those rows into the table.

The kernel runs in two passes, so that its time follows the bytes it moves
and not the longest run of equal ids. Pass 1 cuts the N sorted positions
into chunks of a fixed size (``_geometry``) and sums, one block per chunk,
the pieces of runs inside it; a run that crosses a chunk boundary leaves
one partial row per side of each chunk it touches. Pass 2 sums each
crossing run's partial rows in chunk order. The wrapper allocates the
output (``torch.zeros``) and the partial rows (``torch.empty``, 2 x D f32
per chunk) on the current stream; nothing is read back to the host.

``sorted_scatter_add`` launches the kernel for CUDA tensors and counts each
call in ``sorted_scatter_add.launches`` (one per call, although a call is
two CUDA launches). For CPU tensors it computes the same function with
``sorted_scatter_add_ref``, the plain PyTorch version that the tests and
``chip_smoke.py`` hold the kernel against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from recommender_tpu_torch.ops import _build


# Launch geometry; the first two mirror kThreads and kRows in the source,
# which refuses a chunk other than slots * kRows.
_THREADS = 256  # threads per block
_ROWS_PER_SLOT = 8  # sorted positions each row slot sums
_MAX_SLAB = 32  # column groups one row slot covers at a time


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry of ``csrc/sorted_scatter_add.cu``, built at first use."""
    fn = _build.load("sorted_scatter_add").rtt_sorted_scatter_add
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i64, i32, i32, i32, i32, i32, i32, vp]
    fn.restype = i32
    return fn


def _load_width(d: int, element_size: int, address: int) -> int:
    """Elements per column group: the widest load of 16, 8, 4 or 2 bytes
    that divides the row (``d`` elements) and the rows' start address, else
    one element."""
    for nbytes in (16, 8, 4, 2):
        vec = nbytes // element_size
        if vec >= 1 and d % vec == 0 and address % nbytes == 0:
            return vec
    return 1


def _geometry(d: int, vec: int) -> tuple[int, int, int]:
    """(slab, slots, chunk): a block's row slots each span ``slab`` column
    groups of ``vec`` elements (wider rows take several slabs in turn);
    ``slots`` of them fill the block, and a chunk, one block's share of
    the sorted positions, is ``slots * _ROWS_PER_SLOT`` positions."""
    slab = min(d // vec, _MAX_SLAB)
    slots = _THREADS // slab
    return slab, slots, slots * _ROWS_PER_SLOT


def _check_scatter_args(sorted_ids, updates, vocab_size, order, kernel_dtype):
    if sorted_ids.dim() != 1 or sorted_ids.dtype != torch.int32:
        raise ValueError(
            f"sorted_ids must be 1-D int32, got {sorted_ids.dtype} {tuple(sorted_ids.shape)}"
        )
    if updates.dim() != 2 or updates.shape[0] != sorted_ids.shape[0]:
        raise ValueError(
            f"updates must be [N, D] with N = {sorted_ids.shape[0]}, got {tuple(updates.shape)}"
        )
    if updates.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"updates must be float32 or bfloat16, got {updates.dtype}")
    if kernel_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel_dtype must be float32 or bfloat16, got {kernel_dtype}")
    if vocab_size <= 0:
        raise ValueError(f"vocab_size must be positive, got {vocab_size}")
    tensors = [sorted_ids, updates]
    if order is not None:
        if order.shape != sorted_ids.shape or order.dtype != torch.int32:
            raise ValueError(
                f"order must be int32 of shape {tuple(sorted_ids.shape)}, "
                f"got {order.dtype} {tuple(order.shape)}"
            )
        tensors.append(order)
    if any(t.device != updates.device for t in tensors):
        raise ValueError("sorted_ids, updates and order must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sorted_ids, updates and order must be contiguous")


def sorted_scatter_add_ref(
    sorted_ids: torch.Tensor,
    updates: torch.Tensor,
    vocab_size: int,
    order: torch.Tensor | None = None,
    kernel_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of ``sorted_scatter_add``: ``index_add_`` of
    the (permuted, ``kernel_dtype``-rounded) updates over the ids in
    ``[0, vocab_size)``."""
    upd = updates if order is None else updates.index_select(0, order.long())
    upd = upd.to(kernel_dtype).to(torch.float32)
    ids = sorted_ids.long()
    keep = (ids >= 0) & (ids < vocab_size)
    out = torch.zeros(
        (vocab_size, updates.shape[1]), dtype=torch.float32, device=updates.device
    )
    return out.index_add_(0, ids[keep], upd[keep])


def sorted_scatter_add(
    sorted_ids: torch.Tensor,
    updates: torch.Tensor,
    vocab_size: int,
    order: torch.Tensor | None = None,
    kernel_dtype=torch.float32,
    precision=None,
) -> torch.Tensor:
    """Σ updates into a fresh ``[vocab_size, D]`` f32 table.

    ``sorted_ids`` [N] ascending int32; entries outside ``[0, vocab_size)``
    (e.g. the 2^30 pad id) are dropped. ``updates`` [N, D] f32 or bf16:
    already in sorted order when ``order`` is None; otherwise in original
    order, with ``order`` [N] int32 the permutation such that
    ``updates[order]`` is sorted (the kernel reads it as a row gather).

    ``kernel_dtype=torch.bfloat16`` rounds each contribution to bf16 before
    the f32 accumulation. Accumulation is always exact f32; ``precision``
    is accepted for signature parity with the JAX function, whose TPU
    DEFAULT precision rounded operands to bf16 (``PARITY.md``).

    CPU tensors take ``sorted_scatter_add_ref``. CUDA tensors launch the
    kernel's two passes (module docstring) on the current stream, with
    ``torch.zeros`` for the output and ``torch.empty`` scratch for the
    partial rows of runs that cross chunk boundaries, or raise; there is
    no host sync. ``sorted_scatter_add.launches`` counts calls that
    launched the kernel, not CUDA launches.
    """
    del precision
    _check_scatter_args(sorted_ids, updates, vocab_size, order, kernel_dtype)
    if updates.device.type == "cpu":
        return sorted_scatter_add_ref(
            sorted_ids, updates, vocab_size, order=order, kernel_dtype=kernel_dtype
        )
    if updates.device.type != "cuda":
        raise ValueError(f"sorted_scatter_add: unsupported device {updates.device}")
    n, d = updates.shape
    out = torch.zeros((vocab_size, d), dtype=torch.float32, device=updates.device)
    if n == 0:
        return out
    upd_bf16 = updates.dtype == torch.bfloat16
    round_bf16 = kernel_dtype == torch.bfloat16 and not upd_bf16
    vec = _load_width(d, updates.element_size(), updates.data_ptr())
    slab, slots, chunk = _geometry(d, vec)
    partials = torch.empty(
        (-(-n // chunk), 2, d), dtype=torch.float32, device=updates.device
    )
    fn = _kernel_fn()
    with torch.cuda.device(updates.device):
        err = fn(
            sorted_ids.data_ptr(),
            updates.data_ptr(),
            None if order is None else order.data_ptr(),
            out.data_ptr(),
            partials.data_ptr(),
            n, d, vocab_size, int(upd_bf16), int(round_bf16), vec, slab, slots, chunk,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sorted_scatter_add kernel launch failed: CUDA error {err}")
    sorted_scatter_add.launches += 1
    return out


sorted_scatter_add.launches = 0


def scatter_add_dense(ids: torch.Tensor, updates: torch.Tensor, vocab_size: int):
    """Sort + kernel scatter: the full sparse-gradient path (any id shape)."""
    flat = ids.reshape(-1).to(torch.int32)
    upd = updates.reshape(-1, updates.shape[-1]).contiguous()
    sorted_ids, order = torch.sort(flat, stable=True)
    return sorted_scatter_add(
        sorted_ids, upd, vocab_size, order=order.to(torch.int32)
    )


class _EmbeddingLookup(torch.autograd.Function):
    """``index_select`` gather forward; the backward sorts the flat ids
    (stable) and sums the cotangent rows with the scatter-add kernel, then
    casts the gradient to the table dtype."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        flat = table.index_select(0, ids.reshape(-1))
        return flat.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        grad = scatter_add_dense(ids, cot, ctx.vocab)
        return grad.to(ctx.table_dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` ([*ids.shape, D]) whose table gradient is computed by
    the sorted scatter-add kernel."""
    return _EmbeddingLookup.apply(table, ids)


class _EmbeddingLookupDedup(torch.autograd.Function):
    """``index_select`` gather forward; the backward follows a host dedup
    plan (``data.dedup``) with two scatter-add kernel calls: a segment sum
    of the cotangent rows into their unique slots, then a scatter of the
    unique rows into the table. Nothing is sorted on the device."""

    @staticmethod
    def forward(ctx, table, ids, perm, slot, uniq):
        ctx.save_for_backward(perm, slot, uniq)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        flat = table.index_select(0, ids.reshape(-1))
        return flat.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, cot):
        perm, slot, uniq = ctx.saved_tensors
        cot2 = cot.reshape(-1, cot.shape[-1]).contiguous()
        d_uniq = sorted_scatter_add(slot, cot2, uniq.shape[0], order=perm)
        # the unique rows' sums come back in the cotangent's dtype (rounded
        # to nearest for a bf16 table) before the second scatter, as in JAX
        grad = sorted_scatter_add(uniq, d_uniq.to(cot2.dtype), ctx.vocab)
        return grad.to(ctx.table_dtype), None, None, None, None


def embedding_lookup_dedup(
    table: torch.Tensor,
    ids: torch.Tensor,
    perm: torch.Tensor,
    slot_sorted: torch.Tensor,
    uniq: torch.Tensor,
) -> torch.Tensor:
    """``table[ids]`` whose table gradient follows a host-precomputed dedup
    plan (``data.dedup.build_plan``): ``perm`` and ``slot_sorted`` int32
    [N = ids.numel()], ``uniq`` int32 [U_cap] ascending, padded with ids
    >= 2^30 (dropped by the kernel). Replicated tables with the whole batch
    on one device."""
    n = ids.numel()
    if perm.shape != (n,) or slot_sorted.shape != (n,) or uniq.dim() != 1:
        raise ValueError(
            f"a dedup plan for {n} ids needs perm and slot of shape ({n},) and a 1-D uniq, "
            f"got {tuple(perm.shape)}, {tuple(slot_sorted.shape)}, {tuple(uniq.shape)}"
        )
    return _EmbeddingLookupDedup.apply(table, ids, perm, slot_sorted, uniq)
