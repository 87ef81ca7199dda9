"""Flash attention with a segment-id key mask (K2), at any head dim.

Port of the attention kernel that ``recommender_tpu/nn/transformer.py::
_flash_mha`` reaches: JAX's Pallas TPU ``flash_attention`` (its forward and
its two backward kernels). Here the kernels are hand-written CUDA, bound
through ``_FlashMHA``, a ``torch.autograd.Function``. The forward
(``csrc/flash_attention.cu``) saves the row log-sum-exp and takes one of
two routes, which ``fwd_route`` picks from the shape:

* ``"fused"``: one block per batch row holds q, k and v of all its heads
  and writes o and lse. It takes L up to ``FUSED_MAX_L`` where the block's
  shared memory (``fwd_smem_bytes``) fits; BST's L 101, H 4, Dh 9 does.
  Above Dh 64 the route picks it only at Dh <= 128 where H * Dh is not a
  multiple of 32 (``fwd_route``, from the card's times);
* ``"long"``: a block owns 64 queries of one head and streams the keys in
  tiles of 64.

The backward (``csrc/flash_attention_bwd.cu``) takes one of two routes,
which ``bwd_route`` picks:

* ``"fused"``: one launch computes ``di = rowsum(dO * O)``, dQ, dK and dV,
  one block per batch row holding all its heads, where its shared memory
  (``fused_smem_bytes``) fits at L up to ``FUSED_MAX_L``; above Dh 64 one
  block per batch row and head, at every L up to ``FUSED_MAX_L``, which
  computes S and dP once over the whole Dh and streams the 64-column
  chunks of q, k, v and dO through a ring of ``wide_fused_bwd_slots``
  slots (its shared memory follows L alone);
* ``"long"``: the wrapper computes ``di``, then a dK/dV kernel and a dQ
  kernel run, each streaming the other side's rows in tiles of 64.

Both sets of kernels run on the tensor cores at f32 accuracy (3xTF32).
Each file instantiates its kernels by head dim: Dh up to 64 padded to a
multiple of 8, the rows a warp owns kept in registers; any wider Dh in
chunks of 64 columns (``csrc/flash_mma.cuh``, "Head dims"). Above Dh 64
the long forward's blocks, the fused forward's warps and the long
backward's blocks own a group of output columns (``wide_fwd_groups``,
``wide_bwd_groups``), over which they compute the scores once; the long
backward's blocks take a fixed shared memory (``wide_bwd_smem_bytes``).

Semantics are the TPU kernel's ``SegmentIds(seg, seg)`` with
``seg = valid``: key j is visible to query i iff ``valid[b, i] ==
valid[b, j]``, so a pad query attends to the pad keys. Valid query rows
therefore agree with the plain branch of ``TransformerBlock`` (every query
attends to the valid keys); pad rows differ, and no caller reads them. The
JAX wrapper pads L to a multiple of 128 and Dh to 128 lanes; the port pads
neither, so its pad rows see only the real pad positions.

``flash_mha`` launches the kernels for CUDA tensors and counts the
launches in ``flash_mha.launches_fwd`` (every forward),
``.launches_fwd_fused`` and ``.launches_fwd_long`` (the forward by route),
``.launches_bwd`` (fused backward), ``.launches_bwd_dkv`` and
``.launches_bwd_dq`` (long backward). For CPU
tensors it computes the same function with ``flash_mha_ref``, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernels
against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from recommender_tpu_torch.ops import _build

FUSED_MAX_L = 128
# shared memory one block may use on Hopper (227 KB)
MAX_BLOCK_SMEM = 232_448


def _span(L: int, H: int, Dh: int) -> int:
    """Floats of one tensor's [L, H, Dh] span in a fused block: rounded up
    to 16 bytes, then 16 zeros (``fused_span`` in ``csrc/flash_mma.cuh``)."""
    return -(-L * H * Dh // 4) * 4 + 16


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def fwd_smem_bytes(L: int, H: int, Dh: int) -> int:
    """Shared memory of one fused-forward block (one batch row): the q, k
    and v spans with L rounded up to 8 rows of zeros, lse [H, L] and seg
    [round8(L)]. The same count as ``fwd_smem_bytes`` in
    ``csrc/flash_attention.cu``."""
    return 4 * (3 * _span(_round8(L), H, Dh) + H * L + _round8(L))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


# the most ring slots a wide fused-backward block takes
WIDE_FUSED_BWD_MAX_SLOTS = 6


def _wide_fused_rest(lp: int) -> int:
    """Floats of a wide fused-backward block besides its ring: P^T, then
    dS^T [lp, lp + 4]; lse, di and seg [lp]."""
    return lp * (lp + 4) + 3 * lp


def wide_fused_bwd_slots(L: int) -> int:
    """Ring slots of the wide fused backward's block (Dh > 64), each one
    swizzled [round16(L), 64] chunk tile: ``WIDE_FUSED_BWD_MAX_SLOTS``, or as
    many as fit ``MAX_BLOCK_SMEM`` beside the rest of the block (4 at L
    113-128). The same count as ``wide_fused_slots`` in
    ``csrc/flash_attention_bwd.cu``."""
    lp = _round16(L)
    return min(WIDE_FUSED_BWD_MAX_SLOTS, (MAX_BLOCK_SMEM // 4 - _wide_fused_rest(lp)) // (lp * 64))


def fused_smem_bytes(L: int, H: int, Dh: int) -> int:
    """Shared memory of one fused-backward block. At Dh <= 64 (one batch
    row): the q, k, v and dO spans; dS^T of one head [L, round16(L) + 8];
    lse and di [H, L]; seg [L]. Above Dh 64 (one batch row and head), a
    function of L alone: the ring's slots (``wide_fused_bwd_slots``), P^T
    then dS^T [round16(L), round16(L) + 4], lse, di and seg [round16(L)].
    The same
    count as ``fused_smem_bytes`` in ``csrc/flash_attention_bwd.cu``."""
    if Dh > 64:
        lp = _round16(L)
        return 4 * (_wide_fused_rest(lp) + wide_fused_bwd_slots(L) * lp * 64)
    lds = _round16(L) + 8
    return 4 * (4 * _span(L, H, Dh) + L * lds + 2 * H * L + L)


def _column_groups(Dh: int) -> int:
    """Groups of output columns above Dh 64 (0 at or below it): 2 chunks of
    64 columns up to Dh 128, else 4 (256 columns). The same count as
    ``wide_groups`` in ``csrc/flash_mma.cuh``."""
    if Dh <= 64:
        return 0
    chunks = -(-Dh // 64)
    per_group = 2 if chunks <= 2 else 4
    return -(-chunks // per_group)


def wide_fwd_groups(Dh: int) -> int:
    """Column groups of the forward above Dh 64 (0 at or below it): blocks
    in grid y of the long kernel, passes of the fused kernel's warps over
    each head. A warp keeps O on a group (64 or 128 floats a lane) and
    computes S over the whole head dim once per group and block of keys:
    once up to Dh 256, twice at 257-512. The count
    ``rtt_flash_attention_fwd_wide_groups`` gives."""
    return _column_groups(Dh)


def wide_bwd_groups(Dh: int) -> int:
    """Blocks in grid y of the long backward's two kernels above Dh 64 (0 at
    or below it), by the same rule. A block computes S and dP over the whole
    head dim once per streamed tile, so this is how many times each is
    computed. The count ``rtt_flash_attention_bwd_wide_groups`` gives."""
    return _column_groups(Dh)


def wide_bwd_smem_bytes(kernel: str) -> int:
    """Shared memory of one block of the long backward's ``"dkv"`` or
    ``"dq"`` kernel above Dh 64, at any Dh: a ring of 2 own-row and 4
    streamed-row slots, each two [64, 64] chunk tiles; phase A's two [64,
    64] results (P and D = dP - di); the row vectors of two streamed tiles
    (lse, di and seg, or seg) and the pieces' liveness [4, 8]. The same
    count as ``wide_bwd_smem_bytes`` in ``csrc/flash_attention_bwd.cu``."""
    vectors = {"dkv": 3, "dq": 1}[kernel]
    tile = 64 * 64
    return 4 * ((2 + 4 + 1) * 2 * tile + 2 * vectors * 64 + 4 * 8)


def _route(L: int, smem: int) -> str:
    return "fused" if L <= FUSED_MAX_L and smem <= MAX_BLOCK_SMEM else "long"


def fwd_route(L: int, H: int, Dh: int) -> str:
    """The forward's route: ``"fused"`` where one block holds a batch row
    (L <= ``FUSED_MAX_L`` and ``fwd_smem_bytes`` within ``MAX_BLOCK_SMEM``),
    else ``"long"``. Above Dh 64 the fused kernel takes only Dh <= 128 (its
    warps keep O on one group of 2 chunks) where the rows of its spans are
    not a multiple of 32 floats apart (H * Dh % 32 != 0; where they are,
    every B read of 8 rows falls in one bank): the long kernel was the
    faster at every other shape ``chip_smoke.py``'s ``k2_routes`` timed on
    the card, and the fused one at each of these (``PERF.md``)."""
    if Dh > 64 and (Dh > 128 or H * Dh % 32 == 0):
        return "long"
    return _route(L, fwd_smem_bytes(L, H, Dh))


def bwd_route(L: int, H: int, Dh: int) -> str:
    """The backward's route: ``"fused"`` where one block holds a batch row
    (L <= ``FUSED_MAX_L`` and ``fused_smem_bytes`` within
    ``MAX_BLOCK_SMEM``; above Dh 64 a block holds one head of a batch row
    and every L <= ``FUSED_MAX_L`` fits), else ``"long"``."""
    return _route(L, fused_smem_bytes(L, H, Dh))


@functools.lru_cache(maxsize=None)
def _kernel_fns() -> dict:
    """The C entries of ``csrc/flash_attention.cu`` (``fwd_fused``,
    ``fwd_long``) and ``csrc/flash_attention_bwd.cu`` (``bwd_fused``,
    ``bwd_dkv``, ``bwd_dq``), built at first use."""
    libs = {"fwd": _build.load("flash_attention"), "bwd": _build.load("flash_attention_bwd")}
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32, i32, i32, i32, f32, vp]  # B, L, H, Dh, scale, stream
    fns = {}
    for name, pointers in (("fwd_fused", 6), ("fwd_long", 6), ("bwd_fused", 10),
                           ("bwd_dkv", 9), ("bwd_dq", 8)):
        fn = getattr(libs[name[:3]], f"rtt_flash_attention_{name}")
        fn.argtypes, fn.restype = [vp] * pointers + dims, i32
        fns[name] = fn
    return fns


def _check_args(q, k, v, valid):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be [B, L, H, Dh] of one shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    B, L, H, Dh = q.shape
    if min(B, L, H, Dh) < 1:
        raise ValueError(f"needs B, L, H, Dh >= 1, got {tuple(q.shape)}")
    if valid.shape != (B, L):
        raise ValueError(f"valid must be [B, L] = {(B, L)}, got {tuple(valid.shape)}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"q, k, v must be float32, got {q.dtype} {k.dtype} {v.dtype}")
    if any(t.device != q.device for t in (k, v, valid)):
        raise ValueError("q, k, v and valid must be on one device")


def _scale(head_dim: int) -> float:
    return 1.0 / (head_dim ** 0.5)  # by the real head dim, as the JAX wrapper


def flash_mha_ref(q, k, v, valid) -> torch.Tensor:
    """Plain PyTorch version of ``flash_mha``: the [B, H, L, L] scores are
    materialized, masked by segment equality and soft-maxed."""
    seg = valid.to(torch.int32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(q.shape[-1])
    same = seg[:, None, :, None] == seg[:, None, None, :]  # [B, 1, L, L]
    s = s.masked_fill(~same, float("-inf"))  # each row keeps its own key
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _launch(name: str, fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {name} kernel launch failed: CUDA error {err}")


class _FlashMHA(torch.autograd.Function):
    """The CUDA kernels as one differentiable op (inputs made contiguous;
    ``seg`` int32 [B, L])."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = _forward(q, k, v, seg)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, seg, o, lse, do.contiguous()), None)


def _forward(q, k, v, seg):
    """o and lse [B, H, L] by the route ``fwd_route`` picks (contiguous
    inputs)."""
    B, L, H, Dh = q.shape
    route = fwd_route(L, H, Dh)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _launch(f"{route} forward", _kernel_fns()[f"fwd_{route}"], q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, L, H, Dh, _scale(Dh))
    flash_mha.launches_fwd += 1
    if route == "fused":
        flash_mha.launches_fwd_fused += 1
    else:
        flash_mha.launches_fwd_long += 1
    return o, lse


def _backward(q, k, v, seg, o, lse, do):
    """dq, dk, dv by the route ``bwd_route`` picks (contiguous inputs)."""
    B, L, H, Dh = q.shape
    fns = _kernel_fns()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dims = (B, L, H, Dh, _scale(Dh))
    if bwd_route(L, H, Dh) == "fused":
        _launch("fused backward", fns["bwd_fused"], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
        flash_mha.launches_bwd += 1
        return dq, dk, dv
    di = (do * o).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, L]
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
              do.data_ptr(), lse.data_ptr(), di.data_ptr())
    _launch("dK/dV", fns["bwd_dkv"], q.device, *common, dk.data_ptr(), dv.data_ptr(), *dims)
    flash_mha.launches_bwd_dkv += 1
    _launch("dQ", fns["bwd_dq"], q.device, *common, dq.data_ptr(), *dims)
    flash_mha.launches_bwd_dq += 1
    return dq, dk, dv


def flash_mha(q, k, v, valid) -> torch.Tensor:
    """Multi-head attention over [B, L, H, Dh] f32 heads-last q, k, v with
    the segment-equality mask of ``valid`` [B, L] (1 = real position,
    0 = pad); returns [B, L, H, Dh]. L and Dh are any length.

    CPU tensors take ``flash_mha_ref``; CUDA tensors launch the kernels,
    or raise."""
    _check_args(q, k, v, valid)
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    return _FlashMHA.apply(q, k, v, valid.to(torch.int32).contiguous())


flash_mha.launches_fwd = 0
flash_mha.launches_fwd_fused = 0
flash_mha.launches_fwd_long = 0
flash_mha.launches_bwd = 0
flash_mha.launches_bwd_dkv = 0
flash_mha.launches_bwd_dq = 0
