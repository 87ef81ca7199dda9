"""Flash attention with a segment-id key mask (K2), for small head dims.

Port of the attention kernel that ``recommender_tpu/nn/transformer.py::
_flash_mha`` reaches: JAX's Pallas TPU ``flash_attention`` (its forward and
its two backward kernels). Here the kernels are hand-written CUDA, bound
through ``_FlashMHA``, a ``torch.autograd.Function``: the forward
(``csrc/flash_attention.cu``) saves the row log-sum-exp; the backward
(``csrc/flash_attention_bwd.cu``) takes one of two routes, which
``bwd_route`` picks from the shape:

* ``"fused"``: one launch computes ``di = rowsum(dO * O)``, dQ, dK and dV,
  one block per batch row holding all its heads. It takes L up to
  ``FUSED_MAX_L`` where the block's shared memory (``fused_smem_bytes``)
  fits; BST's L 101, H 4, Dh 9 does;
* ``"long"``: the wrapper computes ``di``, then a dK/dV kernel and a dQ
  kernel run, each streaming the other side's rows in tiles of 64.

Semantics are the TPU kernel's ``SegmentIds(seg, seg)`` with
``seg = valid``: key j is visible to query i iff ``valid[b, i] ==
valid[b, j]``, so a pad query attends to the pad keys. Valid query rows
therefore agree with the plain branch of ``TransformerBlock`` (every query
attends to the valid keys); pad rows differ, and no caller reads them. The
JAX wrapper pads L to a multiple of 128 and Dh to 128 lanes; the port pads
neither, so its pad rows see only the real pad positions.

``flash_mha`` launches the kernels for CUDA tensors and counts the
launches in ``flash_mha.launches_fwd``, ``.launches_bwd`` (fused route),
``.launches_bwd_dkv`` and ``.launches_bwd_dq`` (long route). For CPU
tensors it computes the same function with ``flash_mha_ref``, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernels
against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from recommender_tpu_torch.ops import _build

MAX_HEAD_DIM = 64
FUSED_MAX_L = 128
# shared memory one block may use on Hopper (227 KB)
MAX_BLOCK_SMEM = 232_448


def fused_smem_bytes(L: int, H: int, Dh: int) -> int:
    """Shared memory of one fused-backward block (one batch row): q, k, v
    and dO of all heads, each span rounded up to 16 bytes and followed by 16
    zeros; dS^T of one head [L, round16(L) + 8]; lse and di [H, L]; seg [L].
    The same count as ``fused_smem_bytes`` in ``csrc/flash_attention_bwd.cu``."""
    span = -(-L * H * Dh // 4) * 4 + 16
    lds = -(-L // 16) * 16 + 8
    return 4 * (4 * span + L * lds + 2 * H * L + L)


def bwd_route(L: int, H: int, Dh: int) -> str:
    """``"fused"`` where one block holds a batch row (L <= ``FUSED_MAX_L``
    and ``fused_smem_bytes`` within ``MAX_BLOCK_SMEM``), else ``"long"``."""
    if L <= FUSED_MAX_L and fused_smem_bytes(L, H, Dh) <= MAX_BLOCK_SMEM:
        return "fused"
    return "long"


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The C entries of ``csrc/flash_attention.cu`` (forward) and
    ``csrc/flash_attention_bwd.cu`` (fused, dK/dV, dQ), built at first use."""
    fwd_lib = _build.load("flash_attention")
    bwd_lib = _build.load("flash_attention_bwd")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32, i32, i32, i32, f32, vp]  # B, L, H, Dh, scale, stream
    fwd = fwd_lib.rtt_flash_attention_fwd
    fwd.argtypes = [vp] * 6 + dims
    fused = bwd_lib.rtt_flash_attention_bwd_fused
    fused.argtypes = [vp] * 10 + dims
    dkv = bwd_lib.rtt_flash_attention_bwd_dkv
    dkv.argtypes = [vp] * 9 + dims
    dq = bwd_lib.rtt_flash_attention_bwd_dq
    dq.argtypes = [vp] * 8 + dims
    for fn in (fwd, fused, dkv, dq):
        fn.restype = i32
    return fwd, fused, dkv, dq


def _check_args(q, k, v, valid):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be [B, L, H, Dh] of one shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    B, L, H, Dh = q.shape
    if min(B, L, H) < 1 or not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"needs B, L, H >= 1 and 1 <= Dh <= {MAX_HEAD_DIM}, got {tuple(q.shape)}")
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
        B, L, H, Dh = q.shape
        fwd = _kernel_fns()[0]
        o = torch.empty_like(q)
        lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
        _launch("forward", fwd, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg.data_ptr(), o.data_ptr(), lse.data_ptr(), B, L, H, Dh, _scale(Dh))
        flash_mha.launches_fwd += 1
        ctx.save_for_backward(q, k, v, seg, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, seg, o, lse, do.contiguous()), None)


def _backward(q, k, v, seg, o, lse, do):
    """dq, dk, dv by the route ``bwd_route`` picks (contiguous inputs)."""
    B, L, H, Dh = q.shape
    _, fused, dkv, dq_fn = _kernel_fns()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dims = (B, L, H, Dh, _scale(Dh))
    if bwd_route(L, H, Dh) == "fused":
        _launch("fused backward", fused, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
        flash_mha.launches_bwd += 1
        return dq, dk, dv
    di = (do * o).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, L]
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
              do.data_ptr(), lse.data_ptr(), di.data_ptr())
    _launch("dK/dV", dkv, q.device, *common, dk.data_ptr(), dv.data_ptr(), *dims)
    flash_mha.launches_bwd_dkv += 1
    _launch("dQ", dq_fn, q.device, *common, dq.data_ptr(), *dims)
    flash_mha.launches_bwd_dq += 1
    return dq, dk, dv


def flash_mha(q, k, v, valid) -> torch.Tensor:
    """Multi-head attention over [B, L, H, Dh] f32 heads-last q, k, v with
    the segment-equality mask of ``valid`` [B, L] (1 = real position,
    0 = pad); returns [B, L, H, Dh]. Dh is at most 64; L is any length.

    CPU tensors take ``flash_mha_ref``; CUDA tensors launch the kernels,
    or raise."""
    _check_args(q, k, v, valid)
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    return _FlashMHA.apply(q, k, v, valid.to(torch.int32).contiguous())


flash_mha.launches_fwd = 0
flash_mha.launches_bwd = 0
flash_mha.launches_bwd_dkv = 0
flash_mha.launches_bwd_dq = 0
