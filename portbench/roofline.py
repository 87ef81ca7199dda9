"""Peaks of one NVIDIA H100 SXM and the least time of the port's kernels.

Frozen copies of the arithmetic in ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``TF32_FLOPS``, K1's byte count in ``_k1_case``, ``k2_work`` and the
forward's and backward's ``k2_bounds``), so that a change to the port
cannot move the yardstick.
Peaks are NVIDIA's data sheet figures for the SXM part at its 700 W limit,
dense: 3.35 TB/s of HBM, 495 TFLOP/s in TF32 and 989 TFLOP/s in bf16 on the
tensor cores.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
# an f32-accurate product on the tensor cores is three TF32 products (3xTF32)
F32_ACCURATE_FLOPS = TF32_FLOPS / 3
BF16_FLOPS = 989e12
# the rate a FLOP of each precision is priced at by the step's mfu
PEAK_FLOPS = {"f32": F32_ACCURATE_FLOPS, "bf16": BF16_FLOPS}


def k1_kernel_bytes(n: int, unique: int, dim: int, update_bytes: int, order: bool = True) -> int:
    """Bytes K1's own kernels (its two passes) need for one call: the ``n``
    sorted ids and the ``order`` permutation (int32) and the ``n`` update
    rows of ``dim`` elements read once, and one f32 row written for each
    of the ``unique`` ids. ``chip_smoke.py`` counts the whole fresh
    ``[vocab, D]`` table written instead, which the wrapper's zero fill
    (``torch.zeros``, a kernel of its own) writes, so over K1's kernels
    alone that count overstates their work."""
    return n * 4 * (2 if order else 1) + n * dim * update_bytes + unique * dim * 4


def k1_bound_s(n: int, unique: int, dim: int, update_bytes: int, order: bool = True) -> float:
    """K1's kernels' least time for one call (bound by bytes)."""
    return k1_kernel_bytes(n, unique, dim, update_bytes, order) / HBM_BYTES_PER_S


def k2_work(valid: np.ndarray, heads: int, head_dim: int) -> dict:
    """What K2's function needs at this shape and mask: the (query, key)
    pairs the segment mask keeps (per head, summed), the bytes of one f32
    [B, L, H, Dh] tensor, of one f32 [B, H, L] row vector and of seg."""
    B, L = valid.shape
    nv = (np.asarray(valid) != 0).sum(1).astype(np.float64)
    return dict(pairs=float((nv ** 2 + (L - nv) ** 2).sum()) * heads,
                tensor=B * L * heads * head_dim * 4, rows=B * heads * L * 4, seg=B * L * 4)


def k2_bounds(w: dict, head_dim: int) -> dict:
    """Each K2 function's least time (ms) and what sets it: each input read
    once and each output written once at ``HBM_BYTES_PER_S``, against the
    products the kept pairs need at the rate of the kernels' arithmetic
    (TF32 tensor-core products, three per f32 product)."""
    pd = w["pairs"] * head_dim
    work = {  # bytes, FLOPs
        "fwd": (4 * w["tensor"] + w["rows"] + w["seg"], 3 * 4 * pd),
        "bwd": (8 * w["tensor"] + w["rows"] + w["seg"], 3 * 10 * pd),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / TF32_FLOPS * 1e3
        out[name] = dict(bytes=nbytes, flops=flops, bytes_ms=t_bytes, ops_ms=t_ops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def k2_bound_s(valid: np.ndarray, heads: int, head_dim: int) -> float:
    """The least time of one attention call's forward and backward: the
    functions' bounds, whatever route the kernels take."""
    b = k2_bounds(k2_work(valid, heads, head_dim), head_dim)
    return (b["fwd"]["bound_ms"] + b["bwd"]["bound_ms"]) / 1e3


def peak_time_s(flops: dict) -> float:
    """Seconds the FLOPs by precision (``{"f32": n, "bf16": m}``) take at
    the card's peaks."""
    return sum(n / PEAK_FLOPS[p] for p, n in flops.items())
