"""Host-side embedding-ID dedup plans (``native/libdedup.so`` + numpy fallback).

A copy of ``recommender_tpu/data/dedup.py`` (the JAX package's ``data``
namespace imports jax on load). For the same ids it returns the same
plan, bit for bit (``tests/test_torch_dedup.py``).

Zipf-skewed CTR traffic is highly repetitive: the DLRM batch (8192 x 26 ids
into the 1M x 16 table) carries ~213k lookup rows but only ~36k unique ids.
The input pipeline precomputes a per-batch dedup plan here (in a producer
thread, overlapped with the device step) and
``ops.embedding_kernels.embedding_lookup_dedup`` segment-sums cotangents
into unique rows before the ~6x smaller table scatter.

A plan is three int32 arrays:

  perm        [N]      positions of the flattened ids, sorted by id (stable)
  slot_sorted [N]      unique-slot index per sorted position (nondecreasing)
  uniq        [U_cap]  ascending unique ids, padded with PAD_ID (2^30 —
                       dropped by ``sorted_scatter_add``)

The C++ radix-sort plan is loaded through ctypes (and built with ``make -C
native`` at first use where the library is missing); the numpy fallback
(``np.unique``, ~25x slower) exists for correctness and tests.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from pathlib import Path

import numpy as np

PAD_ID = np.int32(2**30)  # dropped by ops.embedding_kernels.sorted_scatter_add

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libdedup.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dedup_plan.argtypes = [
        i32p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.dedup_plan.restype = ctypes.c_int64
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


@dataclasses.dataclass(frozen=True)
class DedupPlan:
    perm: np.ndarray  # [N] int32
    slot_sorted: np.ndarray  # [N] int32
    uniq: np.ndarray  # [U_cap] int32, ascending, PAD_ID-padded
    n_unique: int


def build_plan(ids: np.ndarray, u_cap: int) -> DedupPlan | None:
    """Dedup plan for flattened ``ids`` (non-negative int), or None if the
    batch has more than ``u_cap`` unique ids (the caller then takes the
    plain lookup for that batch)."""
    flat = np.ascontiguousarray(ids.reshape(-1), dtype=np.int32)
    n = flat.size
    lib = _load()
    if lib is not None:
        perm = np.empty(n, np.int32)
        slot = np.empty(n, np.int32)
        uniq = np.empty(u_cap, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n_uniq = lib.dedup_plan(
            flat.ctypes.data_as(i32p), n,
            perm.ctypes.data_as(i32p), slot.ctypes.data_as(i32p),
            uniq.ctypes.data_as(i32p), u_cap, ctypes.c_int32(PAD_ID),
        )
        if n_uniq < 0:
            return None
        return DedupPlan(perm, slot, uniq, int(n_uniq))
    # numpy fallback (sort-based; ~25x slower — tests/correctness only)
    uniq_v, inv = np.unique(flat, return_inverse=True)
    if uniq_v.size > u_cap:
        return None
    perm = np.argsort(inv, kind="stable").astype(np.int32)
    slot = inv[perm].astype(np.int32)
    uniq = np.full(u_cap, PAD_ID, np.int32)
    uniq[: uniq_v.size] = uniq_v
    return DedupPlan(perm, slot, uniq, int(uniq_v.size))
