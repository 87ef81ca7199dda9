"""ctypes bindings for the native graph sampler (``native/libgraph_sampler.so``).

A copy of ``recommender_tpu/graph/native.py`` (the JAX package's ``graph``
namespace imports jax on load): the alias-table and walk bindings and the
PinSage samplers' (importance neighbours, the item→user→item metapath).
The library is the same file the JAX package loads.

Auto-builds with ``make -C native`` on first use if the shared library is
missing and a toolchain is available; otherwise callers fall back to the
numpy reference implementations in ``store.py`` / ``walks.py`` /
``bipartite.py`` (same
behaviour, slower). ``is_available()`` reports which path is active.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgraph_sampler.so"
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

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.build_alias_tables.argtypes = [i64p, ctypes.c_int64, f32p, f32p, i32p]
    lib.weighted_random_walks.argtypes = [
        i64p, i32p, f32p, i32p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i32p,
    ]
    lib.pinsage_importance_neighbors.argtypes = [
        i64p, i32p, i64p, i32p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, i32p, ctypes.c_int64, ctypes.c_uint64, i32p, f32p,
    ]
    lib.metapath_i2u2i.argtypes = [
        i64p, i32p, i64p, i32p, i64p, ctypes.c_int64, ctypes.c_uint64, i64p,
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_alias_tables(indptr: np.ndarray, weights: np.ndarray):
    lib = _load()
    assert lib is not None
    n = len(indptr) - 1
    prob = np.ones(len(weights), np.float32)
    alias = np.zeros(len(weights), np.int32)
    indptr = np.ascontiguousarray(indptr, np.int64)
    w = np.ascontiguousarray(weights, np.float32)
    lib.build_alias_tables(
        _ptr(indptr, ctypes.c_int64), n, _ptr(w, ctypes.c_float),
        _ptr(prob, ctypes.c_float), _ptr(alias, ctypes.c_int32),
    )
    return prob, alias


def weighted_random_walks(indptr, indices, prob, alias, seeds, length, seed):
    lib = _load()
    assert lib is not None
    seeds = np.ascontiguousarray(seeds, np.int32)
    out = np.empty((len(seeds), length + 1), np.int32)
    lib.weighted_random_walks(
        _ptr(np.ascontiguousarray(indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(indices, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(prob, np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(alias, np.int32), ctypes.c_int32),
        _ptr(seeds, ctypes.c_int32),
        len(seeds), length, seed, _ptr(out, ctypes.c_int32),
    )
    return out


def pinsage_importance_neighbors(
    i2u_indptr, i2u_indices, u2i_indptr, u2i_indices, items,
    num_neighbors, num_walks, walk_length, termination_prob, seed,
    exclude=None,
):
    lib = _load()
    assert lib is not None
    items = np.ascontiguousarray(items, np.int64)
    n = len(items)
    out_nbr = np.empty((n, num_neighbors), np.int32)
    out_w = np.empty((n, num_neighbors), np.float32)
    if exclude is not None:
        excl = np.ascontiguousarray(exclude, np.int32)
        excl_ptr = _ptr(excl, ctypes.c_int32)
        num_excl = excl.shape[1]
    else:
        excl_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
        num_excl = 0
    lib.pinsage_importance_neighbors(
        _ptr(np.ascontiguousarray(i2u_indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(i2u_indices, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(u2i_indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(u2i_indices, np.int32), ctypes.c_int32),
        _ptr(items, ctypes.c_int64),
        n, num_neighbors, num_walks, walk_length,
        float(termination_prob), excl_ptr, num_excl, seed,
        _ptr(out_nbr, ctypes.c_int32), _ptr(out_w, ctypes.c_float),
    )
    return out_nbr, out_w


def metapath_i2u2i(i2u_indptr, i2u_indices, u2i_indptr, u2i_indices, items, seed):
    lib = _load()
    assert lib is not None
    items = np.ascontiguousarray(items, np.int64)
    out = np.empty(len(items), np.int64)
    lib.metapath_i2u2i(
        _ptr(np.ascontiguousarray(i2u_indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(i2u_indices, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(u2i_indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(u2i_indices, np.int32), ctypes.c_int32),
        _ptr(items, ctypes.c_int64), len(items), seed,
        _ptr(out, ctypes.c_int64),
    )
    return out
