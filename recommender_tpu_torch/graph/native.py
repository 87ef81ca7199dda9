"""ctypes bindings for the native graph sampler (``native/libgraph_sampler.so``).

A copy of the alias-table and walk bindings of
``recommender_tpu/graph/native.py`` (the JAX package's ``graph`` namespace
imports jax on load); the PinSage samplers' bindings come with the PinSage
slice. The library is the same file the JAX package loads.

Auto-builds with ``make -C native`` on first use if the shared library is
missing and a toolchain is available; otherwise callers fall back to the
numpy reference implementations in ``store.py`` / ``walks.py`` (same
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
