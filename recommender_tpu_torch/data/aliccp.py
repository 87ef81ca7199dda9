"""A copy of ``recommender_tpu/data/aliccp.py`` (the JAX package's
``data`` namespace imports jax on load); the same input gives the same
arrays (``tests/test_torch_graph_data.py``).

Ali-CCP multi-task pipeline: raw preprocess, splits, fixed-shape batches.

Behavioral parity with the reference's ``esmm``:
* ``parse_kv_features`` / ``process_raw`` — the ``\\x01\\x02\\x03``-separated
  key/value/weight triple parsing of ``common_features`` and
  ``sample_skeleton`` files, joined by common-feature key; rows with
  click=0 ∧ buy=1 dropped; 18 ``use_columns`` kept
  (``esmm/process_public_dataset.py:42-113``).
* ``build_feature_vocab`` — frequency filter ``count > 10`` (note the
  reference initialises counts at 0 on first sight, i.e. the threshold is
  "seen ≥ 12 times"; we count occurrences and keep ``count >= 12`` to match
  observable behaviour), unknown → 0 (``:84-90,96-101``).
* Splits — ``impressions`` (all rows), ``impressions_subsampled`` (keep
  every 5th non-click → click:non-click ≈ 1:5, ``esmm/tfrecord_io.py:54-84``),
  ``clicks`` (click=1 only, ``:88-113``). Stored as plain numpy arrays
  (the TPU-host replacement for per-row TFRecord protos).

Fixed divergence (documented, SURVEY.md §7 quirks): the reference's demo
``__main__`` passes (tfrecord, raw) swapped to ``write_click_tfrecord``
(``esmm/tfrecord_io.py:154-156``); our API takes arrays, no swap possible.
"""
from __future__ import annotations

import re
from typing import Iterable

import numpy as np

USE_COLUMNS = (
    "101", "121", "122", "124", "125", "126", "127", "128", "129",
    "205", "206", "207", "216", "508", "509", "702", "853", "301",
)
_KV_SPLIT = re.compile("\x01|\x02|\x03")


def parse_kv_features(field: str) -> dict[str, str]:
    """``k\\x02v\\x03w\\x01k\\x02v\\x03w...`` → {k: v} (weights ignored,
    matching the reference which keeps positions 1 of every triple)."""
    kv = _KV_SPLIT.split(field)
    return dict(zip(kv[0::3], kv[1::3]))


def load_common_features(lines: Iterable[str]) -> dict[str, dict[str, str]]:
    out = {}
    for line in lines:
        parts = line.rstrip("\n").split(",")
        out[parts[0]] = parse_kv_features(parts[2])
    return out


def join_skeleton(
    lines: Iterable[str], common: dict[str, dict[str, str]]
) -> Iterable[tuple[int, int, list[str]]]:
    """sample_skeleton rows → (click, buy, raw feature values[18]).

    Row layout (``esmm/process_public_dataset.py:60-73``): sample_id, click,
    buy, common_feature_key, feat_num, kv-field. Drops click=0 ∧ buy=1.
    """
    for line in lines:
        parts = line.rstrip("\n").split(",")
        click, buy = parts[1], parts[2]
        if click == "0" and buy == "1":
            continue
        feats = parse_kv_features(parts[5])
        feats.update(common.get(parts[3], {}))
        yield int(click), int(buy), [feats.get(k, "0") for k in USE_COLUMNS]


def build_feature_vocab(rows: Iterable[list[str]], min_count: int = 12):
    """Per-column value → index (1..N); values seen < min_count drop to 0."""
    counts = [dict() for _ in USE_COLUMNS]
    for values in rows:
        for j, v in enumerate(values):
            counts[j][v] = counts[j].get(v, 0) + 1
    vocab = []
    for c in counts:
        kept = sorted(v for v, n in c.items() if n >= min_count)
        vocab.append({v: i for i, v in enumerate(kept, start=1)})
    return vocab


def encode_rows(rows, vocab) -> dict:
    clicks, buys, feats = [], [], []
    for click, buy, values in rows:
        clicks.append(click)
        buys.append(buy)
        feats.append([vocab[j].get(v, 0) for j, v in enumerate(values)])
    return {
        "features": np.asarray(feats, np.int32),
        "click": np.asarray(clicks, np.float32),
        "purchase": np.asarray(buys, np.float32),
    }


def subsample_impressions(arrays: dict, ratio: int = 5) -> dict:
    """Keep all clicks and every ``ratio``-th non-click (deterministic,
    matching ``esmm/tfrecord_io.py:66-72``)."""
    click = arrays["click"]
    non_click_rank = np.cumsum(click == 0)
    keep = (click == 1) | ((click == 0) & (non_click_rank % ratio == 0))
    return {k: v[keep] for k, v in arrays.items()}


def click_only(arrays: dict) -> dict:
    keep = arrays["click"] == 1
    return {k: v[keep] for k, v in arrays.items()}


def vocab_sizes(vocab) -> list[int]:
    return [len(v) + 1 for v in vocab]  # +1 for the 0/unknown bucket
