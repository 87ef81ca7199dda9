"""Amazon Books behavior-sequence pipeline (DIEN family).

A copy of ``recommender_tpu/data/amazon.py`` (numpy only; importing the
original imports jax through its package), with ``dien_batches`` on the
port's ``batch_iterator``. Tests hold its output bit for bit against the
original's.

Real-format parity with the reference implementation's ``dien`` package:
* ``build_vocab`` — item/cat vocab dicts from the ``local_train_splitByUser``
  TSV (fields tab-separated; history lists ``\\x02``-separated), with
  ``mask``→0 and ``unk``→last-index rows plus an item→cat map
  (``dien/util.py:4-37``). Divergence (documented): the reference's
  ``index_cat_id`` tests ``cat_id in cat_id`` — always true — so unknown
  categories crash instead of mapping to unk (``dien/data_loader.py:32``);
  we map unknowns to ``unk`` as obviously intended.
* ``encode_dataset`` — vectorized line parsing: pad histories **post**,
  truncate **pre** (keep most recent) to ``max_len``
  (``dien/data_loader.py:44-48``), producing fixed-shape int32 arrays once,
  up front — instead of the reference's per-line Python generator re-parsing
  every epoch (a known host bottleneck, SURVEY.md §7 Hard parts).
* ``sample_negative_history`` — DIEN's per-step uniform negative items with
  their true categories (``dien/data_loader.py:57-62``), vectorized over the
  whole batch with numpy (no per-example Python loop).
"""
from __future__ import annotations

import json
from typing import Iterator

import numpy as np

from recommender_tpu_torch.data.pipeline import batch_iterator

MASK_TOKEN = "mask"
UNK_TOKEN = "unk"
FIELD_SEP = "\t"
LIST_SEP = "\x02"


def build_vocab(train_file: str):
    """Scan the TSV once; return (item_vocab, cat_vocab, item_id2cat_id)."""
    item_ids, cat_ids = set(), set()
    item2cat: dict[str, str] = {UNK_TOKEN: UNK_TOKEN}
    with open(train_file) as f:
        for line in f:
            parts = line.rstrip("\n").split(FIELD_SEP)
            _, _, item_id, cat_id, his_items, his_cats = parts
            his_i = his_items.split(LIST_SEP)
            his_c = his_cats.split(LIST_SEP)
            item_ids.add(item_id)
            item_ids.update(his_i)
            cat_ids.add(cat_id)
            cat_ids.update(his_c)
            item2cat[item_id] = cat_id
            item2cat.update(zip(his_i, his_c))
    item_vocab = {t: i for i, t in enumerate(sorted(item_ids), start=1)}
    cat_vocab = {t: i for i, t in enumerate(sorted(cat_ids), start=1)}
    item_vocab[MASK_TOKEN] = 0
    item_vocab[UNK_TOKEN] = len(item_vocab)
    cat_vocab[MASK_TOKEN] = 0
    cat_vocab[UNK_TOKEN] = len(cat_vocab)
    return item_vocab, cat_vocab, item2cat


def save_vocab(path_prefix: str, item_vocab, cat_vocab, item2cat):
    for name, obj in [
        ("item_vocab", item_vocab),
        ("cat_vocab", cat_vocab),
        ("item_id2cat_id", item2cat),
    ]:
        with open(f"{path_prefix}/{name}.json", "w") as f:
            json.dump(obj, f)


def load_vocab(path_prefix: str):
    out = []
    for name in ("item_vocab", "cat_vocab", "item_id2cat_id"):
        with open(f"{path_prefix}/{name}.json") as f:
            out.append(json.load(f))
    return tuple(out)


def encode_dataset(
    file: str, item_vocab: dict, cat_vocab: dict, max_len: int = 100
) -> dict:
    """Parse the whole TSV into fixed-shape arrays (one pass, host)."""
    item_unk = item_vocab[UNK_TOKEN]
    cat_unk = cat_vocab[UNK_TOKEN]
    labels, t_items, t_cats = [], [], []
    his_items = []
    his_cats = []
    with open(file) as f:
        for line in f:
            label, _, item_id, cat_id, his_i, his_c = line.rstrip("\n").split(FIELD_SEP)
            labels.append(float(label))
            t_items.append(item_vocab.get(item_id, item_unk))
            t_cats.append(cat_vocab.get(cat_id, cat_unk))
            hi = [item_vocab.get(x, item_unk) for x in his_i.split(LIST_SEP)]
            hc = [cat_vocab.get(x, cat_unk) for x in his_c.split(LIST_SEP)]
            # pre-truncate (keep the most recent), post-pad with 0
            hi, hc = hi[-max_len:], hc[-max_len:]
            his_items.append(hi + [0] * (max_len - len(hi)))
            his_cats.append(hc + [0] * (max_len - len(hc)))
    return {
        "label": np.asarray(labels, np.float32),
        "target_item": np.asarray(t_items, np.int32),
        "target_cat": np.asarray(t_cats, np.int32),
        "pos_his_item": np.asarray(his_items, np.int32),
        "pos_his_cat": np.asarray(his_cats, np.int32),
    }


def make_item2cat_array(item_vocab, cat_vocab, item2cat) -> np.ndarray:
    """Dense item-idx → cat-idx map for vectorized negative sampling."""
    arr = np.zeros(len(item_vocab), np.int32)
    cat_unk = cat_vocab[UNK_TOKEN]
    for item_id, idx in item_vocab.items():
        cat_id = item2cat.get(item_id, UNK_TOKEN)
        arr[idx] = cat_vocab.get(cat_id, cat_unk)
    return arr


def sample_negative_history(
    batch: dict, item_vocab_size: int, item2cat_arr: np.ndarray, rng: np.random.Generator
) -> dict:
    """Add DIEN's per-step uniform negatives (ids in [1, V), true categories)."""
    shape = batch["pos_his_item"].shape
    neg_items = rng.integers(1, item_vocab_size, size=shape).astype(np.int32)
    out = dict(batch)
    out["neg_his_item"] = neg_items
    out["neg_his_cat"] = item2cat_arr[neg_items]
    return out


def dien_batches(
    arrays: dict,
    batch_size: int,
    item_vocab_size: int,
    item2cat_arr: np.ndarray,
    *,
    sample_negative: bool,
    seed: int = 0,
    epochs: int | None = 1,
) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    for batch in batch_iterator(arrays, batch_size, seed=seed, epochs=epochs):
        if sample_negative:
            batch = sample_negative_history(batch, item_vocab_size, item2cat_arr, rng)
        yield batch
