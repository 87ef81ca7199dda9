"""Offline Criteo preparation: raw TSV → vocab + npz shards.

Port of ``recommender_tpu/cli/prepare_criteo.py`` (host code, copied): the
same flags, the vocab ``vocab.pkl`` and the shards ``train/shard_{i:05d}.npz``
and ``test/…`` that ``cli.train_ctr --data_dir`` reads, through the port's
``data.criteo`` (the native C++ parser where it builds, else the Python
encoder, which gives the same arrays).

Usage:
  python -m recommender_tpu_torch.cli.prepare_criteo \
      --train train_split.txt --test test_split.txt --out_dir ./criteo_data
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from recommender_tpu_torch.data import criteo


def _encode(path: str, vocab: dict) -> dict:
    arrays = criteo.encode_file_native(path, vocab)
    if arrays is None:  # no native toolchain: the Python encoder
        with open(path) as f:
            arrays = criteo.encode_lines(f, vocab)
    return arrays


def _write_split(arrays: dict, out: Path, shard_rows: int) -> list[str]:
    out.mkdir(parents=True, exist_ok=True)
    n = len(arrays["label"])
    paths = []
    for i, s in enumerate(range(0, n, shard_rows)):
        p = out / f"shard_{i:05d}.npz"
        np.savez(p, **{k: v[s : s + shard_rows] for k, v in arrays.items()})
        paths.append(str(p))
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description="Criteo raw → vocab + npz shards")
    ap.add_argument("--train", required=True)
    ap.add_argument("--test", default="")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--min_count", type=int, default=11)
    ap.add_argument("--shard_rows", type=int, default=500_000)
    args = ap.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(args.train) as f:
        vocab = criteo.build_vocab(f, min_count=args.min_count)
    criteo.save_vocab(vocab, str(out / "vocab.pkl"))
    print(f"vocab: {len(vocab)} values")

    train_paths = _write_split(_encode(args.train, vocab), out / "train", args.shard_rows)
    print(f"train: {len(train_paths)} shards")
    if args.test:
        test_paths = _write_split(_encode(args.test, vocab), out / "test", args.shard_rows)
        print(f"test: {len(test_paths)} shards")


if __name__ == "__main__":
    main()
