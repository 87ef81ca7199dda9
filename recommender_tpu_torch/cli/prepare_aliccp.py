"""A copy of ``recommender_tpu/cli/prepare_aliccp.py``: the same raw files
give the same npz splits (``tests/test_torch_graph_data.py``).

Offline Ali-CCP preparation: raw skeleton/common-feature files → npz splits.

Equivalent of the reference's two-script flow — ``esmm/process_public_dataset.py``
(\\x01\\x02\\x03 k/v join + freq>10 vocab built on TRAIN ONLY, applied to both
splits) followed by ``esmm/tfrecord_io.py`` (impression / 1:5-subsampled /
click-only writers) — emitting numpy splits the ``train_esmm`` CLI consumes
directly instead of TFRecords.

Usage:
  python -m recommender_tpu_torch.cli.prepare_aliccp \
      --train_skeleton sample_skeleton_train.csv \
      --train_common common_features_train.csv \
      --test_skeleton sample_skeleton_test_1.csv \
      --test_common common_features_test_1.csv \
      --out_dir ./aliccp_data

Outputs in --out_dir:
  train_impressions.npz   all joined train rows (click=0∧buy=1 dropped)
  train_subsampled.npz    clicks + every 5th non-click (≈1:5 ratio,
                          ``esmm/tfrecord_io.py:54-84``) — the split the
                          reference trains ESMM/MMOE on
  train_clicks.npz        click=1 rows only (Base-protocol CVR model)
  test.npz                joined test rows, train vocab applied
  vocab.json              per-column vocab sizes (+0/unknown bucket)
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from recommender_tpu_torch.data import aliccp


def _load_rows(skeleton_path: str, common_path: str):
    with open(common_path) as f:
        common = aliccp.load_common_features(f)
    with open(skeleton_path) as f:
        return list(aliccp.join_skeleton(f, common))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Ali-CCP raw → npz splits")
    ap.add_argument("--train_skeleton", required=True)
    ap.add_argument("--train_common", required=True)
    ap.add_argument("--test_skeleton", default="")
    ap.add_argument("--test_common", default="")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--min_count", type=int, default=12,
                    help="keep feature values seen >= this often (reference "
                    "'count > 10' with first-sight-at-0 counting == seen >= 12)")
    ap.add_argument("--subsample", type=int, default=5,
                    help="keep every Nth non-click in the subsampled split")
    args = ap.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    rows = _load_rows(args.train_skeleton, args.train_common)
    vocab = aliccp.build_feature_vocab((v for _, _, v in rows), args.min_count)
    sizes = aliccp.vocab_sizes(vocab)
    (out / "vocab.json").write_text(json.dumps({
        "columns": list(aliccp.USE_COLUMNS), "sizes": sizes,
    }))
    print(f"vocab sizes: {sizes}")

    arrays = aliccp.encode_rows(rows, vocab)
    np.savez(out / "train_impressions.npz", **arrays)
    sub = aliccp.subsample_impressions(arrays, ratio=args.subsample)
    np.savez(out / "train_subsampled.npz", **sub)
    clicks = aliccp.click_only(arrays)
    np.savez(out / "train_clicks.npz", **clicks)
    print(
        f"train: {len(arrays['click'])} impressions "
        f"({int(arrays['click'].sum())} clicks, "
        f"{int(arrays['purchase'].sum())} purchases), "
        f"{len(sub['click'])} subsampled, {len(clicks['click'])} click-only"
    )

    if args.test_skeleton:
        test_rows = _load_rows(args.test_skeleton, args.test_common)
        test = aliccp.encode_rows(test_rows, vocab)
        np.savez(out / "test.npz", **test)
        print(f"test: {len(test['click'])} impressions")


if __name__ == "__main__":
    main()
