"""Offline batch prediction from a training checkpoint of the port.

Port of ``recommender_tpu/cli/predict.py``, for one device.

Usage:
  # score an npz of feature arrays with a trained DLRM checkpoint
  python -m recommender_tpu_torch.cli.predict --family ctr --model_type DLRM \
      --checkpoint_dir ckpt/ --vocab_size 1000000 \
      --input features.npz --output scores.npz

  # smoke-run on the built-in synthetic features
  python -m recommender_tpu_torch.cli.predict --family ctr --model_type DCN \
      --checkpoint_dir ckpt/ --vocab_size 2000 --synthetic --output scores.npz

  # the ctr, cvr and ctcvr heads of a train_esmm checkpoint
  python -m recommender_tpu_torch.cli.predict --family esmm --model_type MMOE \
      --checkpoint_dir ckpt/ --input features.npz --output scores.npz

The model flags must match the training run's (``--model_type``,
``--vocab_size``, ``--embedding_size``; for ``--family dien``
``--item_vocab`` and ``--cat_vocab``). ``--family ctr`` builds the model
with ``cli.train_ctr.build_model``, the function the trainer used, so DCN
is DCN and DLRM's bottom MLP ends at ``--embedding_size``; the table dtype
(f32 or bf16) is the checkpoint's. ``--family dien`` builds from
``cli.train_dien.MODELS``. ``--family esmm`` builds ESMM or MMOE with the
checkpoint's per-feature tables: their number, rows (an npz-trained run
sizes each column's table from its data) and width; BASE trains two models
and leaves no single checkpoint, so it is refused, and so are input ids
outside the tables. The checkpoint is restored through ``Trainer.restore``
(the newest ``step_<n>.pt``). Output npz: one array per head, row-aligned
with the input (``score``; ``ctr``, ``cvr`` and ``ctcvr`` for
``--family esmm``), and one JSON line.
"""
from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from recommender_tpu_torch.cli.common import log_jsonl, resolve_device
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.retrieval.scoring import make_scorer, score_batches

_MULTI_TASK_TYPES = ("ESMM", "MMOE")


def _build_model(args, tables: dict, device):
    embed_param_dtype = next(iter(tables.values()))[1]
    if args.family == "esmm":
        from recommender_tpu_torch.models.esmm import ESMM, MMOE

        cls = ESMM if args.model_type == "ESMM" else MMOE
        return cls(vocab_sizes=_feature_sizes(tables), embed_dim=_feature_width(tables),
                   embed_param_dtype=embed_param_dtype, device=device)
    if args.family == "ctr":
        from recommender_tpu_torch.cli.train_ctr import build_model

        return build_model(args.model_type, args.vocab_size, args.embedding_size,
                           embed_param_dtype, device)
    from recommender_tpu_torch.cli.train_dien import MODELS as DIEN_MODELS

    return DIEN_MODELS[args.model_type](
        item_vocab=args.item_vocab, cat_vocab=args.cat_vocab,
        item_dim=args.embedding_size, cat_dim=args.embedding_size,
        embed_param_dtype=embed_param_dtype, device=device,
    )


def _feature_sizes(tables: dict) -> list[int]:
    """The rows of a multi-task checkpoint's tables ``embedder.feat_{j}``."""
    return [shape[0] for shape, _ in tables.values()]


def _feature_width(tables: dict) -> int:
    return tables["embedder.feat_0.embedding"][0][1]


def _synthetic_features(args, tables: dict):
    if args.family == "esmm":
        from recommender_tpu_torch.data.synthetic import SyntheticMultiTask

        sizes = _feature_sizes(tables)
        return SyntheticMultiTask(
            num_feats=len(sizes), vocab_sizes=tuple(sizes), seed=1
        ).sample(args.batch_size * 4, seed=2)
    if args.family == "ctr":
        from recommender_tpu_torch.data.synthetic import SyntheticCTR

        return SyntheticCTR(vocab_size=args.vocab_size, seed=1).sample(
            args.batch_size * 4, seed=2
        )
    from recommender_tpu_torch.data.synthetic import SyntheticSequence

    return SyntheticSequence(
        num_items=args.item_vocab, num_cats=args.cat_vocab, seed=1
    ).sample(args.batch_size * 4, seed=2)


def _tables(path: str, family: str) -> dict:
    """``{name: (shape, dtype)}`` of a checkpoint file's embedding tables,
    read without loading its tensors: a multi-task checkpoint's per-feature
    tables ``embedder.feat_{j}``, else the tables named ``*embedding``
    (``embedding``, ``item_embedding``, ``cat_embedding``)."""
    model = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["model"]
    if family == "esmm":
        names = list(itertools.takewhile(
            model.__contains__, (f"embedder.feat_{j}.embedding" for j in itertools.count())))
    else:
        names = [k for k in model if k.endswith("embedding.embedding")]
    if not names:
        raise SystemExit(f"{path} holds no embedding table" + (
            " embedder.feat_<j>: not a train_esmm ESMM or MMOE checkpoint"
            if family == "esmm" else ""))
    return {k: (tuple(model[k].shape), model[k].dtype) for k in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description="batch prediction from a checkpoint")
    ap.add_argument("--family", choices=["ctr", "dien", "esmm"], required=True)
    ap.add_argument("--model_type", type=str, default="DLRM")
    ap.add_argument("--checkpoint_dir", type=str, required=True)
    ap.add_argument("--input", type=str, default="",
                    help="npz of feature arrays (omit with --synthetic)")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--vocab_size", type=int, default=1_000_000)
    ap.add_argument("--embedding_size", type=int, default=16)
    ap.add_argument("--item_vocab", type=int, default=400_000)
    ap.add_argument("--cat_vocab", type=int, default=1500)
    ap.add_argument("--num_features", type=int, default=18,
                    help="unused: --family esmm takes the feature count, each table's rows "
                         "and the width from the checkpoint")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to score on; 'cuda' needs a card")
    args = ap.parse_args(argv)
    if args.family == "esmm" and args.model_type not in _MULTI_TASK_TYPES:
        raise SystemExit(
            f"--family esmm --model_type {args.model_type}: one of {_MULTI_TASK_TYPES}; the "
            "BASE protocol trains two models and leaves no single checkpoint to score"
        )
    device = resolve_device(args)

    # restore through the Trainer (the step_<n>.pt files the train CLIs wrote)
    cfg = TrainConfig(checkpoint_dir=args.checkpoint_dir)
    probe = Trainer(lambda *a: None, cfg, device=device)  # no training: loss_fn unused
    found = probe._checkpoints()
    if not found:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
    tables = _tables(found[-1][1], args.family)
    model = _build_model(args, tables, device)
    state = probe.init_state(lambda: model)
    restored = probe.restore(state)

    arrays = (
        _synthetic_features(args, tables)
        if args.synthetic
        else dict(np.load(args.input, allow_pickle=False))
    )
    if args.family == "esmm":
        from recommender_tpu_torch.cli.train_esmm import check_ids_in_range

        check_ids_in_range(arrays["features"], _feature_sizes(tables), "the input")
    n = len(next(iter(arrays.values())))
    scorer = make_scorer(restored.model)
    t0 = time.perf_counter()
    scores = score_batches(
        scorer,
        batch_iterator(arrays, args.batch_size, shuffle=False, drop_remainder=False),
        args.batch_size,
    )
    dt = time.perf_counter() - t0
    np.savez(args.output, **scores)
    log_jsonl({
        "predicted": n,
        "heads": sorted(scores),
        "step": restored.step,
        "examples_per_s": n / max(dt, 1e-9),
        "output": args.output,
    })
    return scores


if __name__ == "__main__":
    main()
