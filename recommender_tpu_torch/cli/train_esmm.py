"""Multi-task CTR/CVR entry: BASE / ESMM / MMOE.

Port of ``recommender_tpu/cli/train_esmm.py``, for one device.

Usage:
  python -m recommender_tpu_torch.cli.train_esmm --model_type MMOE --synthetic
  python -m recommender_tpu_torch.cli.train_esmm --model_type ESMM \
      --train_npz aliccp/train_subsampled.npz --test_npz aliccp/test.npz
  python -m recommender_tpu_torch.cli.train_esmm --synthetic --device cpu

ESMM and MMOE train jointly on impressions, then report CVR AUC (clicked
test rows, purchase label) and CTCVR AUC (all test rows, purchase label) in
the final line; ``--resume`` restarts the stream at batch ``step`` and a
checkpoint is written at the end. ``--model_type BASE`` runs the two-model
protocol: a CTR model on impressions, a CVR model on the clicked rows, and
CTCVR AUC of their product; it leaves no single checkpoint, so
``--checkpoint_dir`` and ``--resume`` are refused with it.

An npz's tables take ``max + 1`` rows per column of the train split, as in
JAX; a test id outside them is refused on the host with a ``ValueError``
(JAX's gather returns without an error there; on the card the lookup would
stop on a device assert). The sharded-table planner (``--mesh_model`` > 1,
``--replicate_below_mb``) is the sharded-table slice's.
"""
from __future__ import annotations

import numpy as np
import torch

from recommender_tpu_torch.cli.common import (
    base_parser,
    build_trainer,
    make_logger,
    parse_args,
    resolve_device,
)
from recommender_tpu_torch.core.metrics import StreamingAUC
from recommender_tpu_torch.data.aliccp import click_only
from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticMultiTask
from recommender_tpu_torch.models.esmm import ESMM, MMOE, MultiTaskBase
from recommender_tpu_torch.models.tasks import (
    evaluate_head,
    init_model,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
)


def check_ids_in_range(features: np.ndarray, sizes, what: str):
    """Raise ``ValueError`` where a column holds an id outside its table."""
    sizes = np.asarray(sizes)
    if features.shape[1] != len(sizes):
        raise ValueError(f"{what}: {features.shape[1]} feature columns for {len(sizes)} tables")
    bad = (features < 0) | (features >= sizes[None, :])
    if bad.any():
        row, col = np.argwhere(bad)[0]
        raise ValueError(
            f"{what}: {int(bad.sum())} ids fall outside their tables, e.g. row {row}, column "
            f"{col}: id {features[row, col]} for a table of {sizes[col]} rows (the tables are "
            "sized from the train split)"
        )


def main(argv=None):
    p = base_parser("Multi-task CTR/CVR training (BASE/ESMM/MMOE)")
    p.add_argument("--model_type", choices=["BASE", "ESMM", "MMOE"], default="ESMM")
    p.add_argument("--embedding_size", type=int, default=18)
    p.add_argument("--train_npz", type=str, default="", help="npz with features/click/purchase")
    p.add_argument("--test_npz", type=str, default="")
    p.add_argument("--replicate_below_mb", type=float, default=32.0,
                   help="planner threshold; acts only with --mesh_model > 1, which is not "
                        "ported yet")
    args = parse_args(p, argv)
    if args.model_type == "BASE" and (args.checkpoint_dir or args.resume):
        raise SystemExit("--model_type BASE trains two models and writes no checkpoint; "
                         "drop --checkpoint_dir and --resume")
    device = resolve_device(args)
    log = make_logger(args)

    if args.synthetic or not args.train_npz:
        gen = SyntheticMultiTask(seed=args.seed)
        train = gen.sample(100_000, seed=1)
        test = gen.sample(20_000, seed=2)
        sizes = list(gen.vocab_sizes)
    else:
        train = dict(np.load(args.train_npz))
        test = dict(np.load(args.test_npz))
        sizes = (train["features"].max(axis=0) + 1).tolist()
    check_ids_in_range(test["features"], sizes, "the test split")
    train_bs, test_bs = args.train_batch_size, args.test_batch_size

    if args.model_type == "BASE":
        # the two-model protocol: a CTR model on impressions, a CVR model on clicks
        models = {}
        for role, label in (("ctr", "click"), ("cvr", "purchase")):
            role_log = make_logger(args, prefix=f"{role}/")
            arrays = dict(train if role == "ctr" else click_only(train))
            arrays["label"] = arrays[label]
            model = MultiTaskBase(vocab_sizes=sizes, embed_dim=args.embedding_size,
                                  device=device)
            loss_fn, eval_fn = make_ctr_task(model)
            trainer = build_trainer(args, loss_fn, eval_fn, device=device)
            state = trainer.init_state(lambda: init_model(model, seed=args.seed))
            it = batch_iterator(arrays, train_bs, seed=args.seed, epochs=None)
            state, _ = trainer.fit(state, it, steps=args.steps, log_fn=role_log)
            models[role] = (model, state, trainer)
        # CTCVR eval: the product of both models on impressions
        (ctr_m, _, tr), (cvr_m, _, _) = models["ctr"], models["cvr"]
        ctr_m.eval()
        cvr_m.eval()
        auc = StreamingAUC(device=device)
        with torch.no_grad():
            for batch in batch_iterator(test, test_bs, shuffle=False):
                b = tr.put_batch(batch)
                auc.update_state(b["purchase"], ctr_m(b) * cvr_m(b))
        log({"final": 1, "ctcvr_auc": auc.result()})
        return models

    model_cls = ESMM if args.model_type == "ESMM" else MMOE
    model = model_cls(vocab_sizes=sizes, embed_dim=args.embedding_size, device=device)
    loss_fn, eval_fn = make_multitask_task(model)
    trainer = build_trainer(args, loss_fn, eval_fn, device=device)
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    # start_batch resumes the data stream where the restored step left off
    it = batch_iterator(train, train_bs, seed=args.seed, epochs=None, start_batch=state.step)
    state, _ = trainer.fit(state, it, steps=args.steps, log_fn=log)

    clicks = click_only(test)
    n_clicks = len(clicks["click"])
    cvr_bs = max(min(test_bs, n_clicks), 1)
    cvr_auc = evaluate_head(
        trainer, state, batch_iterator(clicks, cvr_bs, shuffle=False),
        make_head_eval(model, "cvr", "purchase"),
    )
    ctcvr_auc = evaluate_head(
        trainer, state, batch_iterator(test, test_bs, shuffle=False),
        make_head_eval(model, "ctcvr", "purchase"),
    )
    log({"final": 1, "cvr_auc": cvr_auc, "ctcvr_auc": ctcvr_auc})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()
