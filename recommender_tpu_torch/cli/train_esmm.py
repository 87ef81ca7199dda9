"""Multi-task CTR/CVR entry: BASE / ESMM / MMOE.

Port of ``recommender_tpu/cli/train_esmm.py``.

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
stop on a device assert).

Mesh: each rank reads the rows of its data coordinate, and the AUCs sum
over the data axis. With ``--mesh_model`` > 1 the planner
(``embedding.planner``) lays out each feature's table from its id counts on
the train split: tables under ``--replicate_below_mb`` stay replicated, the
others are row-sharded with the psum or the all-to-all exchange, each
all-to-all bucket made lossless on the first 65,536 train rows; the plan is
logged (``shard_plan``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from recommender_tpu_torch.cli.common import (
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    host_local_data,
    make_logger,
    resolve_device,
    setup_distributed,
)
from recommender_tpu_torch.data.aliccp import click_only
from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticMultiTask
from recommender_tpu_torch.embedding.planner import (
    TableStats,
    capacity_factor_from_ids,
    module_kwargs,
    plan_summary,
    plan_tables,
)
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
                   help="planner: with --mesh_model > 1, tables under this size stay "
                        "replicated")
    args = p.parse_args(argv)
    if args.model_type == "BASE" and (args.checkpoint_dir or args.resume):
        raise SystemExit("--model_type BASE trains two models and writes no checkpoint; "
                         "drop --checkpoint_dir and --resume")
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)

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
    # this rank's rows (after the tables are sized from the whole split)
    train, test = host_local_data(train, mesh), host_local_data(test, mesh)
    train_bs = host_batch_size(args.train_batch_size, mesh)
    test_bs = host_batch_size(args.test_batch_size, mesh)

    # each table's layout and exchange from the planner (--mesh_model > 1)
    plan_kwargs = {}
    if args.mesh_model > 1:
        stats = [
            TableStats(f"feat_{j}", int(v), args.embedding_size, lookups_per_example=1,
                       id_freq=np.bincount(train["features"][:, j], minlength=int(v)))
            for j, v in enumerate(sizes)
        ]
        plans = plan_tables(
            stats, num_model_shards=args.mesh_model,
            batch_per_device=args.train_batch_size // mesh.data,
            replicate_below_bytes=int(args.replicate_below_mb * (1 << 20)),
        )
        # each a2a bucket made lossless on the real id stream, with headroom
        plans = [
            dataclasses.replace(pl, capacity_factor=max(
                pl.capacity_factor,
                capacity_factor_from_ids(train["features"][:65536, j], args.mesh_model,
                                         int(sizes[j]))))
            if pl.lookup == "all_to_all" else pl
            for j, pl in enumerate(plans)
        ]
        log({"shard_plan": plan_summary(plans)})
        plan_kwargs = module_kwargs(plans, mesh)
        plan_kwargs["mesh"] = mesh  # every partitioned table shards on it

    if args.model_type == "BASE":
        # the two-model protocol: a CTR model on impressions, a CVR model on clicks
        models = {}
        for role, label in (("ctr", "click"), ("cvr", "purchase")):
            role_log = make_logger(args, prefix=f"{role}/")
            arrays = dict(train if role == "ctr" else click_only(train))
            arrays["label"] = arrays[label]
            model = MultiTaskBase(vocab_sizes=sizes, embed_dim=args.embedding_size,
                                  device=device, **plan_kwargs)
            loss_fn, eval_fn = make_ctr_task(model)
            trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
            state = trainer.init_state(lambda: init_model(model, seed=args.seed))
            it = batch_iterator(arrays, train_bs, seed=args.seed, epochs=None)
            state, _ = trainer.fit(state, it, steps=args.steps, log_fn=role_log)
            models[role] = (model, state, trainer)
        # CTCVR eval: the product of both models on impressions
        (ctr_m, ctr_s, tr), (cvr_m, _, _) = models["ctr"], models["cvr"]

        def ctcvr(b):
            ctr_m.eval()
            cvr_m.eval()
            return ctr_m(b) * cvr_m(b), b["purchase"]

        auc = evaluate_head(tr, ctr_s, batch_iterator(test, test_bs, shuffle=False), ctcvr)
        log({"final": 1, "ctcvr_auc": auc})
        return models

    model_cls = ESMM if args.model_type == "ESMM" else MMOE
    model = model_cls(vocab_sizes=sizes, embed_dim=args.embedding_size, device=device,
                      **plan_kwargs)
    loss_fn, eval_fn = make_multitask_task(model)
    trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
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
