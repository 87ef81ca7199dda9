"""CTR training entry: DLRM / DeepFM / DCN on Criteo.

Port of ``recommender_tpu/cli/train_ctr.py``.

Usage:
  python -m recommender_tpu_torch.cli.train_ctr --model_type DLRM --synthetic
  python -m recommender_tpu_torch.cli.train_ctr --model_type DeepFM \
      --data_dir /path/to/criteo_shards --vocab /path/to/vocab.pkl
  python -m recommender_tpu_torch.cli.train_ctr --synthetic --device cpu
  # two ranks, the 1M-row table row-sharded over them (one command per rank)
  python -m recommender_tpu_torch.cli.train_ctr --synthetic --mesh_model 2 \
      --lookup_mode psum --coordinator_address 127.0.0.1:29500 \
      --num_processes 2 --process_id {0,1}

The flags, their defaults and the training stream are the JAX entry
point's: it takes the stream's first batch as its init example and trains
from the second, so this one skips the first batch too, and ``--resume``
restarts the stream at batch ``step + 1``, the synthetic stream and the
shard stream (one worker, or ``--prefetch_workers`` W > 1 merged round-robin
by ``interleave_ordered``) alike. With a ``--checkpoint_dir`` the shard
stream's parameters are pinned in ``data_stream.json`` beside the
checkpoints, ``train_batch_size`` included, and a resume with other values
is refused.

``--dedup_lookup on`` attaches a host dedup plan to each batch
(``data.pipeline.with_dedup_plans``): the embedding backward is then two
calls of the sorted scatter-add kernel on the card, or of its plain version
with ``--device cpu``. ``auto`` resolves to off, as in JAX; with a data
axis wider than 1 ``on`` warns that it gains nothing, as in JAX.

Mesh (``--mesh_model`` > 1): the table is row-sharded over the model axis.
``--lookup_mode auto`` asks the planner (``embedding.planner``) for the
table's layout and exchange, with the all-to-all bucket measured on the
first batch (``capacity_factor_from_ids``) unless ``--a2a_capacity_factor``
sets it, and logs the plan; an explicit ``psum``, ``a2a`` or ``gspmd``
shards the table and takes that exchange (``gspmd`` is the psum exchange
here, ``embedding.table``). Each rank reads the rows of its data
coordinate: the synthetic set's rows ``d::D``, or on-disk shards ``d::D``.
"""
from __future__ import annotations

import glob
import json
import os

import torch

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
from recommender_tpu_torch.data.criteo import load_shards, load_vocab, shard_batches
from recommender_tpu_torch.data.pipeline import (
    batch_iterator,
    interleave_ordered,
    with_dedup_plans,
)
from recommender_tpu_torch.data.synthetic import SyntheticCTR
from recommender_tpu_torch.embedding.planner import (
    TableStats,
    capacity_factor_from_ids,
    plan_summary,
    plan_tables,
)
from recommender_tpu_torch.models.dcn import DCN
from recommender_tpu_torch.models.deepfm import DeepFM
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.tasks import init_model, make_ctr_task
from recommender_tpu_torch.nn.schedules import dlrm_warmup_cosine

MODEL_TYPES = ("DLRM", "DeepFM", "DCN")


def build_model(model_type: str, vocab_size: int, embedding_size: int,
                embed_param_dtype: torch.dtype, device, **table_kw) -> torch.nn.Module:
    """The model ``--model_type`` names, at ``--vocab_size`` and
    ``--embedding_size``; DLRM's bottom MLP ends at the embedding width (its
    output is one more feature). ``table_kw``: the table's ``partition``,
    ``lookup_mode``, ``mesh`` and ``capacity_factor``. ``cli.predict``
    builds through this too."""
    kw = dict(vocab_size=vocab_size, embed_dim=embedding_size,
              embed_param_dtype=embed_param_dtype, device=device, **table_kw)
    if model_type == "DLRM":
        return DLRM(bottom_units=(512, 256, 64, embedding_size), **kw)
    if model_type == "DCN":
        return DCN(**kw)
    if model_type == "DeepFM":
        return DeepFM(**kw)
    raise ValueError(f"unknown model_type {model_type!r}")


def add_ctr_flags(p):
    """The JAX entry point's own flags, names and defaults."""
    p.add_argument("--model_type", choices=list(MODEL_TYPES), default="DLRM")
    p.add_argument("--vocab_size", type=int, default=1_000_000)
    p.add_argument("--embedding_size", type=int, default=16)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--vocab", type=str, default="")
    p.add_argument("--lr_schedule", choices=["none", "dlrm"], default="none",
                   help="'dlrm' = linear warmup, then cosine decay")
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--decay_steps", type=int, default=40000)
    p.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop after N evals without val-AUC improvement")
    p.add_argument("--lookup_mode", choices=["auto", "gspmd", "psum", "a2a"], default="auto",
                   help="the sharded table's exchange (--mesh_model > 1): auto = the "
                        "planner's choice; gspmd = psum here")
    p.add_argument("--a2a_capacity_factor", type=float, default=0.0,
                   help="all-to-all bucket size; 0 = measured on the first batch "
                        "(lossless x1.25)")
    p.add_argument("--replicate_below_mb", type=float, default=32.0,
                   help="planner: tables under this size stay replicated")
    p.add_argument("--dedup_lookup", choices=["auto", "on", "off"], default="auto",
                   help="host-precomputed id-dedup plans for the embedding backward "
                        "(data/dedup.py); auto resolves to off")
    p.add_argument("--prefetch_workers", type=int, default=1,
                   help="parallel host read/slice workers for the on-disk shard stream "
                        "(deterministic round-robin interleave, resumable)")
    p.add_argument("--embed_dtype", choices=["f32", "bf16"], default="f32",
                   help="bf16 = store the table in bfloat16 (stochastic rounding applies "
                        "to it automatically)")
    return p


def main(argv=None):
    p = add_ctr_flags(base_parser("CTR training (DLRM/DeepFM/DCN)"))
    args = p.parse_args(argv)
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)
    if args.lr_schedule == "dlrm":
        args.learning_rate = dlrm_warmup_cosine(
            args.learning_rate, args.warmup_steps, args.decay_steps, 1e-4
        )

    # each rank streams the rows of its data coordinate, global/data a step
    train_bs = host_batch_size(args.train_batch_size, mesh)
    test_bs = host_batch_size(args.test_batch_size, mesh)
    streamed = bool(args.data_dir) and not args.synthetic
    W = max(args.prefetch_workers, 1)
    interleave = None  # the round-robin merge of W > 1 shard streams
    if not streamed:
        gen = SyntheticCTR(vocab_size=args.vocab_size, seed=args.seed)
        train_arrays = host_local_data(
            gen.sample(max(args.steps, 100) * args.train_batch_size // 4, seed=1), mesh)
        test_arrays = host_local_data(gen.sample(20 * args.test_batch_size, seed=2), mesh)
        train_iter = batch_iterator(train_arrays, train_bs, seed=args.seed, epochs=None)
        eval_iter_fn = lambda: batch_iterator(test_arrays, test_bs, shuffle=False)  # noqa: E731
    else:
        vocab = load_vocab(args.vocab)
        if len(vocab) + 1 > args.vocab_size:
            # ids are 1..len(vocab) with 0 = OOV: a smaller table would alias high ids
            log({"vocab_size_raised": len(vocab) + 1, "was": args.vocab_size})
            args.vocab_size = len(vocab) + 1
        shards = sorted(glob.glob(f"{args.data_dir}/train*/*.npz")
                        or glob.glob(f"{args.data_dir}/shard_*.npz"))
        test_shards = sorted(glob.glob(f"{args.data_dir}/test*/*.npz"))
        if mesh.data > 1:
            # whole-shard striping: data coordinate d streams shards d::D
            shards = shards[mesh.data_index::mesh.data]
            if not shards:
                raise SystemExit(
                    f"data rank {mesh.data_index}: no train shards after {mesh.data}-way "
                    "striping; need at least one shard per data rank"
                )

        def worker_streams(global_start: int = 0):
            """W striped shard streams fast-forwarded so that the round-robin
            merge resumes at global batch ``global_start``: worker w has
            delivered the global indices j < start with j % W == w."""
            return [
                shard_batches(
                    shards[w::W], train_bs, seed=args.seed + w, epochs=None,
                    start_batch=(global_start - 1 - w) // W + 1 if global_start > w else 0,
                )
                for w in range(W)
            ]

        if W > 1:
            if len(shards) < W:
                raise SystemExit(
                    f"--prefetch_workers {W} needs at least {W} shards (found {len(shards)})"
                )
            train_iter = interleave = interleave_ordered(worker_streams(), size=2)
        else:
            train_iter = shard_batches(shards, train_bs, seed=args.seed, epochs=None)
        if args.checkpoint_dir:
            # the merged stream is a function of these: resuming with other
            # values would silently train on an unrelated stream
            meta_path = os.path.join(args.checkpoint_dir, "data_stream.json")
            meta = {"prefetch_workers": W, "seed": args.seed, "num_shards": len(shards),
                    "train_batch_size": train_bs}
            if args.resume and os.path.exists(meta_path):
                with open(meta_path) as f:
                    old = json.load(f)
                if old != meta:
                    raise SystemExit(
                        f"--resume data-stream config mismatch: checkpoint was written with "
                        f"{old}, current flags give {meta}; resume with matching flags"
                    )
            elif mesh.rank == 0:  # one writer
                os.makedirs(args.checkpoint_dir, exist_ok=True)
                with open(meta_path, "w") as f:
                    json.dump(meta, f)
        test_arrays = host_local_data(load_shards(test_shards), mesh) if test_shards else None
        eval_iter_fn = (
            (lambda: batch_iterator(test_arrays, test_bs, shuffle=False))
            if test_arrays is not None else None
        )

    # the batch the JAX entry point's init takes as its example
    example = next(train_iter)

    # the table's layout and exchange: the planner's with --lookup_mode
    # auto, else row-sharded iff --mesh_model > 1 with the mode asked for
    partition = "model" if args.mesh_model > 1 else None
    lookup_mode, cap = args.lookup_mode, args.a2a_capacity_factor
    if args.mesh_model > 1 and lookup_mode == "auto":
        n_feat = example["cat_features"].shape[-1]
        [plan] = plan_tables(
            [TableStats("embedding", args.vocab_size, args.embedding_size,
                        lookups_per_example=n_feat)],
            num_model_shards=args.mesh_model,
            batch_per_device=args.train_batch_size // mesh.data,
            replicate_below_bytes=int(args.replicate_below_mb * (1 << 20)),
        )
        partition = plan.partition
        lookup_mode = {"all_to_all": "a2a", "psum": "psum"}.get(plan.lookup, "gspmd")
        if lookup_mode == "a2a" and cap <= 0:
            cap = capacity_factor_from_ids(example["cat_features"], args.mesh_model,
                                           args.vocab_size)
        log({"shard_plan": plan_summary([plan]), "lookup_mode": lookup_mode,
             "capacity_factor": round(cap, 3)})
    else:
        if lookup_mode == "auto":
            lookup_mode = "gspmd"
        if lookup_mode == "a2a" and cap <= 0:
            cap = capacity_factor_from_ids(example["cat_features"], args.mesh_model,
                                           args.vocab_size)
    model = build_model(
        args.model_type, args.vocab_size, args.embedding_size,
        torch.bfloat16 if args.embed_dtype == "bf16" else torch.float32, device,
        partition=partition, lookup_mode=lookup_mode, mesh=mesh,
        capacity_factor=cap if cap > 0 else 2.0,
    )
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        # resume the stream where the restored step left off (+1 for the
        # example batch); the replaced stream is closed (with W > 1 that
        # stops its worker threads)
        k = state.step + 1
        train_iter.close()
        if not streamed:
            train_iter = batch_iterator(train_arrays, train_bs, seed=args.seed,
                                        epochs=None, start_batch=k)
        elif W > 1:
            train_iter = interleave = interleave_ordered(
                worker_streams(k), size=2, start_worker=k % W)
        else:
            train_iter = shard_batches(shards, train_bs, seed=args.seed, epochs=None,
                                       start_batch=k)

    if args.dedup_lookup == "on":
        if args.accum_steps > 1:
            raise SystemExit("--dedup_lookup on is incompatible with --accum_steps > 1 "
                             "(plans index the whole-batch id stream)")
        if mesh.data > 1:
            print("WARNING: --dedup_lookup on with a data-sharded mesh turns the plan "
                  "reorder into a cross-device gather; expect no win.")
        # wrapped last, so that it also covers the resumed stream
        train_iter = with_dedup_plans(train_iter)

    state, _ = trainer.fit(
        state, train_iter, steps=args.steps,
        eval_iter_fn=eval_iter_fn, eval_batches=args.eval_batches, log_fn=log,
        # interleave_ordered already runs one prefetch thread per worker
        prefetch=0 if interleave is not None else 2,
    )
    if interleave is not None:
        # read on this thread (prefetch=0 above), so closing it here is safe;
        # it stops the worker threads
        interleave.close()
    if eval_iter_fn is not None:
        log({"final": 1, **trainer.evaluate(state, eval_iter_fn(), args.eval_batches, exact=True)})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()
