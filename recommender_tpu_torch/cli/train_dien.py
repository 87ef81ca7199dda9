"""Behavior-sequence CTR entry: BASE / DIN / DIEN / BST.

Port of ``recommender_tpu/cli/train_dien.py``. On a mesh each rank reads
the rows of its data coordinate and the Trainer averages gradients over the
data axis; the tables stay replicated, as in JAX's entry point.

Usage:
  python -m recommender_tpu_torch.cli.train_dien --model_type DIEN --synthetic
  python -m recommender_tpu_torch.cli.train_dien --model_type DIEN \
      --train_file local_train_splitByUser --test_file local_test_splitByUser \
      --vocab_dir ./data
  python -m recommender_tpu_torch.cli.train_dien --synthetic --device cpu

The training stream is the JAX entry point's: that one takes its first
batch as the shape example for init and trains from the second, so this one
skips the first batch too, and ``--resume`` restarts the synthetic stream at
batch ``step + 1``.
"""
from __future__ import annotations

import numpy as np
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
from recommender_tpu_torch.data import amazon
from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticSequence
from recommender_tpu_torch.models.bst import BST
from recommender_tpu_torch.models.dien import DIEN, DIN, BaseModel
from recommender_tpu_torch.models.tasks import init_model, make_aux_loss_task, make_ctr_task

# BST: the transformer alternative to the recurrence
MODELS = {"BASE": BaseModel, "DIN": DIN, "DIEN": DIEN, "BST": BST}


def main(argv=None):
    p = base_parser("Behavior-sequence CTR training (BASE/DIN/DIEN/BST)")
    p.add_argument("--model_type", choices=list(MODELS), default="DIEN")
    p.add_argument("--embedding_size", type=int, default=18)
    p.add_argument("--history_max_length", type=int, default=100)
    p.add_argument("--embed_dtype", choices=["f32", "bf16"], default="f32",
                   help="bf16 = store both tables in bfloat16 (stochastic "
                        "rounding applies to them automatically)")
    p.add_argument("--train_file", type=str, default="")
    p.add_argument("--test_file", type=str, default="")
    p.add_argument("--vocab_dir", type=str, default="")
    args = p.parse_args(argv)
    setup_distributed(args)  # before any device use: it picks this rank's card
    device = resolve_device(args)
    log = make_logger(args)
    mesh = build_mesh(args)

    need_neg = args.model_type == "DIEN"
    # each rank reads the rows of its data coordinate, global/data a step
    train_bs = host_batch_size(args.train_batch_size, mesh)
    test_bs = host_batch_size(args.test_batch_size, mesh)
    synthetic = args.synthetic or not args.train_file
    if synthetic:
        gen = SyntheticSequence(max_len=args.history_max_length, seed=args.seed)
        train_arrays = host_local_data(gen.sample(50_000, seed=1), mesh)
        test_arrays = host_local_data(gen.sample(10_000, seed=2), mesh)
        item_vocab_size, cat_vocab_size = gen.num_items, gen.num_cats
        train_iter = batch_iterator(train_arrays, train_bs, seed=args.seed, epochs=None)
    else:
        if args.vocab_dir:
            iv, cv, i2c = amazon.load_vocab(args.vocab_dir)
        else:
            iv, cv, i2c = amazon.build_vocab(args.train_file)
        i2c_arr = amazon.make_item2cat_array(iv, cv, i2c)
        train_arrays = host_local_data(
            amazon.encode_dataset(args.train_file, iv, cv, args.history_max_length), mesh)
        test_arrays = host_local_data(
            amazon.encode_dataset(args.test_file, iv, cv, args.history_max_length), mesh)
        if need_neg:
            # the test set's negatives are drawn once; training draws them per batch
            rng = np.random.default_rng(args.seed)
            test_arrays = amazon.sample_negative_history(test_arrays, len(iv), i2c_arr, rng)
        item_vocab_size, cat_vocab_size = len(iv), len(cv)
        train_iter = amazon.dien_batches(
            train_arrays, train_bs, len(iv), i2c_arr,
            sample_negative=need_neg, seed=args.seed, epochs=None,
        )
    eval_iter_fn = lambda: batch_iterator(test_arrays, test_bs, shuffle=False)  # noqa: E731

    model = MODELS[args.model_type](
        item_vocab=item_vocab_size,
        cat_vocab=cat_vocab_size,
        item_dim=args.embedding_size,
        cat_dim=args.embedding_size,
        embed_param_dtype=torch.bfloat16 if args.embed_dtype == "bf16" else torch.float32,
        mesh=mesh, device=device,
    )
    task = make_aux_loss_task if args.model_type == "DIEN" else make_ctr_task
    loss_fn, eval_fn = task(model)
    trainer = build_trainer(args, loss_fn, eval_fn, device=device, mesh=mesh)
    next(train_iter)  # the batch the JAX entry point's init takes as its shape example
    state = trainer.init_state(lambda: init_model(model, seed=args.seed))
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
        if synthetic:
            # resume the data stream where the restored step left off (+1
            # for the skipped first batch)
            train_iter = batch_iterator(
                train_arrays, train_bs, seed=args.seed,
                epochs=None, start_batch=state.step + 1,
            )
    state, _ = trainer.fit(
        state, train_iter, steps=args.steps,
        eval_iter_fn=eval_iter_fn, eval_batches=args.eval_batches, log_fn=log,
    )
    log({"final": 1, **trainer.evaluate(state, eval_iter_fn(), args.eval_batches, exact=True)})
    if args.checkpoint_dir:
        trainer.save(state)
    return state


if __name__ == "__main__":
    main()
