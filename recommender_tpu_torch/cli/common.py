"""Shared CLI plumbing for the port's entry points.

Port of ``recommender_tpu/cli/common.py``: one flag set (the same names and
defaults) and one trainer bootstrap. New here is ``--device`` (``cuda`` by
default): an entry point runs on the card unless the caller asks for the
CPU, and with ``cuda`` and no card it raises instead of carrying on on the
CPU.

Flags whose machinery is not ported yet are accepted and refused at any
value but their default (``parse_args``), none is silently ignored:
the mesh flags and the multi-host launch flags (the sharded-table and
multi-GPU slices) and ``--accum_steps`` (the Trainer slice that ports
gradient accumulation).
"""
from __future__ import annotations

import argparse
import json

import torch

from recommender_tpu_torch.core.train import TrainConfig, Trainer

# flag → (default, the later slice that ports its machinery)
_MESH = "the sharded-table slice (a device mesh) is not ported yet"
_MULTI_HOST = "the multi-GPU slice (torch.distributed launch) is not ported yet"
UNPORTED_FLAGS = {
    "accum_steps": (1, "gradient accumulation comes with the Trainer slice that ports it"),
    "mesh_data": (0, _MESH),
    "mesh_model": (1, _MESH),
    "mesh_dcn": (1, _MESH),
    "coordinator_address": ("", _MULTI_HOST),
    "num_processes": (0, _MULTI_HOST),
    "process_id": (-1, _MULTI_HOST),
    "log_all_hosts": (False, _MULTI_HOST),
    "distributed": (False, _MULTI_HOST),
}


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--train_batch_size", type=int, default=1024)
    p.add_argument("--test_batch_size", type=int, default=4096)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="not ported yet: any value but 1 is refused")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--eval_batches", type=int, default=0, help="0 = full pass")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=0,
                   help="not ported yet: any value but 0 is refused")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="not ported yet: any value but 1 is refused")
    p.add_argument("--mesh_dcn", type=int, default=1,
                   help="not ported yet: any value but 1 is refused")
    p.add_argument("--checkpoint_dir", type=str, default="")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic dataset (no files needed)")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="also write train/eval curves as TensorBoard event files")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on; 'cuda' needs a card, 'cpu' "
                        "runs the kernels' plain versions")
    # the multi-host launch surface of the JAX package: not ported yet
    p.add_argument("--coordinator_address", type=str, default="",
                   help="not ported yet: refused when set")
    p.add_argument("--num_processes", type=int, default=0,
                   help="not ported yet: any value but 0 is refused")
    p.add_argument("--process_id", type=int, default=-1,
                   help="not ported yet: any value but -1 is refused")
    p.add_argument("--log_all_hosts", action="store_true",
                   help="not ported yet: refused when set")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet: refused when set")
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, then exit with a message on any flag of ``UNPORTED_FLAGS``
    that is not at its default."""
    args = parser.parse_args(argv)
    for name, (default, why) in UNPORTED_FLAGS.items():
        value = getattr(args, name, default)
        if value != default:
            raise SystemExit(f"--{name} {value!r}: {why}; only the default ({default!r}) is accepted")
    return args


def resolve_device(args) -> torch.device:
    """``--device`` as a torch device; ``cuda`` with no card raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available; pass --device cpu to "
            "run on the CPU"
        )
    return device


def build_trainer(args, loss_fn, eval_fn=None, *, device) -> Trainer:
    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        log_every=args.log_every,
        eval_every=args.eval_every,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
        early_stop_patience=getattr(args, "early_stop_patience", 0),
        lr_scales=getattr(args, "lr_scales", None) or None,
    )
    return Trainer(loss_fn, cfg, eval_fn, device=device)


def log_jsonl(metrics: dict):
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()}), flush=True)


def make_logger(args, prefix: str = ""):
    """JSONL logger, plus TensorBoard scalar events when --tensorboard_dir
    is set. Metric dicts without a 'step' key (e.g. final evals) reuse the
    last step seen. ``prefix`` namespaces the run (TB tag prefix + a
    ``role`` field in the JSONL), for an entry point that trains several
    models in one invocation."""
    role = {"role": prefix.rstrip("/")} if prefix else {}

    if not getattr(args, "tensorboard_dir", ""):
        if not prefix:
            return log_jsonl
        return lambda metrics: log_jsonl({**role, **metrics})

    from recommender_tpu_torch.core.tensorboard import SummaryWriter

    writer = SummaryWriter(args.tensorboard_dir)
    last_step = [0]

    def log(metrics: dict):
        log_jsonl({**role, **metrics})
        step = int(metrics.get("step", last_step[0]))
        last_step[0] = max(last_step[0], step)
        writer.scalars(metrics, step, prefix=prefix)
        writer.flush()

    return log
