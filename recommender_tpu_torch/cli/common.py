"""Shared CLI plumbing for the port's entry points.

Port of ``recommender_tpu/cli/common.py``: one flag set (the same names and
defaults) and one mesh and trainer bootstrap. New here are ``--device``
(``cuda`` by default): an entry point runs on the card unless the caller
asks for the CPU, and with ``cuda`` and no card it raises instead of
carrying on on the CPU; and ``--dist_backend``: ``auto`` takes NCCL for
``cuda`` ranks and gloo for ``cpu`` ranks, and ``gloo`` asks for gloo on
the card, for several ranks sharing one card (``core.distributed``).

Multi-process launch: one process per GPU (or per CPU rank), each with
``--coordinator_address host:port --num_processes N --process_id r``, or
under ``torchrun`` (its environment), or ``--distributed`` (the
environment only). The mesh flags lay ``(data, model)`` over the ranks
(``build_mesh``); each rank reads the rows of its data coordinate
(``host_local_data``, ``host_batch_size``); only rank 0 logs unless
``--log_all_hosts``. ``--accum_steps`` splits each step's batch into
microbatches (``TrainConfig.accum_steps``).
"""
from __future__ import annotations

import argparse
import json

import torch

from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.core.mesh import Mesh, MeshSpec, make_mesh
from recommender_tpu_torch.core.train import TrainConfig, Trainer

def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--train_batch_size", type=int, default=1024)
    p.add_argument("--test_batch_size", type=int, default=4096)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--accum_steps", type=int, default=1,
                   help=">1 = split each batch into that many microbatches, summing their "
                        "gradients in f32 before one optimizer update")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--eval_batches", type=int, default=0, help="0 = full pass")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=0, help="0 = all ranks")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="ranks each row-sharded table is split over")
    p.add_argument("--mesh_dcn", type=int, default=1,
                   help=">1 = that many slices (nodes), each a (mesh_data x mesh_model) "
                        "group, folded into the data axis (core/mesh.py MeshSpec)")
    p.add_argument("--checkpoint_dir", type=str, default="")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic dataset (no files needed)")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="also write train/eval curves as TensorBoard event files")
    add_launch_flags(p)
    p.add_argument("--log_all_hosts", action="store_true",
                   help="every rank logs JSONL (tagged with its rank) instead of rank 0 only")
    return p


def add_launch_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--device``, ``--dist_backend`` and the multi-process launch surface
    (core/distributed.py): run the same command once per rank with its
    ``--process_id``, or under torchrun."""
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cuda' needs a card, 'cpu' "
                        "runs the kernels' plain versions")
    p.add_argument("--dist_backend", choices=list(distributed.BACKENDS), default="auto",
                   help="auto = nccl for cuda ranks, gloo for cpu ranks; gloo on cuda = "
                        "several ranks sharing one card (core/distributed.py)")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of rank 0's rendezvous (or MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="ranks in the job (or WORLD_SIZE)")
    p.add_argument("--process_id", type=int, default=-1, help="this rank (or RANK)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize from torchrun's environment alone")
    return p


def resolve_device(args) -> torch.device:
    """``--device`` as a torch device; ``cuda`` with no card raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available; pass --device cpu to "
            "run on the CPU"
        )
    return device


def setup_distributed(args) -> tuple[int, int]:
    """Initialize the process group from the flags (a no-op when none is
    set); call first in every entry point, before any device use: it also
    picks this rank's card. Returns ``(rank, world_size)``."""
    return distributed.initialize_from_flags(
        args.coordinator_address, args.num_processes, args.process_id,
        auto=args.distributed, device=args.device, backend=args.dist_backend,
    )


def build_mesh(args) -> Mesh:
    """The ``(data, model)`` mesh of the flags over the initialized ranks."""
    world = distributed.dist.get_world_size() if distributed.dist.is_initialized() else 1
    if args.mesh_dcn < 1 or args.mesh_model < 1 or args.mesh_data < 0:
        raise SystemExit(
            f"--mesh_dcn ({args.mesh_dcn}) and --mesh_model ({args.mesh_model}) must be >= 1, "
            f"--mesh_data ({args.mesh_data}) >= 0"
        )
    data = args.mesh_data or world // (args.mesh_model * args.mesh_dcn)
    need = max(data, 1) * args.mesh_model * args.mesh_dcn
    if need != world:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} --mesh_model {args.mesh_model} --mesh_dcn "
            f"{args.mesh_dcn} needs {need} ranks, the job has {world} (--num_processes)"
        )
    return make_mesh(MeshSpec(data=data, model=args.mesh_model, dcn_data=args.mesh_dcn))


def host_local_data(arrays: dict, mesh: Mesh) -> dict:
    """This rank's rows of a whole data dict: the rows of its data
    coordinate (the same for every rank of a model group)."""
    return distributed.shard_arrays_for_process(arrays, mesh)


def host_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows this rank feeds a step: the global batch over the data axis."""
    return distributed.per_process_batch_size(global_batch, mesh)


def build_trainer(args, loss_fn, eval_fn=None, *, device, mesh: Mesh | None = None) -> Trainer:
    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        log_every=args.log_every,
        eval_every=args.eval_every,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
        early_stop_patience=getattr(args, "early_stop_patience", 0),
        accum_steps=getattr(args, "accum_steps", 1),
        lr_scales=getattr(args, "lr_scales", None) or None,
    )
    return Trainer(loss_fn, cfg, eval_fn, device=device, mesh=mesh)


def log_jsonl(metrics: dict):
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()}), flush=True)


def make_logger(args, prefix: str = ""):
    """JSONL logger, plus TensorBoard scalar events when --tensorboard_dir
    is set. Metric dicts without a 'step' key (e.g. final evals) reuse the
    last step seen. ``prefix`` namespaces the run (TB tag prefix + a
    ``role`` field in the JSONL), for an entry point that trains several
    models in one invocation.

    In a multi-process job only rank 0 logs (the metrics are averaged over
    the data group, so every rank would print the same lines); with
    ``--log_all_hosts`` every rank logs JSONL, tagged with its rank."""
    role = {"role": prefix.rstrip("/")} if prefix else {}
    if distributed.dist.is_initialized() and distributed.dist.get_world_size() > 1:
        rank = distributed.dist.get_rank()
        if getattr(args, "log_all_hosts", False):
            return lambda metrics: log_jsonl({"process": rank, **role, **metrics})
        if rank != 0:
            return lambda metrics: None

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
