"""Multi-process launch, the rank's device, and the collectives the port uses.

Port of ``recommender_tpu/core/distributed.py``. JAX runs one process per
host over all of its devices; torch runs one process per GPU, so a rank is
one GPU and ``initialize_from_flags`` becomes ``dist.init_process_group``.
Its arguments resolve in the JAX order: explicit arguments, then the
environment torchrun sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``), then nothing, a single process (``(0, 1)``).

The backend is NCCL for ranks on the card and gloo for ranks on the CPU.
``backend="gloo"`` asks for gloo on the card too: NCCL refuses two ranks on
one device, so several ranks sharing one card run over gloo. Each rank's
device is ``cuda:{rank % device_count}``.

Collectives: the port uses four calls that NCCL and gloo both serve,
``all_reduce``, ``all_to_all_single``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, through the wrappers below, on the tensors'
own device. **The one-card transport** is gloo with CUDA tensors: gloo
copies them through host memory itself, and on torch 2.11 it takes all
four calls on CUDA tensors of f32, bf16 and int32 (``chip_smoke.py
--probe-gloo-cuda``), so no call needs staging by the port. Nothing
switches backend or device on a failure.

Input: each rank reads the rows of its **data coordinate**
(``shard_arrays_for_process``), not of its process index as JAX keys them:
the ranks of one model group hold the same ids, so they must read the same
rows.
"""
from __future__ import annotations

import os
import warnings
from datetime import timedelta

import torch
import torch.distributed as dist

BACKENDS = ("auto", "nccl", "gloo")


def initialize_from_flags(
    coordinator_address: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    auto: bool = False,
    device: str = "cuda",
    backend: str = "auto",
) -> tuple[int, int]:
    """Initialize the default process group when configured; return
    ``(rank, world_size)``.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (a TCP
    store), or an ``init_method`` URL (``file:///shared/path`` rendezvous
    through a file), with ``num_processes`` and ``process_id``; each falls back to
    torchrun's environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``auto=True`` (``--distributed``) initializes from the
    environment alone and fails where it is incomplete. With none of them
    this is a no-op returning ``(0, 1)``.

    ``device`` is the ranks' device type (``cuda`` or ``cpu``); ``backend``
    ``auto`` takes NCCL for ``cuda`` and gloo for ``cpu``. A second call in
    an initialized process returns the group's rank and size."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    init_method = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}" if coordinator_address else "")
    if not init_method and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"  # torchrun's store, as its workers join it
    if num_processes <= 0:
        num_processes = int(env.get("WORLD_SIZE", "0") or 0)
    if process_id < 0:
        process_id = int(env.get("RANK", "-1") or -1)
    if not init_method:
        if auto:
            raise SystemExit(
                "--distributed: no rendezvous in the environment (MASTER_ADDR, MASTER_PORT, "
                "RANK, WORLD_SIZE); launch with torchrun or pass --coordinator_address"
            )
        return 0, 1
    if num_processes <= 0 or process_id < 0:
        raise SystemExit(
            "--coordinator_address needs --num_processes and --process_id "
            "(or WORLD_SIZE / RANK)"
        )
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--process_id {process_id} outside [0, {num_processes})")
    kind = torch.device(device).type
    if backend == "auto":
        backend = "nccl" if kind == "cuda" else "gloo"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a CUDA device; pass --device cpu for CPU ranks")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif backend == "nccl":
        raise SystemExit("NCCL needs CUDA ranks; CPU ranks take gloo")
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(minutes=10),
    )
    return process_id, num_processes


def rank_device() -> torch.device:
    """Where this rank's collective scratch lives: its card under NCCL, the
    host under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ------------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """Equal splits of dim 0: block ``j`` of ``inp`` goes to group rank
    ``j``, and block ``i`` of ``out`` comes from group rank ``i``."""
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather_into_tensor(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """``out`` = the group ranks' ``inp`` concatenated along dim 0, in rank
    order."""
    with warnings.catch_warnings():  # newer torch names it all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)
    return out


def reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor, op=dist.ReduceOp.SUM,
                          group=None) -> torch.Tensor:
    """``out`` = block ``r`` (this group rank's) of ``inp`` reduced over the
    group; ``inp`` holds one block per group rank along dim 0."""
    with warnings.catch_warnings():  # newer torch names it reduce_scatter_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, op=op, group=group)
    return out


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group=group)

    @staticmethod
    def backward(ctx, cot):
        return all_reduce(cot.clone(), group=ctx.group), None


def sum_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable: every rank's result
    reads every rank's ``t``, so the cotangent is summed over the group
    too."""
    return _SumOverGroup.apply(t, group)


def barrier(device) -> None:
    """Every rank of the default group reaches this point (an all-reduce of
    one element on ``device``)."""
    if dist.is_initialized():
        all_reduce(torch.zeros(1, device=device))


# ------------------------------------------------------------------- input
def shard_arrays_for_process(arrays: dict, mesh) -> dict:
    """This rank's rows of a host data dict: data coordinate ``d`` of ``D``
    takes rows ``d::D`` (the copy of ``data.pipeline.shard_for_host``). The
    ranks of one model group get the same rows; the union over the data
    axis is the whole set. Identity on a one-wide data axis."""
    if mesh.data == 1:
        return arrays
    return {k: v[mesh.data_index::mesh.data] for k, v in arrays.items()}


def per_process_batch_size(global_batch: int, mesh) -> int:
    """Rows each rank feeds a step: ``global / data``."""
    n = mesh.data
    if global_batch % n:
        raise SystemExit(f"global batch {global_batch} not divisible by {n} data ranks")
    return global_batch // n
