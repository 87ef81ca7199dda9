"""The 2-D (data, model) mesh over the ranks of a process group.

Port of ``recommender_tpu/core/mesh.py``. JAX lays a mesh over devices; the
port lays it over ranks, one process per GPU (torch's convention), and a
rank's place in the mesh follows from its rank in the default group:

    rank = data_index * model + model_index

* ``data``  — the batch axis. Each rank reads its own rows, and the
  Trainer averages gradients over the ranks with this rank's model index
  (the data group).
* ``model`` — the table axis. A row-sharded table keeps rows
  ``[model_index * rows, (model_index + 1) * rows)`` on each rank
  (``embedding.sharded``), and the ranks with this rank's data index (the
  model group) hold the same ids and the same dense parameters.

``MeshSpec.dcn_data`` folds more data groups in, slice-major: ranks
``[s * data * model, (s + 1) * data * model)`` form slice ``s``, so a model
group never spans two slices. A rank learns its slice from torchrun's
``GROUP_RANK`` (its node); ``_check_slice_major`` holds the fold to it.

With no process group, ``make_mesh`` returns the 1 x 1 mesh and nothing
communicates.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``data * model * dcn_data`` must equal the number
    of ranks. ``dcn_data`` more data groups fold into the ``data`` axis."""

    data: int = 1
    model: int = 1
    dcn_data: int = 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data * self.dcn_data, self.model)


class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinates and
    its two groups (None on a 1 x 1 mesh, where nothing communicates).

    ``data_group`` holds the ranks with this rank's model index, in data
    order; ``model_group`` the ranks with this rank's data index, in model
    order; ``world_group`` every rank of the mesh (the default group)."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 data_group=None, model_group=None, world_group=None):
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.model)
        self.data_group, self.model_group = data_group, model_group
        self.world_group = world_group

    @property
    def shape(self) -> dict:
        """``{"data": d, "model": m}``, as JAX's ``Mesh.shape`` reads."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"coords=({self.data_index}, {self.model_index}))")


def make_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """Build this rank's mesh over the ranks of the default group.

    With no spec every rank goes on ``data`` (pure data parallelism). Every
    rank must call this with the same spec: each group is made by
    ``dist.new_group``, which all ranks of the default group call in the
    same order. With no process group the mesh is 1 x 1."""
    if not dist.is_initialized():
        world, rank = 1, 0
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
    if spec is None:
        spec = MeshSpec(data=world, model=1)
    if spec.data < 1 or spec.model < 1 or spec.dcn_data < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec}")
    n_need = spec.data * spec.model * spec.dcn_data
    if n_need != world:
        raise ValueError(f"mesh {spec.shape} needs {n_need} ranks, got {world}")
    data, model = spec.shape
    if world == 1:
        return Mesh(1, 1)
    if spec.dcn_data > 1:
        _check_slice_major(_slice_ids(world), spec, on_cpu=dist.get_backend() == "gloo")
    data_group = model_group = None
    for d in range(data):  # every rank creates every group, in one order
        g = dist.new_group([d * model + j for j in range(model)])
        if rank // model == d:
            model_group = g
    for j in range(model):
        g = dist.new_group([d * model + j for d in range(data)])
        if rank % model == j:
            data_group = g
    return Mesh(data, model, rank, data_group=data_group, model_group=model_group,
                world_group=dist.group.WORLD)


def _slice_ids(world: int) -> list:
    """Every rank's slice (torchrun's ``GROUP_RANK``, its node), or None
    where a rank's environment does not say."""
    from recommender_tpu_torch.core.distributed import all_gather_into_tensor, rank_device

    own = int(os.environ.get("GROUP_RANK", "-1"))
    mine = torch.tensor([own], dtype=torch.int64, device=rank_device())
    every = torch.empty(world, dtype=torch.int64, device=mine.device)
    all_gather_into_tensor(every, mine, group=dist.group.WORLD)
    return [None if s < 0 else int(s) for s in every.tolist()]


def _check_slice_major(slice_ids: Sequence[Optional[int]], spec: MeshSpec, on_cpu: bool) -> None:
    """Gate the ``dcn_data`` fold: the mesh assumes ranks are numbered
    slice-major, and a wrong guess would put a model group's exchanges
    across slices. Policy (the JAX package's):

    * every rank knows its slice → verify that each contiguous block of
      ``data * model`` ranks is one slice and that there are ``dcn_data``
      of them; raise on any mismatch;
    * no slice ids and gloo ranks (a test run on the CPU, or ranks sharing
      one card) → warn and assume;
    * anything else → refuse: launch with torchrun (which sets
      ``GROUP_RANK``) or use ``dcn_data=1``."""
    per_slice = spec.data * spec.model
    if all(s is not None for s in slice_ids):
        blocks = [set(slice_ids[i:i + per_slice]) for i in range(0, len(slice_ids), per_slice)]
        if any(len(b) != 1 for b in blocks) or len({next(iter(b)) for b in blocks}) != spec.dcn_data:
            raise ValueError(
                f"the ranks are NOT slice-major for dcn_data={spec.dcn_data}: per-block slice "
                f"ids {blocks}; number the ranks so that each contiguous block of {per_slice} "
                "is one slice"
            )
        return
    if on_cpu:
        warnings.warn(
            f"no slice topology (GROUP_RANK) to verify dcn_data={spec.dcn_data} against; "
            "assuming the gloo ranks are slice-major",
            stacklevel=3,
        )
        return
    raise ValueError(
        "the ranks expose no slice topology (GROUP_RANK) to verify the dcn_data fold "
        "against. Refusing to guess on GPUs: launch with torchrun, or use dcn_data=1."
    )


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows each rank feeds a step: the global batch over the data axis."""
    n = mesh.data
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data={n}")
    return global_batch // n
