"""The port's rank mesh and launch (``core/mesh.py``, ``core/distributed.py``).

Mirrors ``tests/test_mesh_fold.py`` (the ``dcn_data`` fold verifies or
refuses, never guesses) and the unit layer of ``tests/test_multihost.py``
(the no-op single process, the batch arithmetic, the per-rank input
slices), then builds meshes over real gloo ranks on the CPU
(``torch_dist_workers.spawn``): each rank's coordinates and the members of
its two groups, and a launch from torchrun's environment.
"""
import numpy as np
import pytest

import torch_dist_workers as W
from recommender_tpu.core.mesh import MeshSpec as JaxMeshSpec
from recommender_tpu.data.pipeline import shard_for_host
from recommender_tpu_torch.cli import common
from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    _check_slice_major,
    local_batch_size,
    make_mesh,
)

SPEC = MeshSpec(data=2, model=2, dcn_data=2)


def test_verified_slice_major_passes_silently():
    _check_slice_major([0, 0, 0, 0, 1, 1, 1, 1], SPEC, on_cpu=False)


def test_wrong_order_raises():
    with pytest.raises(ValueError, match="NOT slice-major"):
        _check_slice_major([0, 1, 0, 1, 0, 1, 0, 1], SPEC, on_cpu=False)


def test_wrong_slice_count_raises():
    with pytest.raises(ValueError, match="NOT slice-major"):
        _check_slice_major([0] * 8, SPEC, on_cpu=False)


def test_cpu_test_ranks_warn_and_assume():
    with pytest.warns(UserWarning, match="slice-major"):
        _check_slice_major([None] * 8, SPEC, on_cpu=True)


def test_no_topology_on_gpus_refuses():
    with pytest.raises(ValueError, match="Refusing to guess"):
        _check_slice_major([None] * 8, SPEC, on_cpu=False)


def test_spec_shape_folds_like_jax():
    for spec in ((1, 1, 1), (2, 4, 1), (2, 2, 2), (1, 2, 4)):
        assert MeshSpec(*spec).shape == JaxMeshSpec(*spec).shape
    assert (DATA_AXIS, MODEL_AXIS) == ("data", "model")


def test_no_process_group_gives_the_one_by_one_mesh():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_index, mesh.model_index, mesh.data_group, mesh.model_group) == (
        0, 0, None, None)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(MeshSpec(1, 2))
    assert local_batch_size(1024, Mesh(4, 2, rank=5)) == 256
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(1023, Mesh(2, 1))


def test_coordinates_follow_the_rank():
    mesh = Mesh(3, 2, rank=5)
    assert (mesh.data_index, mesh.model_index) == (2, 1)


def test_initialize_noop_single_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_from_flags() == (0, 1)
    assert not distributed.dist.is_initialized()
    arrays = {"x": np.arange(10)}
    assert distributed.shard_arrays_for_process(arrays, make_mesh()) is arrays
    assert distributed.per_process_batch_size(1024, make_mesh()) == 1024


@pytest.mark.parametrize("flags,match", [
    (dict(coordinator_address="localhost:1"), "needs --num_processes"),
    (dict(coordinator_address="localhost:1", num_processes=2, process_id=2), "outside"),
    (dict(coordinator_address="localhost:1", num_processes=1, process_id=0, device="cpu",
          backend="nccl"), "NCCL needs CUDA"),
    (dict(auto=True), "no rendezvous"),
], ids=["identity", "range", "nccl_cpu", "auto"])
def test_initialize_refuses_an_incomplete_launch(monkeypatch, flags, match):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match=match):
        distributed.initialize_from_flags(**flags)
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize_from_flags(backend="mpi")


@pytest.mark.parametrize("n", [2, 3])
def test_input_slices_by_data_coordinate(n):
    """Each data coordinate takes rows ``d::D``, the JAX function's slice for
    process ``d``; the ranks of a model group share theirs; the union over
    the data axis is the whole set, disjoint."""
    arrays = {"x": np.arange(31), "y": np.arange(31) * 2}
    seen = []
    for rank in range(n * 2):
        mesh = Mesh(n, 2, rank=rank)
        got = distributed.shard_arrays_for_process(arrays, mesh)
        want = shard_for_host(arrays, mesh.data_index, n)
        assert all(np.array_equal(got[k], want[k]) for k in arrays)
        if mesh.model_index == 0:
            seen.append(got["x"])
    assert sorted(np.concatenate(seen).tolist()) == list(range(31))
    assert distributed.per_process_batch_size(12 * n, Mesh(n, 2)) == 12
    with pytest.raises(SystemExit, match="not divisible"):
        distributed.per_process_batch_size(12 * n + 1, Mesh(n, 2))


def test_build_mesh_flags():
    p = common.base_parser("x")
    assert common.build_mesh(p.parse_args([])).shape == {"data": 1, "model": 1}
    for argv, match in ((["--mesh_model", "2"], "needs 2 ranks"),
                        (["--mesh_dcn", "0"], "must be >= 1"),
                        (["--mesh_data", "-1"], ">= 0")):
        with pytest.raises(SystemExit, match=match):
            common.build_mesh(p.parse_args(argv))


@pytest.mark.parametrize("spec", [(2, 2, 1), (4, 1, 1), (1, 4, 1), (1, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mesh_over_four_ranks(tmp_path, spec):
    """rank = data_index * model + model_index; the model group holds the
    ranks of this data index, the data group those of this model index
    (``dcn_data`` folds into data, slice-major)."""
    ranks = W.spawn(W.mesh_facts, 4, tmp_path, spec)
    data, model = spec[0] * spec[2], spec[1]
    for rank, facts in enumerate(ranks):
        d, j = divmod(rank, model)
        assert facts["coords"] == (d, j)
        assert facts["shape"] == {"data": data, "model": model}
        assert facts["model_group"] == [d * model + k for k in range(model)]
        assert facts["data_group"] == [k * model + j for k in range(data)]


def test_launch_from_torchrun_environment(tmp_path):
    ranks = W.spawn(W.env_launch, 2, tmp_path, init=False)
    assert [r[0] for r in ranks] == [(0, 2), (1, 2)]
    assert all(r[1] == "gloo" and r[2] == r[0] for r in ranks)  # a second call: the same


@pytest.mark.parametrize("on_mesh", [True, False], ids=["on_the_mesh", "off_the_mesh"])
def test_trainer_takes_tables_only_on_its_mesh_on_a_data_axis(on_mesh):
    """On a data axis every table averages its own gradient in its lookup,
    so the Trainer refuses a table built without its mesh (whose gradient
    no route would average); built on it, the table says so in
    ``data_gathered``. No collective runs before the check."""
    from recommender_tpu_torch.core.train import TrainConfig, Trainer
    from recommender_tpu_torch.models import DLRM, make_ctr_task

    mesh = Mesh(2, 1)
    model = DLRM(vocab_size=16, embed_dim=4, bottom_units=(8, 4), top_units=(8, 1),
                 mesh=mesh if on_mesh else None)
    trainer = Trainer(make_ctr_task(model)[0], TrainConfig(), device="cpu", mesh=mesh)
    if on_mesh:
        assert model.embedding.data_gathered == {"embedding"}
        trainer.init_state(lambda: model)
    else:
        with pytest.raises(ValueError, match="trainer's mesh"):
            trainer.init_state(lambda: model)
