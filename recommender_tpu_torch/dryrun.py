"""A dry run of full training steps over a (data x model) mesh of ranks.

Port of ``__graft_entry__.py::dryrun_multichip``: one DLRM step and one
PinSage step at tiny shapes, with the batch split over ``data`` and each
embedding table row-sharded over ``model`` (DLRM through the psum exchange,
the planner's route for big sharded tables). Every rank of an initialized
process group calls it with the same arguments (``core.distributed``). It
runs on each rank's card (``cuda:{rank % device_count}``) unless
``--device cpu`` asks for the CPU:

    python -m torch.distributed.run --nproc_per_node 4 -m recommender_tpu_torch.dryrun
    python -m recommender_tpu_torch.dryrun --device cpu --coordinator_address \
        127.0.0.1:29500 --num_processes 2 --process_id 0   # and process 1

or from code, ``dryrun_multichip(device, MeshSpec(2, 2))`` in each of four
ranks. Without a process group it runs the 1 x 1 mesh.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch.distributed as dist

from recommender_tpu_torch.cli.common import add_launch_flags, resolve_device, setup_distributed
from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.graph.bipartite import BipartiteGraph
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.pinsage import ItemFeatures, PinSage
from recommender_tpu_torch.models.pinsage_task import make_pinsage_task, pinsage_train_batches
from recommender_tpu_torch.models.tasks import init_model, make_ctr_task


def _rows(tree: dict, mesh) -> dict:
    """This rank's rows of a global batch (every leaf's leading dim a
    multiple of the data axis)."""
    out = {}
    for k, v in tree.items():
        share = len(v) // mesh.data
        out[k] = v[mesh.data_index * share:(mesh.data_index + 1) * share]
    return out


def dryrun_multichip(device, spec: Optional[MeshSpec] = None) -> dict:
    """One train step each of DLRM and PinSage on the mesh ``spec`` (by
    default the model axis 2 where the ranks divide by 2, the rest on
    ``data``); returns their finite losses, the same on every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec is None:
        model_axis = 2 if world % 2 == 0 else 1
        spec = MeshSpec(data=world // model_axis, model=model_axis)
    mesh = make_mesh(spec)
    sharded = dict(partition="model", mesh=mesh)
    rng = np.random.default_rng(0)

    # ---- DLRM: the table row-sharded over 'model', the psum exchange
    vocab = 64 * mesh.model
    model = DLRM(vocab_size=vocab, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1),
                 lookup_mode="psum", device=device, **sharded)
    b = 8 * mesh.data
    batch = {
        "int_features": rng.normal(size=(b, 13)).astype(np.float32),
        "cat_features": rng.integers(0, vocab, size=(b, 26)).astype(np.int32),
        "label": (rng.random(b) < 0.5).astype(np.float32),
    }
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=1e-3), eval_fn, device=device,
                      mesh=mesh)
    state = trainer.init_state(lambda: init_model(model))
    _, metrics = trainer.train_step(state, trainer.put_batch(_rows(batch, mesh)))

    # ---- PinSage: graph-block batches, the id table row-sharded over 'model'
    users, items = 32, 32 * mesh.model
    us = np.repeat(np.arange(users), 4)
    g = BipartiteGraph(us, rng.integers(0, items, len(us)), users, items)
    feats = ItemFeatures(year=rng.integers(0, 5, items).astype(np.int32),
                         genre=(rng.random((items, 6)) < 0.3).astype(np.float32))
    ps_model = PinSage(features=feats, embed_dim=8, conv_hidden=16, conv_out=8,
                       device=device, **sharded)
    # each data rank samples its own 4 blocks, as the entry point does
    ps_batch = next(pinsage_train_batches(g, 4, seed=mesh.data_index))
    ps_trainer = Trainer(make_pinsage_task(ps_model), TrainConfig(learning_rate=1e-3),
                         device=device, mesh=mesh)
    ps_state = ps_trainer.init_state(lambda: init_model(ps_model))
    _, ps_metrics = ps_trainer.train_step(ps_state, ps_trainer.put_batch(ps_batch))

    losses = {"dlrm": float(metrics["loss"]), "pinsage": float(ps_metrics["loss"])}
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite dry-run losses {losses}")
    return losses


def main(argv=None) -> dict:
    """The entry point: join the job the flags or torchrun's environment
    describe (none: one process), run ``dryrun_multichip`` on this rank's
    device, print its losses; leave a process group it found as it was."""
    p = add_launch_flags(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    args = p.parse_args(argv)
    joined = not dist.is_initialized()
    setup_distributed(args)  # before any device use: it picks this rank's card
    joined = joined and dist.is_initialized()
    try:
        losses = dryrun_multichip(resolve_device(args))
        print(losses, flush=True)
    finally:
        if joined:
            dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
