"""Rank workers for the port's multi-process tests (no jax imported here).

``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, world, path, *args)``
in ``world`` fresh processes (``multiprocessing``'s spawn), each with one
intra-op thread and a gloo group on the CPU that meets through a file
under ``tmp_path`` (no port to race for between test workers), and returns
each rank's result in rank order. The workers import only torch, numpy and
the port, so a rank starts in about a second; the test files hold the JAX
side.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import traceback

import numpy as np

TIMEOUT = 240  # seconds for every rank of one spawn


def _run(fn, rank, world, path, args, results, init):
    import torch

    torch.set_num_threads(1)
    try:
        from recommender_tpu_torch.core.distributed import initialize_from_flags

        if init:
            initialize_from_flags(f"file://{path}", world, rank, device="cpu")
        results.put((rank, fn(rank, world, path, *args)))
    except BaseException:  # the parent re-raises it with the traceback
        results.put((rank, RuntimeError(traceback.format_exc())))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, init: bool = True) -> list:
    """``fn(rank, world, rendezvous path, *args)`` on ``world`` gloo ranks;
    raises with a rank's traceback if one failed. ``init=False`` leaves the
    process group to ``fn`` (an entry point that joins from its flags)."""
    path = os.path.join(str(tmp_path), f"rdzv_{fn.__name__}_{world}_{os.urandom(4).hex()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_run, args=(fn, r, world, path, args, results, init))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:  # drain before joining
            rank, value = results.get(timeout=TIMEOUT)
            got[rank] = value
    except queue.Empty:
        raise TimeoutError(f"{fn.__name__}: ranks {sorted(set(range(world)) - set(got))} "
                           f"gave no result in {TIMEOUT} s")
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if isinstance(got[rank], BaseException):
            raise got[rank]
    return [got[r] for r in range(world)]


def params_np(model) -> dict:
    return {n: p.detach().float().numpy().copy() for n, p in model.named_parameters()}


def grads_np(model) -> dict:
    return {n: p.grad.detach().float().numpy().copy() for n, p in model.named_parameters()}


def rows_of(batch: dict, mesh) -> dict:
    """This rank's contiguous rows of a global batch."""
    share = len(next(iter(batch.values()))) // mesh.data
    lo = mesh.data_index * share
    return {k: v[lo:lo + share] for k, v in batch.items()}


# ------------------------------------------------------------------ mesh
def mesh_facts(rank, world, path, spec):
    """Coordinates, and each group's members seen through an all-reduce of
    one-hot rank vectors."""
    import torch

    from recommender_tpu_torch.core import distributed
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(*spec))
    out = {"coords": (mesh.data_index, mesh.model_index), "shape": mesh.shape}
    for name, group in (("model_group", mesh.model_group), ("data_group", mesh.data_group)):
        onehot = torch.zeros(world)
        onehot[rank] = 1.0
        out[name] = np.flatnonzero(distributed.all_reduce(onehot, group=group).numpy()).tolist()
    return out


def env_launch(rank, world, path):
    """``initialize_from_flags()`` from torchrun's environment alone."""
    import torch.distributed as dist

    from recommender_tpu_torch.core.distributed import initialize_from_flags

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port(rank, path)),
                      WORLD_SIZE=str(world), RANK=str(rank))
    got = initialize_from_flags(device="cpu")
    return got, dist.get_backend(), initialize_from_flags(device="cpu")


def _free_port(rank, path) -> int:
    """Rank 0 picks a free port and hands it on through a file."""
    import socket
    import time

    port_file = f"{path}.port"
    if rank == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with open(port_file + ".tmp", "w") as f:
            f.write(str(port))
        os.replace(port_file + ".tmp", port_file)
        return port
    for _ in range(600):
        if os.path.exists(port_file):
            with open(port_file) as f:
                return int(f.read())
        time.sleep(0.05)
    raise TimeoutError("no port from rank 0")


# ---------------------------------------------------------------- lookups
def lookup(rank, world, path, spec, table, ids, weight, mode, capacity):
    """One sharded lookup and its backward: this rank's outputs for its data
    rows of ``ids``, its shard's gradient of ``sum(out * weight)``, and the
    overflow count (a2a)."""
    import torch

    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.embedding import sharded

    mesh = make_mesh(MeshSpec(*spec))
    local = rows_of({"ids": ids, "w": weight}, mesh)
    shard = sharded.shard_table(torch.from_numpy(table), mesh).clone().requires_grad_(True)
    ids_t = torch.from_numpy(local["ids"])
    dropped = None
    if mode == "psum":
        out = sharded.sharded_lookup(shard, ids_t, mesh)
    elif mode == "a2a":
        out, dropped = sharded.all_to_all_lookup(shard, ids_t, mesh, capacity, return_overflow=True)
        dropped = int(dropped)
    else:
        out = sharded.sort_coalesced_lookup(shard, ids_t, mesh)
    torch.sum(out * torch.from_numpy(local["w"])).backward()
    return {"out": out.detach().numpy(), "grad": shard.grad.numpy(), "dropped": dropped,
            "lo": mesh.model_index * shard.shape[0]}


# ------------------------------------------------------------------- DLRM
DLRM_KW = dict(vocab_size=64, embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))


def dlrm_step(rank, world, path, spec, params, batch, lookup_mode, table_dtype, steps, lr):
    """``steps`` Trainer steps of a DLRM whose table is row-sharded over
    ``model`` (built on the mesh, loaded from a converted JAX tree), each on
    this rank's rows of ``batch``: losses, the trained params (shards as
    they are), the first step's gradients."""
    import torch

    from recommender_tpu_torch.convert import load_flax_params
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.core.train import TrainConfig, Trainer
    from recommender_tpu_torch.models import DLRM, make_ctr_task

    mesh = make_mesh(MeshSpec(*spec))
    dtype = getattr(torch, table_dtype)
    model = DLRM(**DLRM_KW, embed_param_dtype=dtype, partition="model", lookup_mode=lookup_mode,
                 mesh=mesh)
    if params is not None:
        load_flax_params(model, params)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=lr), eval_fn, device="cpu", mesh=mesh)
    state = trainer.init_state(lambda: model)
    local = trainer.put_batch(rows_of(batch, mesh))
    losses, grads = [], None
    for i in range(steps):
        state, metrics = trainer.train_step(state, local)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = grads_np(model)
    return {"losses": losses, "params": params_np(model), "grads": grads,
            "lo": model.embedding.row_offset, "metrics": {k: float(v) for k, v in metrics.items()}}


# -------------------------------------------------------------- two-tower
TT_KW = dict(user_vocab=48, item_vocab=40, embed_dim=8, repr_dim=8, tower_units=(16,))


def two_tower_grads(rank, world, path, params, batch, f32_towers):
    """One two-tower loss and backward on this rank's rows of ``batch``,
    the item reprs gathered over the data axis; the gradients averaged as
    the Trainer averages them."""
    import torch

    from recommender_tpu_torch.convert import load_flax_params
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.core.train import TrainConfig, Trainer
    from recommender_tpu_torch.models import TwoTower, make_two_tower_task

    mesh = make_mesh(MeshSpec(world, 1))
    model = load_flax_params(TwoTower(**TT_KW, mesh=mesh), params)
    if f32_towers:
        model.user_tower.compute_dtype = model.item_tower.compute_dtype = torch.float32
    loss_fn, eval_fn = make_two_tower_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=1e-3), eval_fn, device="cpu", mesh=mesh)
    state = trainer.init_state(lambda: model)
    _, metrics = trainer.train_step(state, trainer.put_batch(rows_of(batch, mesh)))
    hits, _ = eval_fn(trainer.put_batch(rows_of(batch, mesh)))
    return {"loss": float(metrics["loss"]), "grads": grads_np(model),
            "hits": hits.numpy(), "top1": float(metrics["inbatch_top1"])}


# -------------------------------------------------------- DIN, data axis
DIN_KW = dict(item_vocab=64, cat_vocab=8, item_dim=4, cat_dim=4, mlp_units=(8, 1))


def din_losses(rank, world, path, params, batch_stats, batches, lr):
    """DIN Trainer steps on a (world, 1) mesh from a converted JAX init,
    each rank on its rows of every global batch: the init's eval over those
    batches, then the losses (the input BatchNorm's statistics are the
    global batch's)."""
    from recommender_tpu_torch.convert import load_flax_params
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.core.train import TrainConfig, Trainer
    from recommender_tpu_torch.models import DIN, make_ctr_task

    mesh = make_mesh(MeshSpec(world, 1))
    model = load_flax_params(DIN(**DIN_KW, mesh=mesh), params, batch_stats)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=lr), eval_fn, device="cpu", mesh=mesh)
    state = trainer.init_state(lambda: model)
    ev = trainer.evaluate(state, [rows_of(b, mesh) for b in batches])  # the init's
    losses = []
    for batch in batches:
        state, metrics = trainer.train_step(state, trainer.put_batch(rows_of(batch, mesh)))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "eval": ev, "bn_mean": model.mlp.BatchNorm_0.mean.numpy().copy()}


# ------------------------------------------------------------ checkpoints
def ctr_checkpoint(rank, world, path, spec, ckpt_dir, steps, save):
    """A small bf16 DLRM (psum on a model axis) trained ``steps`` steps from
    seed 0 on fixed batches, then saved (``save``) or first restored from
    ``ckpt_dir``; its whole params gathered for the caller. A save on a
    model axis gathers the shards in chunks of 5 rows (the last one
    ragged), as a table larger than ``SAVE_CHUNK_BYTES`` is gathered."""
    import torch

    from recommender_tpu_torch.core import distributed, train
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.core.train import TrainConfig, Trainer
    from recommender_tpu_torch.data import SyntheticCTR
    from recommender_tpu_torch.models import DLRM, init_model, make_ctr_task

    mesh = make_mesh(MeshSpec(*spec))
    model = DLRM(**DLRM_KW, embed_param_dtype=torch.bfloat16, partition="model",
                 lookup_mode="psum", mesh=mesh)
    init_model(model, seed=0)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=1e-2, checkpoint_dir=ckpt_dir),
                      eval_fn, device="cpu", mesh=mesh)
    state = trainer.init_state(lambda: model)
    if not save:
        state = trainer.restore(state)
    data = SyntheticCTR(vocab_size=64, seed=0).sample(32 * 8, seed=1)
    for i in range(state.step, state.step + steps):
        batch = {k: v[32 * (i % 8):32 * (i % 8 + 1)] for k, v in data.items()}
        state, _ = trainer.train_step(state, trainer.put_batch(rows_of(batch, mesh)))
    table = model.embedding.embedding.detach()
    mu = state.optimizer.state[model.embedding.embedding]["mu"]
    if save:
        train.SAVE_CHUNK_BYTES = 5 * table.shape[1] * 4  # 5 rows of the f32 moments
        trainer.save(state)
    if mesh.model > 1:
        def whole(t):
            out = torch.empty((t.shape[0] * mesh.model, t.shape[1]), dtype=t.dtype)
            return distributed.all_gather_into_tensor(out, t.contiguous(), mesh.model_group)

        table, mu = whole(table), whole(mu)
    return {"step": state.step, "table": table.float().numpy(), "mu": mu.float().numpy(),
            "dense": {n: v for n, v in params_np(model).items() if n != "embedding.embedding"}}


# --------------------------------------------------------------- dry run
def dryrun(rank, world, path, spec):
    from recommender_tpu_torch.core.mesh import MeshSpec
    from recommender_tpu_torch.dryrun import dryrun_multichip

    return dryrun_multichip("cpu", MeshSpec(*spec))


def dryrun_cli(rank, world, path):
    """The dry run's entry point as one rank, joining from its own flags."""
    from recommender_tpu_torch import dryrun

    return dryrun.main(["--device", "cpu", "--coordinator_address", f"file://{path}",
                        "--num_processes", str(world), "--process_id", str(rank)])


# ------------------------------------------------------------------- CLIs
def cli_main(rank, world, path, module, argv):
    """``recommender_tpu_torch.cli.<module>.main(argv)`` as one rank, its
    stdout captured: the exact per-step losses, the JSON lines, the trained
    table's rows here and their first row."""
    import contextlib
    import importlib
    import io
    import json

    from recommender_tpu_torch.core.train import Trainer

    losses = []
    real = Trainer.train_step

    def step(self, state, batch):
        state, metrics = real(self, state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    Trainer.train_step = step
    if "--num_processes" in argv:
        argv = [*argv, "--process_id", str(rank)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            state = importlib.import_module(f"recommender_tpu_torch.cli.{module}").main(argv)
    finally:
        Trainer.train_step = real
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    if isinstance(state, dict):  # BASE's two models
        return {"losses": losses, "lines": lines}
    tables = {n: (m.embedding.detach().float().numpy().copy(), getattr(m, "row_offset", 0))
              for n, m in state.model.named_modules() if hasattr(m, "row_shards")
              and hasattr(m, "embedding")}
    return {"losses": losses, "lines": lines, "tables": tables, "step": state.step}


# ---------------------------------------------------------------- serving
def serve_sharded(rank, world, path, reprs, latest, seen, num_items, sampler_seed):
    """``recommend_topk`` and PinSage's ``full_corpus_reprs`` with the data
    axis splitting each batch's users or nodes; every rank's answer."""
    import torch

    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.graph.bipartite import BipartiteGraph
    from recommender_tpu_torch.models import ItemFeatures, PinSage, init_model
    from recommender_tpu_torch.retrieval import eval as reval

    mesh = make_mesh(MeshSpec(world, 1))
    recs = reval.recommend_topk(reprs, latest, seen, k=5, batch_size=7, mesh=mesh)
    rng = np.random.default_rng(sampler_seed)
    users = np.repeat(np.arange(16), 4)
    g = BipartiteGraph(users, rng.integers(0, num_items, len(users)), 16, num_items)
    feats = ItemFeatures(year=rng.integers(0, 5, num_items).astype(np.int32),
                         genre=(rng.random((num_items, 6)) < 0.3).astype(np.float32))
    torch.manual_seed(0)
    model = init_model(PinSage(features=feats, embed_dim=8, conv_hidden=16, conv_out=8), seed=0)
    corpus = reval.full_corpus_reprs(model, g, np.random.default_rng(5), batch_size=8,
                                     mesh=mesh if world > 1 else None)
    return {"recs": recs, "corpus": corpus}
