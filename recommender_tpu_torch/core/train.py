"""The training engine: step, eval cadence, checkpoints, logging, divergence
guard.

Port of ``recommender_tpu/core/train.py``. A step is the eager PyTorch
sequence forward → backward (the embedding gradient through the sorted
scatter-add kernel) → optimizer step (``core.optim``; ``AdamSR`` by
default), which writes the params in place.

Protocol (``models.tasks``): ``loss_fn(batch, train) -> (per_example_loss
[B], aux dict)`` and ``eval_fn(batch) -> (scores [B], labels [B])``, both
closing over the model. The engine takes the mean of the per-example loss.
There is no ``model_state``: the model's buffers (BatchNorm's running
stats) take its place, updated by the forward of each train step.

On a mesh (``core.mesh``; one process per GPU) each rank feeds its own
rows (``put_batch``), and after the backward the gradients of every
parameter, replicated or a row shard, are averaged over the data group:
the mean of the ranks' local means is the global batch's mean, as JAX's
``psum`` over ``data`` gives it. Every table averages its own gradient in
its lookup's backward (``embedding.sharded``: the data group's ids and
cotangent rows are gathered, and K1 sums them once, so a bf16 table's
gradient is rounded once), and the Trainer all-reduces the other
parameters' gradients in f32; a table on a data axis must be built on the
Trainer's mesh (``init_state`` checks it). The ranks of a model group
compute the same dense gradients from the same rows, so their dense
parameters stay bit-identical. The step's scalar metrics are averaged over the data group
too (``a2a_overflow``, a count already summed over the mesh, excepted).
``evaluate`` sums its metric state over the data group; ``exact=True``
with more than one data rank warns and reports the histogram AUC, as the
JAX package does on more than one host.

``TrainConfig`` holds only the fields this engine implements; any other
field of the JAX config is a ``TypeError`` at construction rather than a
silently ignored setting. ``learning_rate`` may be a schedule (a callable
of the update count, ``nn.schedules``). Early stopping follows JAX's
``_fit_loop``: after ``early_stop_patience`` evals without an improvement
of ``early_stop_metric`` the loop stops, and with a ``checkpoint_dir`` a
checkpoint is written at each improvement only. ``fit`` reads the stream
through a background ``data.pipeline.Prefetcher`` (``prefetch`` batches
ahead; on a CUDA device its thread also pins each batch, ``pin_batch``);
the copy to the device stays on the calling thread (``put_batch``: on a
CUDA device an asynchronous copy on the trainer's copy stream, so the
loop never waits for the device).
``lr_scales`` ``{path-pattern: multiplier}`` scales matching params'
updates after the optimizer (``core.optim.path_scales``).
``optimizer`` ("adam", "adagrad", "sgd") and ``stochastic_round`` (None:
on where the model has a low-precision float param, resolved at
``init_state``) pick the optimizer as JAX's ``make_optimizer`` does
(``core.optim.make_optimizer``). ``accum_steps`` A > 1 splits every batch
into A equal microbatches, runs forward and backward on each, sums their
gradients in f32 (a bf16 table's too: each microbatch's ``.grad`` is taken
out into an f32 sum and cleared, and the sums go to the optimizer
explicitly), divides by A and makes one optimizer update; the loss and aux
metrics are the microbatches' means. BatchNorm's buffers update at each
microbatch's forward, as JAX's ``model_state`` through its ``lax.scan``.
The split step is a TPU layout workaround and has no counterpart.

Checkpoints (``save``, ``restore``, ``TrainConfig.checkpoint_dir``): one
``torch.save`` file per step number, ``step_<number>.pt``, holding the
model's ``state_dict`` (params and BatchNorm buffers), the optimizer's
state (``AdamSR``'s moments and count) and the step. Every table is whole in it: ``save`` is collective,
gathers each row-sharded table and its moments over the model group in
chunks into rank 0's host memory, and rank 0 writes; ``restore`` maps the
file and has every rank copy its rows of the whole tables, so a checkpoint
restores onto another mesh, as orbax's do. Every rounding key derives from
the seed, the step and the count, so a restored run continues bit for
bit, bf16 tables included.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import time
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.convert import jax_leaf_order
from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.core.mesh import Mesh, make_mesh
from recommender_tpu_torch.core.metrics import (
    AUCState,
    MeanState,
    accuracy_update,
    auc_from_state,
    auc_update,
    exact_auc,
    mean_from_state,
    mean_update,
)
from recommender_tpu_torch.core.optim import (
    OPTIMIZERS,
    Optimizer,
    has_low_precision_leaf,
    make_optimizer,
)
from recommender_tpu_torch.core.profiling import annotate
from recommender_tpu_torch.data.pipeline import Prefetcher
from recommender_tpu_torch.nn.losses import binary_cross_entropy
from recommender_tpu_torch.ops.rounding import fold_in, prng_key
from recommender_tpu_torch.parallel.partitioning import (
    data_gathered_params,
    element_offsets,
    row_sharded_params,
)


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float | Callable[[int], float] = 1e-3
    optimizer: str = "adam"  # "adam", "adagrad" or "sgd"
    log_every: int = 100
    eval_every: int = 1000
    seed: int = 0
    # early stopping on an eval metric: 0 = disabled; with a checkpoint_dir,
    # checkpoints are written only at an improvement (best-only)
    early_stop_patience: int = 0
    early_stop_metric: str = "eval_auc"
    early_stop_mode: str = "max"  # any other value minimizes, as in JAX
    # Raise TrainingDiverged on a NaN/Inf loss at a log point (where the
    # loss is fetched to the host anyway, so it costs nothing).
    nan_guard: bool = True
    # Adam moment storage dtype: None = the param's own dtype;
    # "float32" = full-precision moments.
    moment_dtype: Optional[str] = None
    # Per-parameter update scaling {path-pattern: multiplier}, applied after
    # the learning rate (Adam normalizes plain gradient scaling away). A
    # pattern matches whole '/'-separated path components: 'cat_embedding'
    # matches 'cat_embedding.embedding', not 'concat_embedding.embedding'.
    lr_scales: Optional[dict] = None
    # Gradient accumulation: > 1 splits each batch into that many equal
    # microbatches and sums their gradients in f32 before ONE optimizer
    # update; peak activation memory drops with the microbatch.
    accum_steps: int = 1
    # Stochastic rounding of low-precision params' writes (and, with
    # optimizer "adam", of Adam's moments: AdamSR). None = on iff the
    # model has a low-precision float param, resolved at init_state.
    stochastic_round: Optional[bool] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = only on demand
    max_to_keep: int = 3


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


class TrainingDiverged(RuntimeError):
    """Raised by the fit loop's nan_guard on a non-finite loss."""


class Trainer:
    """The engine of one rank (see the module docstring for the protocol).
    ``mesh`` defaults to ``core.mesh.make_mesh()``: 1 x 1 without a process
    group, every rank on ``data`` with one."""

    def __init__(
        self,
        loss_fn: Callable,
        cfg: TrainConfig,
        eval_fn: Optional[Callable] = None,
        *,
        device,
        mesh: Optional[Mesh] = None,
    ):
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = mesh if mesh is not None else make_mesh()
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(cfg.optimizer)
        self._sr_key = fold_in(prng_key(cfg.seed), 0x5EED)
        # cfg.stochastic_round, resolved by init_state
        self.stochastic_round = bool(cfg.stochastic_round)
        self._copy_stream = None  # put_batch's, made at its first call on a CUDA device

    # ------------------------------------------------------------------- init
    def init_state(self, init_model_fn: Callable[[], nn.Module]) -> TrainState:
        """``init_model_fn() -> model`` on this trainer's device.

        Builds the optimizer (``core.optim.make_optimizer``) over the
        params in JAX's flatten order, so that each param's rounding keys
        match the JAX package's. ``cfg.stochastic_round`` None resolves to
        whether the model has a low-precision float param, as in JAX.
        ``cfg.lr_scales`` gives each param its update multiplier by its
        name. A table row-sharded over
        ``model`` must be sharded on this trainer's mesh, and rounds with
        the whole table's noise (``parallel.partitioning``); on a data axis
        wider than 1 every table must be built on this trainer's mesh, whose
        lookup averages the table's gradient."""
        model = init_model_fn()
        named = jax_leaf_order(model)
        # buffers (BatchNorm's running stats) are the JAX Trainer's model_state
        for name, t in [*named, *model.named_buffers()]:
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, trainer on {self.device}")
        for name, module in model.named_modules():
            mesh = getattr(module, "mesh", None)
            partitioned = getattr(module, "partition", None) == "model" and self.mesh.model > 1
            table_on_data = hasattr(module, "data_gathered") and self.mesh.data > 1
            if (mesh is not None or partitioned or table_on_data) and mesh is not self.mesh:
                raise ValueError(
                    f"{name or type(module).__name__} is built on mesh {mesh}, the trainer's "
                    f"is {self.mesh}; build the model with the trainer's mesh=")
        sr = self.cfg.stochastic_round
        self.stochastic_round = (has_low_precision_leaf(p for _, p in named) if sr is None
                                 else bool(sr))
        optimizer = make_optimizer(
            self.cfg, named, stochastic=self.stochastic_round,
            offsets=element_offsets(model, [n for n, _ in named])
            if row_sharded_params(model) else None,
        )
        return TrainState(step=0, model=model, optimizer=optimizer)

    # ------------------------------------------------------------------- step
    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """Forward, backward, optimizer and param write; with
        ``cfg.accum_steps`` > 1, over that many microbatches. Metrics stay
        device tensors until a log point reads them."""
        accum = max(int(self.cfg.accum_steps or 1), 1)
        params = state.optimizer.param_groups[0]["params"]
        if accum == 1:
            with annotate("model.forward"):
                per_ex, aux = self.loss_fn(batch, True)
                loss = torch.mean(per_ex)
            with annotate("model.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                # a param that took no part in the loss has a zero gradient, as in JAX
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            metrics = dict(aux)
            metrics["loss"] = loss.detach()
        else:
            grads, metrics = self._accumulate(state, batch, accum, params)
        if self.mesh.data > 1:  # once a step, on the (accumulated) gradients
            gathered = data_gathered_params(state.model)
            own = {id(p) for n, p in jax_leaf_order(state.model) if n not in gathered}
            mine = [i for i, p in enumerate(params) if id(p) in own]
            for i, g in zip(mine, self._average_grads([grads[i] for i in mine])):
                grads[i] = g
                if accum == 1:  # the gradient the step took, where the caller looks
                    params[i].grad = g
        state.optimizer.step(fold_in(self._sr_key, state.step), grads=grads)
        if self.mesh.data > 1:
            metrics = self._average_metrics(metrics)
        return dataclasses.replace(state, step=state.step + 1), metrics

    def _accumulate(self, state: TrainState, batch: dict, accum: int, params):
        """The f32 mean of the gradients of ``accum`` equal microbatches
        (rows [i B/A, (i + 1) B/A) of every leaf), and the microbatches'
        mean loss and aux metrics. Each microbatch's ``.grad`` goes into an
        f32 sum and is cleared, so that a bf16 param's gradient is not
        summed in bf16 (which ``.grad`` would do, in the param's dtype)."""
        # Host dedup plans index the whole batch's flat id stream: sliced
        # into microbatches they would point past the microbatch.
        plans = [k for k in batch if k.endswith("_dedup")]
        if plans:
            raise ValueError(
                f"dedup plan keys {plans} are incompatible with "
                f"accum_steps={accum} (plans index the whole-batch id "
                "stream); drop the plans or set accum_steps=1"
            )
        for leaf in batch.values():
            b = leaf.shape[0]
            if b % accum:
                raise ValueError(f"accum_steps={accum} must divide the batch size {b}")
        sums = [torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
                            device=p.device) for p in params]
        losses, auxes = [], []
        for i in range(accum):
            micro = {k: v[i * (v.shape[0] // accum):(i + 1) * (v.shape[0] // accum)]
                     for k, v in batch.items()}
            with annotate("model.forward"):
                per_ex, aux = self.loss_fn(micro, True)
                loss = torch.mean(per_ex)
            with annotate("model.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                for acc, p in zip(sums, params):
                    if p.grad is not None:
                        acc += p.grad.to(acc.dtype)
                        p.grad = None
            losses.append(loss.detach())
            auxes.append(aux)
        metrics = {k: torch.mean(torch.stack([torch.as_tensor(a[k]).to(torch.float32)
                                              for a in auxes]))
                   for k in auxes[0]}
        metrics["loss"] = torch.mean(torch.stack(losses))
        return [acc / accum for acc in sums], metrics

    def _average_grads(self, grads: list) -> list:
        """The gradients averaged over the data group, in one f32
        all-reduce, each in its own dtype."""
        if not grads:
            return []
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        distributed.all_reduce(flat, group=self.mesh.data_group)
        flat /= self.mesh.data
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view(g.shape).to(g.dtype))
            start += g.numel()
        return out

    def _average_metrics(self, metrics: dict) -> dict:
        """The step's scalar metrics averaged over the data group in one
        all-reduce; ``a2a_overflow`` is already the mesh's sum."""
        keys = [k for k, v in metrics.items()
                if k != "a2a_overflow" and torch.is_tensor(v) and v.numel() == 1
                and v.is_floating_point()]
        if not keys:
            return metrics
        vals = torch.stack([metrics[k].reshape(()).to(torch.float32) for k in keys])
        distributed.all_reduce(vals, group=self.mesh.data_group)
        vals /= self.mesh.data
        return {**metrics, **dict(zip(keys, vals.unbind()))}

    # ------------------------------------------------------------------- loop
    def fit(
        self,
        state: TrainState,
        train_iter: Iterable,
        steps: int,
        eval_iter_fn: Optional[Callable[[], Iterable]] = None,
        eval_batches: int = 0,
        log_fn: Optional[Callable[[dict], None]] = None,
        prefetch: int = 2,
    ) -> tuple[TrainState, list[dict]]:
        """``steps`` train steps from ``train_iter`` (host batches), with
        logs, evals, checkpoints and early stopping at the configured
        cadences. ``prefetch`` > 0 reads the stream that many batches ahead
        in a background thread, closed on the way out; 0 reads it here. The
        loop takes no batch beyond the ``steps``-th (a prefetcher reads
        ahead all the same). On a CUDA device the prefetcher's thread pins
        each batch (``pin_batch``) for ``put_batch``'s asynchronous copy.
        Under a profiler each step is a ``host.step`` span
        (``core.profiling``)."""
        prefetcher = None
        if prefetch:
            put_fn = pin_batch if self.device.type == "cuda" else None
            prefetcher = Prefetcher(train_iter, size=prefetch, put_fn=put_fn)
            train_iter = prefetcher
        try:
            return self._fit_loop(state, train_iter, steps, eval_iter_fn, eval_batches, log_fn)
        finally:
            if prefetcher is not None:
                prefetcher.close()

    def _fit_loop(self, state, train_iter, steps, eval_iter_fn, eval_batches, log_fn):
        cfg = self.cfg
        history: list[dict] = []
        t0 = time.perf_counter()
        window_examples = 0
        best = None
        stale_evals = 0
        sign = 1.0 if cfg.early_stop_mode == "max" else -1.0
        batches = iter(train_iter)
        queued = getattr(train_iter, "queued", None)  # a Prefetcher's
        for i in range(steps):
            with annotate("host.step") as step_span:
                with annotate("host.input_wait") as wait:
                    if wait.live and queued is not None:
                        wait.add(queued=queued())
                    batch = next(batches, _END)
                if batch is _END:  # the fetch that found the stream's end is no step's
                    step_span.drop()
                    break
                batch = self.put_batch(batch)
                state, metrics = self.train_step(state, batch)
                window_examples += _batch_size(batch) * self.mesh.data
                step = i + 1
                if step % cfg.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if cfg.nan_guard and not math.isfinite(metrics.get("loss", 0.0)):
                        raise TrainingDiverged(
                            f"non-finite loss {metrics['loss']} at step {step}; "
                            "restart with a lower learning rate"
                        )
                    dt = time.perf_counter() - t0
                    metrics["examples_per_s"] = window_examples / max(dt, 1e-9)
                    metrics["step"] = step
                    history.append(metrics)
                    if log_fn:
                        log_fn(metrics)
                    t0 = time.perf_counter()
                    window_examples = 0
                if eval_iter_fn is not None and cfg.eval_every and step % cfg.eval_every == 0:
                    ev = self.evaluate(state, eval_iter_fn(), eval_batches)
                    ev["step"] = step
                    history.append(ev)
                    if log_fn:
                        log_fn(ev)
                    # eval wall-clock must not pollute the throughput window
                    t0 = time.perf_counter()
                    window_examples = 0
                    if cfg.early_stop_patience:
                        value = sign * ev.get(cfg.early_stop_metric, float("-inf"))
                        if best is None or value > best:
                            best = value
                            stale_evals = 0
                            if cfg.checkpoint_dir:
                                self.save(state)  # best-only checkpointing
                        else:
                            stale_evals += 1
                            if stale_evals >= cfg.early_stop_patience:
                                history.append({"early_stopped": True, "step": step})
                                break
                if (cfg.checkpoint_dir and cfg.checkpoint_every
                        and step % cfg.checkpoint_every == 0):
                    self.save(state)
        return state, history

    @torch.no_grad()
    def evaluate(
        self, state: TrainState, batches: Iterable, limit: int = 0, exact: bool = False
    ) -> dict:
        """Streaming histogram AUC, BCE and accuracy accumulated on the
        device and summed over the data group; ``exact=True`` also gathers
        scores and labels to the host for the sort-based exact AUC (one data
        rank only: with more it warns and keeps the histogram AUC)."""
        if self.eval_fn is None:
            raise ValueError("no eval_fn configured")
        if exact and self.mesh.data > 1:
            warnings.warn(
                "evaluate(exact=True) gathers scores to one rank and takes one data rank; "
                "falling back to the streaming histogram AUC, summed over the data group",
                stacklevel=3,
            )
            exact = False
        auc = AUCState.init(device=self.device)
        mloss = MeanState.init(device=self.device)
        acc = MeanState.init(device=self.device)
        n = 0
        all_scores, all_labels = [], []
        for batch in batches:
            if limit and n >= limit:
                break
            batch = self.put_batch(batch)
            scores, labels = self.eval_fn(batch)
            auc = auc_update(auc, scores, labels)
            mloss = mean_update(mloss, binary_cross_entropy(scores, labels))
            acc = accuracy_update(acc, scores, labels)
            if exact:
                all_scores.append(scores.reshape(-1).cpu().numpy())
                all_labels.append(labels.reshape(-1).cpu().numpy())
            n += 1
        if n == 0:
            raise ValueError(
                "evaluate(): iterator yielded no batches — check that the eval "
                "set is at least one (drop-remainder) batch long"
            )
        if self.mesh.data > 1:
            auc, mloss, acc = self._sum_over_data(auc, mloss, acc)
        out = {
            "eval_auc": float(auc_from_state(auc)),
            "eval_loss": float(mean_from_state(mloss)),
            "eval_accuracy": float(mean_from_state(acc)),
            "eval_batches": n,
        }
        if exact:
            out["eval_auc_exact"] = exact_auc(
                np.concatenate(all_scores), np.concatenate(all_labels)
            )
        return out

    def _sum_over_data(self, auc: AUCState, mloss: MeanState, acc: MeanState):
        """The eval metric states summed over the data group (one all-reduce)."""
        parts = [auc.pos, auc.neg, *(t.reshape(1) for t in (*mloss, *acc))]
        flat = distributed.all_reduce(torch.cat(parts), group=self.mesh.data_group)
        bins = auc.pos.numel()
        pos, neg, rest = flat[:bins], flat[bins:2 * bins], flat[2 * bins:]
        return AUCState(pos, neg), MeanState(rest[0], rest[1]), MeanState(rest[2], rest[3])

    # ------------------------------------------------------------ checkpoints
    def _checkpoints(self) -> list[tuple[int, str]]:
        """(step, path) of every checkpoint in the directory, oldest first."""
        root = self.cfg.checkpoint_dir
        if not root:
            raise ValueError("no checkpoint_dir configured")
        if not os.path.isdir(root):
            return []
        found = []
        for name in os.listdir(root):
            m = _CHECKPOINT_NAME.fullmatch(name)
            if m:
                found.append((int(m.group(1)), os.path.join(root, name)))
        return sorted(found)

    def _sharded_entries(self, state: TrainState):
        """(state_dict name, optimizer leaf index or None, (first row, whole
        rows)) of every row-sharded param and its moments."""
        shards = row_sharded_params(state.model)
        index = {n: i for i, (n, _) in enumerate(jax_leaf_order(state.model))}
        return [(name, index[name], rows) for name, rows in shards.items()]

    def save(self, state: TrainState) -> str:
        """Write the checkpoint of ``state.step`` (to a temporary name, then
        renamed) and prune all but the newest ``max_to_keep``. Collective on
        a mesh: every rank calls it; the row shards of data rank 0's model
        group are gathered into rank 0's host memory (``_whole_rows``),
        rank 0 writes, and every rank returns once the file is there."""
        kept = self._checkpoints()  # raises without a checkpoint_dir
        path = os.path.join(self.cfg.checkpoint_dir, f"step_{state.step}.pt")
        write = self.mesh.rank == 0
        if self.mesh.data_index == 0:
            model_sd = state.model.state_dict()
            opt = state.optimizer.state_dict()
            for name, i, _ in self._sharded_entries(state):
                model_sd[name] = self._whole_rows(model_sd[name])
                for which in state.optimizer.slots:
                    opt[which][i] = self._whole_rows(opt[which][i])
        if write:
            os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
            tmp = f"{path}.tmp"
            torch.save({"step": state.step, "model": model_sd, "optimizer": opt}, tmp)
            os.replace(tmp, path)
            kept = sorted({*kept, (state.step, path)})
            for _, old in kept[: max(len(kept) - self.cfg.max_to_keep, 0)]:
                os.remove(old)
        distributed.barrier(self.device)
        return path

    def _whole_rows(self, shard: torch.Tensor) -> Optional[torch.Tensor]:
        """A row shard's whole table in rank 0's host memory (``None`` on
        the other ranks), gathered over the model group in chunks of at
        most ``SAVE_CHUNK_BYTES`` a rank, so no device holds more than its
        shard and one chunk of each rank's."""
        m, rows = self.mesh.model, shard.shape[0]
        shard = shard.contiguous()
        row_bytes = shard[:1].numel() * shard.element_size()
        chunk = max(1, min(rows, SAVE_CHUNK_BYTES // max(row_bytes, 1)))
        keep = self.mesh.rank == 0
        whole = torch.empty((m * rows, *shard.shape[1:]), dtype=shard.dtype) if keep else None
        buf = torch.empty((m * chunk, *shard.shape[1:]), dtype=shard.dtype, device=shard.device)
        for a in range(0, rows, chunk):
            n = min(chunk, rows - a)
            got = distributed.all_gather_into_tensor(buf[:m * n], shard[a:a + n],
                                                     group=self.mesh.model_group)
            if keep:  # block j is model rank j's rows [a, a + n)
                for j in range(m):
                    whole[j * rows + a:j * rows + a + n].copy_(got[j * n:(j + 1) * n])
        return whole

    def restore(self, state_like: TrainState) -> TrainState:
        """Load the newest checkpoint into ``state_like``'s model and
        optimizer, in place, and return the state at its step;
        ``state_like`` unchanged where the directory holds none. A row
        shard takes its rows of the checkpoint's whole table, whatever mesh
        wrote it."""
        found = self._checkpoints()
        if not found:
            return state_like
        _, path = found[-1]
        # mapped, not read: each rank copies only its rows of a whole table
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        model_sd, opt = payload["model"], payload["optimizer"]
        own = state_like.model.state_dict()
        for name, i, (lo, vocab) in self._sharded_entries(state_like):
            rows = own[name].shape[0]
            if model_sd[name].shape[0] != vocab:
                raise ValueError(f"{name}: the checkpoint holds {model_sd[name].shape[0]} rows, "
                                 f"the table has {vocab}")
            model_sd[name] = model_sd[name][lo:lo + rows]
            for which in state_like.optimizer.slots:
                opt[which][i] = opt[which][i][lo:lo + rows]
        state_like.model.load_state_dict(model_sd, strict=True)
        state_like.optimizer.load_state_dict(opt)
        return dataclasses.replace(state_like, step=int(payload["step"]))

    def put_batch(self, batch: dict) -> dict:
        """Copy this rank's rows of the batch (numpy arrays, or pinned CPU
        tensors from ``pin_batch``) to the trainer's device; nested dicts
        (a dedup plan, ``batch["cat_dedup"]``) are copied entry by entry.
        Spanned as ``host.put_batch``, counting the leaves' bytes.

        On a CUDA device nothing here waits for the device: each leaf goes
        from page-locked memory to the card with ``non_blocking`` on the
        trainer's copy stream, and the current stream waits for that copy
        on the device. A leaf that arrives in pageable memory is pinned
        here first, on this thread, and counted as ``pageable_bytes`` (0
        where every leaf came pinned). Each device leaf is marked as used
        by the current stream, so the caching allocator does not hand its
        memory out again before the step has read it."""
        with annotate("host.put_batch") as span:
            if self.device.type != "cuda":
                return self._put(batch, span)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            span.add(pageable_bytes=0)
            with torch.cuda.stream(self._copy_stream):
                out = self._put(batch, span, compute)
            compute.wait_stream(self._copy_stream)
            return out

    def _put(self, batch: dict, span, compute=None) -> dict:
        """``put_batch``'s copies; with ``compute``, the CUDA stream that
        reads the leaves, asynchronous ones from pinned memory."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, dict):
                out[k] = self._put(v, span, compute)
                continue
            pinned = compute is not None and torch.is_tensor(v) and v.is_pinned()
            host = v if pinned else torch.as_tensor(np.asarray(v))
            if span.live:
                span.add(bytes=host.nbytes)
            if compute is None:
                out[k] = host.to(self.device)
                continue
            if not pinned:
                if span.live:
                    span.add(pageable_bytes=host.nbytes)
                host = _pinned(host)
            out[k] = host.to(self.device, non_blocking=True)
            out[k].record_stream(compute)
        return out


def pin_batch(batch: dict) -> dict:
    """The batch with each leaf a CPU tensor in page-locked memory, nested
    dicts entry by entry: what ``fit``'s prefetcher hands ``put_batch`` on
    a CUDA device, made in its thread."""
    return {k: pin_batch(v) if isinstance(v, dict) else _pinned(torch.as_tensor(np.asarray(v)))
            for k, v in batch.items()}


def _pinned(host: torch.Tensor) -> torch.Tensor:
    """A copy of the CPU tensor ``host`` in page-locked memory from
    PyTorch's caching host allocator, which takes a block back only once
    the copy that read it has completed. numpy makes the copy, on one
    thread and without the interpreter lock: ``Tensor.pin_memory`` copies
    on every OpenMP thread, which then spin (on an 8-core H100 host, ~50
    CPU ms a 7 ms DLRM step against ~8 this way)."""
    out = torch.empty_like(host, pin_memory=True)
    np.copyto(out.numpy(), host.numpy())
    return out


_END = object()  # what the fit loop's fetch returns at the stream's end
_CHECKPOINT_NAME = re.compile(r"step_(\d+)\.pt")
SAVE_CHUNK_BYTES = 64 << 20  # each model rank's rows per gather of a checkpoint


def _batch_size(batch: dict) -> int:
    """Rows of the batch: the leading dim of its first top-level array (a
    nested plan's arrays are per id, not per row)."""
    first = next((v for v in batch.values() if not isinstance(v, dict)), None)
    return int(first.shape[0]) if first is not None else 0
