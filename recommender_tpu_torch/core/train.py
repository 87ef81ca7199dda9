"""The training engine: step, eval cadence, checkpoints, logging, divergence
guard.

Port of ``recommender_tpu/core/train.py`` for one device. A step is the
eager PyTorch sequence forward → backward (the embedding gradient through
the sorted scatter-add kernel) → ``AdamSR`` step, which writes the params
in place.

Protocol (``models.tasks``): ``loss_fn(batch, train) -> (per_example_loss
[B], aux dict)`` and ``eval_fn(batch) -> (scores [B], labels [B])``, both
closing over the model. The engine takes the mean of the per-example loss.
There is no ``model_state``: the model's buffers (BatchNorm's running
stats) take its place, updated by the forward of each train step.

``TrainConfig`` holds only the fields this engine implements; any other
field of the JAX config is a ``TypeError`` at construction rather than a
silently ignored setting. ``learning_rate`` may be a schedule (a callable
of the update count, ``nn.schedules``). Early stopping follows JAX's
``_fit_loop``: after ``early_stop_patience`` evals without an improvement
of ``early_stop_metric`` the loop stops, and with a ``checkpoint_dir`` a
checkpoint is written at each improvement only. ``fit`` reads the stream
through a background ``data.pipeline.Prefetcher`` (``prefetch`` batches
ahead; the copy to the device stays on the calling thread).
``lr_scales`` ``{path-pattern: multiplier}`` scales matching params'
updates after the optimizer (``core.optim.path_scales``). Gradient
accumulation belongs to a later slice; the split step is a TPU layout
workaround and has no counterpart.

Checkpoints (``save``, ``restore``, ``TrainConfig.checkpoint_dir``): one
``torch.save`` file per step number, ``step_<number>.pt``, holding the
model's ``state_dict`` (params and BatchNorm buffers), ``AdamSR``'s moments
and count, and the step. Every rounding key derives from the seed, the step
and the count, so a restored run continues bit for bit, bf16 tables
included.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from recommender_tpu_torch.convert import jax_leaf_order
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
from recommender_tpu_torch.core.optim import AdamSR, path_scales
from recommender_tpu_torch.data.pipeline import Prefetcher
from recommender_tpu_torch.nn.losses import binary_cross_entropy
from recommender_tpu_torch.ops.rounding import fold_in, prng_key


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float | Callable[[int], float] = 1e-3
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
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = only on demand
    max_to_keep: int = 3


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: AdamSR


class TrainingDiverged(RuntimeError):
    """Raised by the fit loop's nan_guard on a non-finite loss."""


class Trainer:
    """Single-device engine (see the module docstring for the protocol)."""

    def __init__(
        self,
        loss_fn: Callable,
        cfg: TrainConfig,
        eval_fn: Optional[Callable] = None,
        *,
        device,
    ):
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._sr_key = fold_in(prng_key(cfg.seed), 0x5EED)

    # ------------------------------------------------------------------- init
    def init_state(self, init_model_fn: Callable[[], nn.Module]) -> TrainState:
        """``init_model_fn() -> model`` on this trainer's device.

        Builds ``AdamSR`` over the params in JAX's flatten order, so that
        each param's rounding keys match the JAX package's. Stochastic
        rounding applies to the low-precision params — the JAX Trainer's
        automatic ``stochastic_round`` mode. ``cfg.lr_scales`` gives each
        param its update multiplier by its name."""
        model = init_model_fn()
        named = jax_leaf_order(model)
        # buffers (BatchNorm's running stats) are the JAX Trainer's model_state
        for name, t in [*named, *model.named_buffers()]:
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, trainer on {self.device}")
        mdt = self.cfg.moment_dtype
        optimizer = AdamSR(
            [p for _, p in named],
            lr=self.cfg.learning_rate,
            seed=self.cfg.seed,
            moment_dtype=None if mdt is None else getattr(torch, mdt),
            scales=path_scales([n for n, _ in named], self.cfg.lr_scales)
            if self.cfg.lr_scales else None,
        )
        return TrainState(step=0, model=model, optimizer=optimizer)

    # ------------------------------------------------------------------- step
    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """Forward, backward, optimizer and param write. Metrics stay device
        tensors until a log point reads them."""
        per_ex, aux = self.loss_fn(batch, True)
        loss = torch.mean(per_ex)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step(fold_in(self._sr_key, state.step))
        metrics = dict(aux)
        metrics["loss"] = loss.detach()
        return dataclasses.replace(state, step=state.step + 1), metrics

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
        in a background thread, closed on the way out; 0 reads it here."""
        prefetcher = None
        if prefetch:
            prefetcher = Prefetcher(train_iter, size=prefetch)
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
        for i, batch in enumerate(train_iter):
            if i >= steps:
                break
            batch = self.put_batch(batch)
            state, metrics = self.train_step(state, batch)
            window_examples += _batch_size(batch)
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
            if cfg.checkpoint_dir and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                self.save(state)
        return state, history

    @torch.no_grad()
    def evaluate(
        self, state: TrainState, batches: Iterable, limit: int = 0, exact: bool = False
    ) -> dict:
        """Streaming histogram AUC, BCE and accuracy accumulated on the
        device; ``exact=True`` also gathers scores and labels to the host
        for the sort-based exact AUC."""
        if self.eval_fn is None:
            raise ValueError("no eval_fn configured")
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

    def save(self, state: TrainState) -> str:
        """Write the checkpoint of ``state.step`` (to a temporary name, then
        renamed) and prune all but the newest ``max_to_keep``."""
        kept = self._checkpoints()  # raises without a checkpoint_dir
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.cfg.checkpoint_dir, f"step_{state.step}.pt")
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        }
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        kept = sorted({*kept, (state.step, path)})
        for _, old in kept[: max(len(kept) - self.cfg.max_to_keep, 0)]:
            os.remove(old)
        return path

    def restore(self, state_like: TrainState) -> TrainState:
        """Load the newest checkpoint into ``state_like``'s model and
        optimizer, in place, and return the state at its step;
        ``state_like`` unchanged where the directory holds none."""
        found = self._checkpoints()
        if not found:
            return state_like
        _, path = found[-1]
        payload = torch.load(path, map_location=self.device, weights_only=True)
        state_like.model.load_state_dict(payload["model"], strict=True)
        state_like.optimizer.load_state_dict(payload["optimizer"])
        return dataclasses.replace(state_like, step=int(payload["step"]))

    def put_batch(self, batch: dict) -> dict:
        """Copy a host (numpy) batch to the trainer's device; nested dicts
        (a dedup plan, ``batch["cat_dedup"]``) are copied entry by entry."""
        return {
            k: self.put_batch(v) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in batch.items()
        }


_CHECKPOINT_NAME = re.compile(r"step_(\d+)\.pt")


def _batch_size(batch: dict) -> int:
    """Rows of the batch: the leading dim of its first top-level array (a
    nested plan's arrays are per id, not per row)."""
    first = next((v for v in batch.values() if not isinstance(v, dict)), None)
    return int(first.shape[0]) if first is not None else 0
