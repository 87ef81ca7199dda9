"""Profiling and tracing hooks.

Port of ``recommender_tpu/core/profiling.py``:

* ``trace(log_dir)`` — a context manager around ``torch.profiler.profile``
  over the host's activity and, where a card is present, the card's (CUDA
  kernels and copies); on exit it writes a TensorBoard trace,
  ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir`` (open it in
  TensorBoard's profiler plugin, Perfetto or ``chrome://tracing``). It
  yields the profiler, whose ``key_averages()`` sum the time by op and by
  kernel;
* ``annotate(name)`` — ``torch.profiler.record_function``: a named span of
  host work (data loading, sampling) on the trace's timeline;
* ``StepTimer`` — wall-clock per-step timing with a warm-up skip and a
  percentile summary (host code, copied).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step wall times; ``summary()`` gives p50/p90/mean."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0 = None
        self._steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }
