"""Profiling and tracing hooks.

Port of ``recommender_tpu/core/profiling.py``:

* ``trace(log_dir)`` — a context manager around ``torch.profiler.profile``
  over the host's activity and, where a card is present, the card's (CUDA
  kernels and copies); on exit it writes a TensorBoard trace,
  ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir`` (open it in
  TensorBoard's profiler plugin, Perfetto or ``chrome://tracing``). It
  yields the profiler, whose ``key_averages()`` sum the time by op and by
  kernel. It empties the span buffer on entry;
* ``annotate(name, **counts)`` — a named span of host work. While a
  ``torch.profiler`` records (whoever started it: ``trace`` or any other
  caller), the span enters ``torch.profiler.record_function(name)``, so it
  shows on the trace's timeline, and on exit appends a ``SpanRecord`` to a
  bounded in-memory buffer: name, start and end in ``time.time_ns()``, the
  thread, the enclosing span on the same thread, and integer counts (given
  at entry, or added by ``span.add`` before exit; ``span.live`` says
  whether anything is recorded, so a caller computes a count only then).
  ``spans()`` returns the buffer's records, by start. A record reaches the
  buffer when the outermost span of its thread exits, together with its
  descendants; ``span.drop()`` discards an open span and its descendants.
  With no profiler recording, ``annotate`` returns one shared no-op
  context: 0.15 µs a span on a CPU host against 3.6 µs for a bare
  ``record_function`` (torch 2.13, 200k empty spans), 0.30–0.52 µs on an
  H100 machine's host (torch 2.11);
* ``StepTimer`` — wall-clock per-step timing with a warm-up skip and a
  percentile summary (host code, copied).

The buffer's clock is ``time.time_ns()``, the Unix clock onto which the
profiler (Kineto) maps its host events and the card's timestamps: an
event's exported ``ts`` (µs) plus the trace file's ``baseTimeNanoseconds``
/ 1000 is on the same clock as ``SpanRecord.start_ns`` / 1000, up to the
time between the two readings.

The training loop's spans (``core.train``, ``core.optim``): ``host.step``
around each step, with the children ``host.input_wait`` (count
``queued``: batches waiting in the prefetch queue), ``host.put_batch``
(``bytes``: the leaves copied to the device; on a CUDA device also
``pageable_bytes``: those that reached it outside page-locked memory),
``model.forward`` and ``model.backward`` (per microbatch) and
``optimizer.step``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

BUFFER_RECORDS = 1 << 16  # the oldest records go first beyond this


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    id: int
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    thread: int  # threading.get_ident()
    parent: int | None  # id of the enclosing span on the same thread
    counts: dict


_buffer: collections.deque = collections.deque(maxlen=BUFFER_RECORDS)
_buffer_lock = threading.Lock()
_ids = itertools.count()
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _Span:
    live = True

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = {k: int(v) for k, v in counts.items()}
        self.id = next(_ids)
        self._done: list = []  # records of descendants that exited
        self._dropped = False

    def add(self, **counts):
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    def drop(self):
        """Record neither this span nor its descendants."""
        self._dropped = True

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self)
        self._mark = torch.profiler.record_function(self.name)
        self._mark.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._mark.__exit__(*exc)
        _open.stack.pop()
        if self._dropped:
            return False
        parent = self._parent
        self._done.append(SpanRecord(self.id, self.name, self._start, end,
                                     threading.get_ident(),
                                     None if parent is None else parent.id, self.counts))
        if parent is not None:
            parent._done.extend(self._done)
        else:
            with _buffer_lock:
                _buffer.extend(self._done)
        return False


class _Off:
    """The span while no profiler records: nothing entered, nothing kept."""

    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass

    def drop(self):
        pass


_OFF = _Off()


def annotate(name: str, **counts):
    """A span named ``name`` with integer ``counts``: recorded while a
    profiler records, else the shared no-op (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts)


def spans() -> list:
    """The buffer's ``SpanRecord``s, by start."""
    with _buffer_lock:
        records = list(_buffer)
    return sorted(records, key=lambda r: (r.start_ns, r.id))


def clear_spans():
    """Empty the span buffer."""
    with _buffer_lock:
        _buffer.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    clear_spans()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


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
