"""The traced steps: spans opened from the benchmark's own files, a
``torch.profiler`` trace of the card, and its reduction.

``spans`` wraps the bound methods of the Trainer and optimizer objects the
harness made, each call in a ``record_function`` span: ``portbench.put_batch``
(the copy of a batch to the card), ``portbench.train_step`` (forward,
backward and optimizer) and, inside it, ``portbench.optimizer``. The
program is not edited.

``Trace.parse`` reads the profiler's Chrome trace: device operations
(``kernel``, ``gpu_memcpy``, ``gpu_memset``), the host's launch calls
(their ``correlation`` ties a kernel to the host span that launched it),
the benchmark's spans and, in a list of their own, the port's
(``core.profiling.annotate``: ``host.*``, ``model.*``, ``optimizer.*``).
Each kernel gets a layer (``Layer``): first by its name, ``embedding.k1``
and ``attention.k2`` for the port's shared kernels (``SHARED_LAYERS``),
then the family's own layers that name kernels; then by the innermost span
its launch was made in, ``optimizer`` for ``portbench.optimizer`` and a
family's layer for the port span it names; else ``model``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re

SPAN_PREFIX = "portbench."
# the port's own spans (core.profiling.annotate), by their names' first word
PORT_PREFIXES = ("host.", "model.", "optimizer.")
# the port's hand-written kernels, by the function name the trace gives them
K1_NAMES = ("chunk_sum_kernel", "join_kernel")  # ops/csrc/sorted_scatter_add.cu
K2_PREFIXES = ("flash_fwd_", "flash_bwd_")  # ops/csrc/flash_attention*.cu
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ANON = "(anonymous namespace)::"
_BASE = re.compile(r"^[A-Za-z_][\w:]*")


@dataclasses.dataclass(frozen=True)
class Layer:
    """A layer of the step: the kernels whose base name (``base_name``) is
    one of ``kernels`` or starts with one of ``prefixes``, and the kernels
    launched inside a port span named ``span``.

    A span claims a kernel by its launch's time alone, on whatever thread
    either was recorded. On CUDA, autograd launches the backward's kernels
    from a thread of its own while ``model.backward`` is open on the
    caller's, so a span opened around a forward computation claims its
    forward kernels only; its backward's land in ``model`` unless the port
    opens the span inside that backward too (it then lies on autograd's
    thread) or the layer names those kernels."""
    name: str
    kernels: tuple = ()
    prefixes: tuple = ()
    span: str | None = None


SHARED_LAYERS = (Layer("embedding.k1", kernels=K1_NAMES),
                 Layer("attention.k2", prefixes=K2_PREFIXES))


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameters (template arguments kept)."""
    name = name.replace(_ANON, "").strip()
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()


def base_name(name: str) -> str:
    """A kernel's qualified function name without anonymous namespaces,
    template arguments or parameters: ``void (anonymous
    namespace)::chunk_sum_kernel<float>(...)`` is ``chunk_sum_kernel``,
    ``void at::native::(anonymous namespace)::f<4>(int)`` is
    ``at::native::f``."""
    m = _BASE.match(short_name(name))
    return m.group(0) if m else name


@contextlib.contextmanager
def spans(trainer, optimizer):
    """Wrap ``trainer.put_batch``, ``trainer.train_step`` and
    ``optimizer.step`` in ``record_function`` spans (as instance
    attributes, which shadow the bound methods); restored on exit."""
    import torch

    def wrapped(fn, name):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    saved = []
    for obj, attr, name in ((trainer, "put_batch", "put_batch"),
                            (trainer, "train_step", "train_step"),
                            (optimizer, "step", "optimizer")):
        saved.append((obj, attr, attr in vars(obj), getattr(obj, attr)))
        setattr(obj, attr, wrapped(getattr(obj, attr), SPAN_PREFIX + name))
    try:
        yield
    finally:
        for obj, attr, had, fn in reversed(saved):
            if had:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    ts: float  # microseconds, the trace's clock
    dur: float
    layer: str = "copy"


@dataclasses.dataclass
class Trace:
    ops: list            # device operations in the window, by start
    spans: list          # (name, ts, dur) of the benchmark's host spans
    window: tuple        # (start, end) in microseconds
    steps: int
    port_spans: list = dataclasses.field(default_factory=list)  # (name, ts, dur), the port's

    @classmethod
    def parse(cls, events: list, steps: int, window_span: str, layers: tuple = ()) -> "Trace":
        """``layers``: the family's own (``Layer``), beside ``SHARED_LAYERS``."""
        launches, span_list, port_list, ops, window = {}, [], [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in ("cuda_runtime", "cuda_driver") and "Launch" in name:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(e["ts"])
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                if name == window_span:
                    window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                else:
                    span_list.append((name, float(e["ts"]), float(e["dur"])))
            elif cat == "user_annotation" and name.startswith(PORT_PREFIXES):
                port_list.append((name, float(e["ts"]), float(e["dur"])))
        if window is None:
            raise ValueError(f"the trace has no {window_span} span")
        by_name = SHARED_LAYERS + tuple(layers)
        by_span = [("optimizer", ts, ts + dur) for name, ts, dur in span_list
                   if name == SPAN_PREFIX + "optimizer"]
        for x in layers:
            if x.span is not None:
                by_span += [(x.name, ts, ts + dur) for name, ts, dur in port_list if name == x.span]
        by_span.sort(key=lambda t: (t[1], -t[2]))  # of two that start together, the outer first
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            op = Op(e.get("name", ""), e["cat"], float(e["ts"]), float(e["dur"]))
            if op.ts + op.dur <= window[0] or op.ts >= window[1]:
                continue
            if op.cat == "kernel":
                launched_at = launches.get(e.get("args", {}).get("correlation"))
                op.layer = _layer(op.name, launched_at, by_name, by_span)
            ops.append(op)
        ops.sort(key=lambda o: o.ts)
        span_list.sort(key=lambda s: s[1])
        port_list.sort(key=lambda s: s[1])
        return cls(ops, span_list, window, steps, port_list)

    @classmethod
    def load(cls, path, steps: int, window_span: str, layers: tuple = ()) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls.parse(events, steps, window_span, layers)

    # ------------------------------------------------------------ readings
    def kernels(self, layer: str | None = None) -> list:
        return [o for o in self.ops if o.cat == "kernel" and (layer is None or o.layer == layer)]

    def seconds(self, layer: str | None = None) -> float:
        """Summed device time of the kernels of ``layer`` (all where None)."""
        return sum(o.dur for o in self.kernels(layer)) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        out = []
        for o in self.ops:
            a, b = max(o.ts, lo), min(o.ts + o.dur, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def idle_gaps(self) -> list:
        """(start, end) of the window's stretches with no device operation."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at time ``t``."""
        best = None
        for name, ts, dur in self.spans:
            if ts > t:
                break
            if t < ts + dur and (best is None or ts >= best[1]):
                best = (name, ts)
        return best[0][len(SPAN_PREFIX):] if best else "outside_steps"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by layer and name,
        and the longest idle gaps, by what the host was doing."""
        by_name: dict = {}
        for o in self.ops:
            key = f"{o.layer}/{short_name(o.name)[:96]}"
            by_name[key] = by_name.get(key, 0.0) + o.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), (b - a) * 1e-6] for a, b in gaps]}


def _layer(name: str, launched_at, by_name: tuple, by_span: list) -> str:
    """The first layer of ``by_name`` that names the kernel; else the
    innermost ``(layer, start, end)`` of ``by_span`` (sorted by start) open
    at its launch; else ``model``."""
    base = base_name(name)
    for layer in by_name:
        if base in layer.kernels or base.startswith(layer.prefixes):
            return layer.name
    inner = None
    if launched_at is not None:
        for layer, a, b in by_span:
            if a > launched_at:
                break
            if launched_at <= b:
                inner = layer
    return inner or "model"
