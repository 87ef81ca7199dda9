"""One run of one cell: set-up, the measured window, the traced steps and
the check.

Set-up builds the port's kernels (timed apart as ``build_s``), the cell's
pool of host batches (``traffic_s``), the port's model with the
benchmark's weights, a ``Trainer`` and its state (``model_s``); it drives
that state through its first steps with ``Trainer.fit``, the window's own
call and feed, on the pool's first batches (three, all different), and
keeps the readings the check compares; then it warms up on the cell's own
batches (``warmup_s``). ``setup_s`` runs from the process's start to the
window's first step.

The window calls ``Trainer.fit`` once, with its ``Prefetcher``, on the
pool cycled until ``seconds`` have passed; each step goes ``put_batch`` →
``train_step`` (forward, backward, ``optimizer.step``) with no sync, and a
CUDA event is recorded after each ``train_step``. One
``torch.cuda.synchronize()`` ends it. ``train_examples_per_s`` is the
window's examples over its whole time, from the first step's start to that
sync; ``train_step_ms_p95`` the 95th percentile of all its steps' event
intervals. A metric named ``<quantity>.<group>`` (``train_examples_per_s.steady``)
reports the same quantity, in the cells its manifest entry lists, under a
bound of its own.

With ``trace``, ``torch.profiler`` then covers ``profile_steps`` more steps
(``portbench.trace``), and the cell's per-layer metrics are read from them.

The check runs once the window and the trace are over, the peak memory is
read and the port's state is freed: the reference (``portbench.reference``)
follows the same first steps from the same weights and batches, and
``portbench.check`` compares the readings.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, manifest, trace as tracing, weights
from portbench.families import flops_per_example
from portbench.reference import train as ref_train

CHECK_STEPS = 3
NEVER = 1 << 62  # a log cadence the steps never reach: no host sync in the loop


@dataclasses.dataclass(frozen=True)
class Seeds:
    data: int
    weights: int
    rounding: int


def seeds(seed: int) -> Seeds:
    words = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(3)
    return Seeds(*(int(w) for w in words))


class Clock:
    """Marks after steps: CUDA events on the card, the host clock on the
    CPU (the tests' runs)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        """Between consecutive marks; after a sync."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


class Stepper:
    """Stands in for ``trainer.train_step`` (an instance attribute): the
    step itself, then a clock mark; keeps the loss tensors while
    ``keep`` and the last one always."""

    def __init__(self, trainer, clock: Clock):
        self.step = trainer.train_step
        self.clock = clock
        self.keep = False
        self.losses: list = []
        self.last = None
        trainer.train_step = self

    def __call__(self, state, batch):
        state, metrics = self.step(state, batch)
        self.clock.mark()
        self.last = metrics["loss"]
        if self.keep:
            self.losses.append(self.last)
        return state, metrics


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cycle(pool: list, start: int, deadline: float | None = None):
    """The pool's batches from ``start`` on, round and round; until the
    host clock passes ``deadline``, where one is given."""
    i = start
    while deadline is None or time.perf_counter() < deadline:
        yield pool[i % len(pool)]
        i += 1


@torch.no_grad()
def _norm(x: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    x = x.to(torch.float32)
    return float(torch.linalg.vector_norm(x if minus is None else x - minus.to(torch.float32)))


class Program:
    """The system under test: the port's model with the benchmark's
    weights, its ``Trainer`` and state. ``plant`` (the tests' and the
    calibration's faults, never a benchmark run) may alter it once built."""

    def __init__(self, cell, device: torch.device, s: Seeds, plant=None):
        from recommender_tpu_torch.core.train import TrainConfig, Trainer

        cfg = cell.config
        self.device = device
        self.layers = getattr(cell.family, "LAYERS", ())
        self.model, loss_fn = cell.family.build(cfg["model"], device)
        self.initial = weights.make(cell.family.leaves(cfg["model"]), s.weights, device)
        weights.load(self.model, self.initial)
        train = cfg["train"]
        tcfg = TrainConfig(learning_rate=train["learning_rate"], optimizer=train["optimizer"],
                           stochastic_round=train["stochastic_round"], seed=s.rounding,
                           log_every=NEVER, eval_every=0)
        self.trainer = Trainer(loss_fn, tcfg, device=device)
        self.state = self.trainer.init_state(lambda: self.model)
        self.clock = Clock(device)
        self.stepper = Stepper(self.trainer, self.clock)
        if plant is not None:
            plant(self)

    def fit(self, batches, steps: int):
        self.state, _ = self.trainer.fit(self.state, batches, steps=steps)

    def first_steps(self, batches: list) -> ref_train.Readings:
        """The check's steps, through ``fit``: the losses, each
        parameter's first gradient from the optimizer's state after one
        step (Adam's first moment over 1 - b1; SGD's state is the
        parameters, their change over the learning rate), and each
        parameter's change after all of them."""
        self.stepper.keep = True
        self.fit(iter(batches[:1]), 1)
        opt = self.state.optimizer
        group = opt.param_groups[0]
        names = {id(p): n for n, p in self.model.named_parameters()}
        if "mu" in opt.slots:
            first = {names[id(p)]: _norm(m) / (1.0 - group["b1"])
                     for p, m in zip(group["params"], opt.state_dict()["mu"])}
        else:
            first = {names[id(p)]: _norm(p, self.initial[names[id(p)]]) / group["lr"]
                     for p in group["params"]}
        self.fit(iter(batches[1:]), len(batches) - 1)
        change = {n: _norm(p, self.initial[n]) for n, p in self.model.named_parameters()}
        losses = [float(x) for x in self.stepper.losses]
        self.stepper.keep, self.stepper.losses = False, []
        del self.initial
        return ref_train.Readings(loss=losses, grad=first, change=change)

    def window(self, pool: list, start: int, seconds: float) -> dict:
        """Steps of the pool from ``start`` for ``seconds``: their count,
        the window's seconds and every step's interval in ms."""
        sync(self.device)
        self.clock.marks = []
        t0 = time.perf_counter()
        self.clock.mark()
        before = self.state.step
        self.fit(cycle(pool, start, t0 + seconds), NEVER)
        sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"steps": self.state.step - before, "seconds": elapsed,
                "intervals_ms": self.clock.intervals_ms()}

    def profile(self, batches: list, tmpdir: Path) -> tracing.Trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        sync(self.device)
        window_span = tracing.SPAN_PREFIX + "profiled"
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with tracing.spans(self.trainer, self.state.optimizer):
            with profile(activities=activities) as prof:
                with record_function(window_span):
                    self.fit(iter(batches), len(batches))
                    sync(self.device)
        tmpdir.mkdir(parents=True, exist_ok=True)
        path = tmpdir / "trace.json"
        try:
            prof.export_chrome_trace(str(path))
            return tracing.Trace.load(path, len(batches), window_span, self.layers)
        finally:
            path.unlink(missing_ok=True)


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads."""
    trace: tracing.Trace
    steps: int
    batches: list          # the traced steps' host batches
    model: dict            # the configuration's model arguments
    traffic: dict
    family: object
    examples_per_s: float  # of the window before the trace

    def flops_per_example(self) -> dict:
        return flops_per_example(self.family, self.model, self.batches)


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        plant=None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, and ``breakdown`` with
    ``trace``), with ``setup_parts`` and ``check``."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
    s = seeds(seed)
    parts = {}
    t = time.perf_counter()
    if device.type == "cuda":
        from recommender_tpu_torch.ops import _build

        torch.zeros(1, device=device)
        sync(device)
        parts["device_init_s"], t = time.perf_counter() - t, time.perf_counter()
        for name in cell.family.KERNELS:
            _build.load(name)
    parts["build_s"], t = time.perf_counter() - t, time.perf_counter()
    pool = cell.generator.pool(traffic, cfg["model"], s.data)
    if len(pool) <= CHECK_STEPS:
        raise ValueError(f"a pool of {len(pool)} batches; the check needs {CHECK_STEPS + 1}")
    parts["traffic_s"], t = time.perf_counter() - t, time.perf_counter()
    prog = Program(cell, device, s, plant)
    parts["model_s"], t = time.perf_counter() - t, time.perf_counter()
    got = prog.first_steps(pool[:CHECK_STEPS])
    prog.fit(cycle(pool, CHECK_STEPS), traffic["warmup_steps"])
    sync(device)
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process

    start = CHECK_STEPS + traffic["warmup_steps"]
    win = prog.window(pool, start, seconds)
    batch = traffic["batch"]
    rate = win["steps"] * batch / win["seconds"]
    e2e = {"train_examples_per_s": rate,
           "train_step_ms_p95": float(np.percentile(win["intervals_ms"], 95)),
           "setup_s": setup_s}
    result = {"attempted": win["steps"]}
    dev = {}
    if trace:
        n = traffic["profile_steps"]
        traced = [pool[(start + win["steps"] + i) % len(pool)] for i in range(n)]
        tmpdir = Path(tempfile.gettempdir()) / "portbench"
        tr = prog.profile(traced, tmpdir)
        r = Readings(trace=tr, steps=n, batches=traced, model=cfg["model"], traffic=traffic,
                     family=cell.family, examples_per_s=rate)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = tr.breakdown()
    else:
        # "<quantity>.<group>" is the quantity under a bound of its own, for
        # the cells that the manifest entry lists
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    last_loss = float(prog.stepper.last)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)), **dev}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, **dev}

    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = reference_readings(cell, s, pool[:CHECK_STEPS], device)
    parts["check_s"] = time.perf_counter() - t
    correct, shown = check.judge(check.numbers(got, want), cell.limits)
    # a window that diverged failed its steps, whatever its first steps read
    finite = math.isfinite(last_loss)
    result.update(correct=bool(correct and finite), failed=0 if finite else win["steps"],
                  metrics=metrics, device=dev, setup_parts=parts, check=shown)
    return result


def reference_readings(cell, s: Seeds, host_batches: list, device,
                       precision="stated") -> ref_train.Readings:
    """The reference's readings of the first steps, from the benchmark's
    weights drawn again and the same batches."""
    model = cell.config["model"]
    initial = weights.make(cell.family.leaves(model), s.weights, device)
    batches = [{k: torch.as_tensor(np.asarray(v)).to(device) for k, v in b.items()}
               for b in host_batches]
    return ref_train.follow(cell.reference, initial, batches, model, cell.config["train"],
                            s.rounding, precision=precision)
