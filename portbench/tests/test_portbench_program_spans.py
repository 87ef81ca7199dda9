"""The port's own spans read on a trace written by hand (two steps, the
program's clock 5 s and a few µs off the trace's): the alignment's offset
interval, each new metric's value, ``device.idle_on_input_share`` read
at both ends of the interval, and nothing where no single offset nests
the spans, the counts differ or the port keeps no spans. Then a
traced run of each tiny cell on the CPU reports every new metric, the
copy's bytes those of the cell's batches."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, manifest, program_spans, trace
from portbench.tests.tiny import cells, tiny_cell
from recommender_tpu_torch.core.profiling import SpanRecord

NEW = ("host.input_wait_ms_per_step", "host.put_batch_ms_per_step", "host.h2d_mb_per_step",
       "model.host_ms_per_step", "optimizer.host_ms_per_step", "device.idle_on_input_share")
BYTES = 8192 * 160  # a b8192 DLRM batch: 26 int32 ids, 13 f32 features, an f32 label a row
SHIFT_US = 5_000_000 + 1_790_000_000_000_000  # program clock minus trace clock


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


EVENTS = [
    _x("user_annotation", "portbench.profiled", -100, 2100),
    _x("user_annotation", "portbench.put_batch", 0, 100),
    _x("user_annotation", "portbench.train_step", 100, 800),
    _x("user_annotation", "portbench.optimizer", 600, 250),
    _x("user_annotation", "portbench.put_batch", 1000, 100),
    _x("user_annotation", "portbench.train_step", 1100, 800),
    _x("user_annotation", "portbench.optimizer", 1600, 250),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 40),
    _x("kernel", "k", 200, 300), _x("kernel", "k", 700, 100),
    _x("kernel", "k", 1040, 20), _x("kernel", "k", 1150, 650),
]

# (name, start, end) in the trace's µs, before the program's clock shift
STEPS = [
    [("host.input_wait", -20, -2), ("host.put_batch", 3, 97), ("model.forward", 105, 300),
     ("model.backward", 300, 590), ("optimizer.step", 605, 840)],
    [("host.input_wait", 985, 1002), ("host.put_batch", 1004, 1098),
     ("model.forward", 1102, 1300), ("model.backward", 1300, 1590),
     ("optimizer.step", 1602, 1849)],
]
# each pair's feasible offsets (outer start - inner start, outer end - inner
# end): put [-3, 3], [-4, 2]; train_step [-5, 60], [-2, 51]; optimizer
# [-5, 10], [-2, 1]: together [-2, 1]
OFFSETS = (-2, 1)


def _records(steps=STEPS):
    out, ids = [], iter(range(1000))

    def ns(us):
        return (SHIFT_US + us) * 1000

    for spans in steps:
        root = next(ids)
        start, end = spans[0][1], spans[-1][2] + 5
        out.append(SpanRecord(root, "host.step", ns(start), ns(end), 1, None, {}))
        for name, a, b in spans:
            counts = {"bytes": BYTES} if name == "host.put_batch" else {}
            out.append(SpanRecord(next(ids), name, ns(a), ns(b), 1, root, counts))
    return sorted(out, key=lambda r: r.start_ns)


def _readings(events=EVENTS, steps=2):
    cell = tiny_cell("dlrm_kaggle.b65536")
    tr = trace.Trace.parse(events, steps=steps, window_span="portbench.profiled")
    return harness.Readings(trace=tr, steps=steps, batches=[], model=cell.config["model"],
                            traffic=cell.traffic, family=cell.family, examples_per_s=1.0)


def test_alignment_finds_the_offsets_that_nest_every_span():
    r = _readings()
    a = program_spans.align(r.trace, 2, _records())
    # offsets count from the first step's start (-20 on the trace's clock)
    origin = STEPS[0][0][1]
    assert a.offsets == pytest.approx((OFFSETS[0] + origin, OFFSETS[1] + origin))
    assert a.width_us == pytest.approx(3.0)
    mid = sum(OFFSETS) / 2
    put = a.of("host.put_batch")
    assert [(s.start, s.end) for s in put] == [pytest.approx((3 + mid, 97 + mid)),
                                               pytest.approx((1004 + mid, 1098 + mid))]
    assert [s.name for s in a.spans][:5] == [n for n, _, _ in STEPS[0]]


def test_each_new_metric_on_the_hand_trace(monkeypatch):
    monkeypatch.setattr(program_spans, "port_records", _records)
    r = _readings()
    got = {name: manifest.metric_reader(name)(r) for name in NEW}
    assert got["host.input_wait_ms_per_step"] == pytest.approx((18 + 17) / 2 * 1e-3)
    assert got["host.put_batch_ms_per_step"] == pytest.approx(94e-3)
    assert got["host.h2d_mb_per_step"] == pytest.approx(1.31072)
    assert got["model.host_ms_per_step"] == pytest.approx((195 + 290 + 198 + 290) / 2 * 1e-3)
    assert got["optimizer.host_ms_per_step"] == pytest.approx((235 + 247) / 2 * 1e-3)
    # idle gaps [-100, 50), [90, 200), [500, 700), [800, 1040), [1060, 1150),
    # [1800, 2000); the input spans moved by o in [-2, 1]: 18 + (47 - o +
    # 7 + o) + 17 + (36 - o + 38 + o) µs idle of the 2,100 µs window at both ends
    assert got["device.idle_on_input_share"] == pytest.approx(100 * 163 / 2100)
    assert got["device.idle_on_input_share"] <= manifest.metric_reader("device.idle_share")(r)


# a put_batch at [100, 200] on a card busy over [0, 150) of a [0, 1000)
# window, its offset known to ±half: 50 ± half µs idle
@pytest.mark.parametrize("half, share", [(0.0, 5.0), (10.0, 5.0), (12.5, 5.0), (12.6, None),
                                         (20.0, None)])
def test_idle_on_input_is_read_at_both_ends_of_the_offsets(monkeypatch, half, share):
    events = [_x("user_annotation", "portbench.profiled", 0, 1000), _x("kernel", "k", 0, 150)]
    r = _readings(events, steps=1)
    aligned = program_spans.Aligned(
        spans=[program_spans.Span("host.put_batch", 100.0, 200.0, {})],
        offsets=(-half, half))
    monkeypatch.setattr(program_spans, "of_run", lambda _: aligned)
    got = manifest.metric_reader("device.idle_on_input_share")(r)
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_where_no_single_offset_nests_the_spans(monkeypatch):
    late = [list(s) for s in STEPS]
    late[1][1] = ("host.put_batch", 1010, 1104)  # needs [-10, -4]; step 1's needs [-3, 3]
    assert program_spans.align(_readings().trace, 2, _records(late)) is None
    monkeypatch.setattr(program_spans, "port_records", lambda: _records(late))
    assert all(manifest.metric_reader(name)(_readings()) is None for name in NEW)


def test_nothing_where_the_counts_differ_or_the_port_keeps_no_spans(monkeypatch):
    r = _readings()
    assert program_spans.align(r.trace, 3, _records()) is None
    assert program_spans.align(r.trace, 2, _records(STEPS[:1])) is None
    for records in (None, []):
        monkeypatch.setattr(program_spans, "port_records", lambda records=records: records)
        assert all(manifest.metric_reader(name)(r) is None for name in NEW)


@pytest.mark.parametrize("name", cells())
def test_a_traced_run_on_the_cpu_reports_every_new_metric(name):
    cell = tiny_cell(name)
    seed = 2 ** 40 + 7
    pool = cell.generator.pool(cell.traffic, cell.config["model"], harness.seeds(seed).data)
    (nbytes,) = {sum(np.asarray(v).nbytes for v in b.values()) for b in pool}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = harness.run(cell, seed, 0.2, True, "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(metrics)
    assert metrics["host.h2d_mb_per_step"] == pytest.approx(nbytes / 1e6)
    assert 0 <= metrics["device.idle_on_input_share"] <= metrics["device.idle_share"]
    assert all(metrics[m] > 0 for m in NEW if m != "host.input_wait_ms_per_step")
