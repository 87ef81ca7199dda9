"""What the benchmark reads of the cells it has does not move when families
declare their own layers: frozen copies of the reduction as it read the
port's shared layers alone (``_frozen_parse``, ``_frozen_layer``) and of
the alignment of the steps' direct children (``_frozen_align``), held
against ``trace.Trace.parse`` and ``program_spans.align`` on the hand
traces of ``test_portbench_trace`` and ``test_portbench_program_spans``
and on a traced tiny run of every cell (on the CPU; on the card where
one is found): every operation's layer, the benchmark's spans, every
per-layer reading, ``breakdown`` and ``Aligned`` are identical."""
import dataclasses
import json
import time

import pytest
import torch

from portbench import harness, manifest, program_spans, trace
from portbench.tests import test_portbench_program_spans as spans_test
from portbench.tests import test_portbench_trace as trace_test
from portbench.tests.tiny import cells, tiny_cell

WINDOW = "portbench.profiled"


def _frozen_layer(name, launched_at, optimizer_spans):
    base = trace.base_name(name)
    if base in ("chunk_sum_kernel", "join_kernel"):
        return "embedding.k1"
    if base.startswith(("flash_fwd_", "flash_bwd_")):
        return "attention.k2"
    if launched_at is not None:
        for a, b in optimizer_spans:
            if a > launched_at:
                break
            if launched_at <= b:
                return "optimizer"
    return "model"


def _frozen_parse(events, steps, window_span):
    launches, span_list, ops, window = {}, [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name", "").startswith("portbench."):
            if e["name"] == window_span:
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            else:
                span_list.append((e["name"], float(e["ts"]), float(e["dur"])))
    opt = sorted((ts, ts + dur) for name, ts, dur in span_list if name == "portbench.optimizer")
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        op = trace.Op(e.get("name", ""), e["cat"], float(e["ts"]), float(e["dur"]))
        if op.ts + op.dur <= window[0] or op.ts >= window[1]:
            continue
        if op.cat == "kernel":
            op.layer = _frozen_layer(op.name, launches.get(e.get("args", {}).get("correlation")),
                                     opt)
        ops.append(op)
    ops.sort(key=lambda o: o.ts)
    span_list.sort(key=lambda s: s[1])
    return trace.Trace(ops, span_list, window, steps)


def _frozen_align(tr, steps, records):
    roots = [x for x in records if x.name == "host.step" and x.parent is None][-steps:]
    if steps <= 0 or len(roots) != steps:
        return None
    origin = roots[0].start_ns
    kids = {root.id: [] for root in roots}
    for x in records:
        if x.parent in kids:
            kids[x.parent].append(x)

    def us(ns):
        return (ns - origin) / 1000.0

    outer = {name: [(ts, ts + dur) for n, ts, dur in tr.spans if n == "portbench." + name]
             for name in ("put_batch", "train_step", "optimizer")}
    if any(len(v) != steps for v in outer.values()):
        return None
    pairs = []
    for i, root in enumerate(roots):
        by_name = {}
        for x in kids[root.id]:
            by_name.setdefault(x.name, []).append(x)
        put, fwd, opt = (by_name.get(n) for n in ("host.put_batch", "model.forward",
                                                  "optimizer.step"))
        if not (put and fwd and opt) or len(put) != 1 or len(opt) != 1:
            return None
        pairs += [((us(put[0].start_ns), us(put[0].end_ns)), outer["put_batch"][i]),
                  ((us(fwd[0].start_ns), us(opt[0].end_ns)), outer["train_step"][i]),
                  ((us(opt[0].start_ns), us(opt[0].end_ns)), outer["optimizer"][i])]
    lo = max(o0 - i0 for (i0, _), (o0, _) in pairs)
    hi = min(o1 - i1 for (_, i1), (_, o1) in pairs)
    if lo > hi:
        return None
    mid = (lo + hi) / 2
    spans = sorted((program_spans.Span(x.name, us(x.start_ns) + mid, us(x.end_ns) + mid,
                                       dict(x.counts))
                    for root in roots for x in kids[root.id]), key=lambda s: s.start)
    return program_spans.Aligned(spans=spans, offsets=(lo, hi))


def _readings(cell, r, monkeypatch, align):
    """Every per-layer reading of ``cell`` on ``r``, with ``align`` in the
    program spans' place."""
    monkeypatch.setattr(program_spans, "align", align)
    return {m["name"]: manifest.metric_reader(m["name"])(r) for m in cell.per_layer}


def _same(cell, events, r, records, monkeypatch):
    """The frozen reduction and alignment against today's, on the same
    events and records; ``r`` holds today's trace."""
    new_align = program_spans.align
    old = _frozen_parse(events, r.steps, WINDOW)
    assert r.trace.ops == old.ops and r.trace.spans == old.spans
    assert r.trace.window == old.window and r.trace.breakdown() == old.breakdown()
    assert new_align(r.trace, r.steps, records) == _frozen_align(old, r.steps, records)
    new = _readings(cell, r, monkeypatch, new_align)
    was = _readings(cell, dataclasses.replace(r, trace=old), monkeypatch, _frozen_align)
    monkeypatch.setattr(program_spans, "align", new_align)
    assert new == was
    return new


@pytest.mark.parametrize("name", cells())
def test_the_hand_traces_read_as_before(name, monkeypatch):
    cell = tiny_cell(name)
    layers = getattr(cell.family, "LAYERS", ())
    batch = cell.generator.pool(cell.traffic, cell.config["model"], 1, 1)[0]
    records = spans_test._records()
    monkeypatch.setattr(program_spans, "port_records", lambda: records)
    for events, steps in ((trace_test.EVENTS, 1), (spans_test.EVENTS, 2)):
        tr = trace.Trace.parse(events, steps=steps, window_span=WINDOW, layers=layers)
        r = harness.Readings(trace=tr, steps=steps, batches=[batch] * steps,
                             model=cell.config["model"], traffic=cell.traffic, family=cell.family,
                             examples_per_s=1000.0)
        got = _same(cell, events, r, records, monkeypatch)
        assert any(v is not None for v in got.values())
    assert program_spans.align(tr, 2, records) is not None  # the second trace's steps align


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("name", cells())
def test_a_traced_run_reads_as_before(name, device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell(name)
    got = {}
    load = trace.Trace.load.__func__

    def capture(cls, path, *args):
        with open(path) as f:
            data = json.load(f)
        got["events"] = data["traceEvents"] if isinstance(data, dict) else data
        return load(cls, path, *args)

    made = harness.Readings

    def readings(**kwargs):
        got["readings"] = made(**kwargs)
        return got["readings"]

    monkeypatch.setattr(trace.Trace, "load", classmethod(capture))
    monkeypatch.setattr(harness, "Readings", readings)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = harness.run(cell, 2**40 + 3, 0.2, True, device, time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    r = got["readings"]
    records = program_spans.port_records()
    assert program_spans.align(r.trace, r.steps, records) is not None
    new = _same(cell, got["events"], r, records, monkeypatch)
    assert {k: v for k, v in new.items() if v is not None} \
        == {k: v["value"] for k, v in result["metrics"].items()}
    if device == "cuda":
        assert r.trace.kernels("optimizer") and r.trace.kernels("embedding.k1")
