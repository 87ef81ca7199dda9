"""``core.profiling.annotate``'s spans and the training loop's, on the CPU.

* With no profiler recording, ``annotate`` returns one shared no-op,
  enters no ``record_function`` and records nothing, through a whole
  ``Trainer.fit``.
* Under ``profiling.trace``, a 3-step fit of a small DLRM records, for
  each step, one ``host.step`` whose children are ``host.input_wait``,
  ``host.put_batch``, ``model.forward``, ``model.backward`` and
  ``optimizer.step`` in that order, each inside its parent; with
  ``accum_steps`` 2, one forward and one backward a microbatch.
  ``put_batch``'s one count, its bytes, is the batch's ``nbytes``.
* The exported trace file names every span, and each record's start, on
  ``time.time_ns()``, less the file's ``baseTimeNanoseconds``, falls
  within ``CLOCK_TOL_US`` after the span's exported ``ts``, and its end as
  far before the exported end: the record's clock is read just inside the
  profiler's (on a CPU host, torch 2.13: 1.5–68 µs, the first span of a
  process ~0.5 ms).
* The fit loop takes no batch past its last step, and the fetch that
  finds the stream's end is no step's.
* The buffer takes records from many threads at once.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from recommender_tpu_torch.core import profiling
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticCTR, batch_iterator
from recommender_tpu_torch.models import DLRM, make_ctr_task

SMALL = dict(embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
VOCAB, BATCH, STEPS = 500, 64, 3
CHILDREN = ["host.input_wait", "host.put_batch", "model.forward", "model.backward",
            "optimizer.step"]
SPAN_NAMES = {"host.step", *CHILDREN}
# a record's start after its exported start, and its end before the exported
# end, in µs: the profiler reads its clock outside the record's readings
CLOCK_TOL_US = (-50.0, 5000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _batches(n=STEPS):
    data = SyntheticCTR(vocab_size=VOCAB, seed=0).sample(n * BATCH, 1)
    return list(batch_iterator(data, BATCH, seed=0))


def _trainer(**cfg):
    torch.manual_seed(0)
    model = DLRM(VOCAB, **SMALL)
    loss_fn, _ = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=1e-2, log_every=1 << 30,
                                           eval_every=0, **cfg), device="cpu")
    return trainer, trainer.init_state(lambda: model)


def _children(records, parent):
    return [r for r in records if r.parent == parent.id]


def test_annotate_without_a_profiler_is_one_shared_no_op(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    a, b = profiling.annotate("a"), profiling.annotate("b", bytes=3)
    assert a is b and not a.live
    with a as span:
        span.add(bytes=1)
        span.drop()
    trainer, state = _trainer()
    state, _ = trainer.fit(state, iter(_batches()), STEPS)
    assert state.step == STEPS
    assert entered == [] and profiling.spans() == []


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_records_a_step_span_with_its_children(tmp_path, prefetch):
    trainer, state = _trainer()
    batches = _batches()
    with profiling.trace(str(tmp_path)):
        state, _ = trainer.fit(state, iter(batches), STEPS, prefetch=prefetch)
    records = profiling.spans()
    steps = [r for r in records if r.name == "host.step"]
    assert len(steps) == STEPS and len(records) == STEPS * (1 + len(CHILDREN))
    assert len({r.id for r in records}) == len(records)
    for step, batch in zip(steps, batches):
        assert step.parent is None
        kids = _children(records, step)
        assert [k.name for k in kids] == CHILDREN
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        for k in kids:
            assert step.start_ns <= k.start_ns <= k.end_ns <= step.end_ns
            assert k.thread == step.thread == threading.get_ident()
        wait, put, _, _, opt = kids
        assert ("queued" in wait.counts) == bool(prefetch)
        nbytes = sum(np.asarray(v).nbytes for v in batch.values())
        assert put.counts == {"bytes": nbytes}
        assert opt.counts == {}
    assert all(_children(records, r) == [] for r in records if r.name != "host.step")


def test_accumulation_records_a_forward_and_backward_a_microbatch(tmp_path):
    trainer, state = _trainer(accum_steps=2)
    with profiling.trace(str(tmp_path)):
        trainer.fit(state, iter(_batches()), STEPS)
    records = profiling.spans()
    steps = [r for r in records if r.name == "host.step"]
    assert len(steps) == STEPS
    for step in steps:
        assert [k.name for k in _children(records, step)] == [
            "host.input_wait", "host.put_batch", "model.forward", "model.backward",
            "model.forward", "model.backward", "optimizer.step"]


def test_trace_file_names_every_span_on_the_records_clock(tmp_path):
    trainer, state = _trainer()
    with profiling.trace(str(tmp_path)):
        trainer.fit(state, iter(_batches()), STEPS)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        data = json.load(f)
    base_us = data.get("baseTimeNanoseconds", 0) / 1000
    events = sorted((e for e in data["traceEvents"]
                     if e.get("ph") == "X" and e.get("name") in SPAN_NAMES),
                    key=lambda e: e["ts"])
    assert {e["name"] for e in events} == SPAN_NAMES
    records = profiling.spans()
    for span_name in SPAN_NAMES:
        exported = [e for e in events if e["name"] == span_name]
        mine = [r for r in records if r.name == span_name]
        assert len(exported) == len(mine) > 0
        for e, r in zip(exported, mine):
            after = r.start_ns / 1000 - (e["ts"] + base_us)
            before = (e["ts"] + e["dur"] + base_us) - r.end_ns / 1000
            assert CLOCK_TOL_US[0] <= after <= CLOCK_TOL_US[1], (span_name, after)
            assert CLOCK_TOL_US[0] <= before <= CLOCK_TOL_US[1], (span_name, before)


class _Counted:
    def __init__(self, batches):
        self.batches, self.taken = batches, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.taken == len(self.batches):
            raise StopIteration
        self.taken += 1
        return self.batches[self.taken - 1]


def test_fit_takes_no_batch_past_its_last_step():
    trainer, state = _trainer()
    stream = _Counted(_batches(5))
    state, _ = trainer.fit(state, stream, 3, prefetch=0)
    assert stream.taken == 3 and state.step == 3
    state, _ = trainer.fit(state, stream, 2, prefetch=0)
    assert stream.taken == 5 and state.step == 5


def test_the_fetch_that_ends_the_stream_is_no_steps(tmp_path):
    trainer, state = _trainer()
    with profiling.trace(str(tmp_path)):
        state, _ = trainer.fit(state, iter(_batches(2)), 5, prefetch=0)
    assert state.step == 2
    names = [r.name for r in profiling.spans()]
    assert names.count("host.step") == 2 and names.count("host.input_wait") == 2


def test_a_dropped_span_takes_its_descendants_along(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("kept", n=1) as kept:
            with profiling.annotate("gone") as gone:
                with profiling.annotate("inner"):
                    pass
                gone.drop()
            kept.add(n=2)
    (rec,) = profiling.spans()
    assert rec.name == "kept" and rec.counts == {"n": 3} and rec.parent is None


def test_the_buffer_takes_spans_from_many_threads(tmp_path):
    threads, per_thread = 16, 200
    errors, done = [], []
    together = threading.Barrier(threads)  # all alive at once: no thread id reused

    def work():
        try:
            together.wait(timeout=60)
            for i in range(per_thread):
                with profiling.annotate("outer", i=i):
                    with profiling.annotate("inner"):
                        pass
            done.append(threading.get_ident())
        except BaseException as e:  # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.trace(str(tmp_path)):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert errors == [] and len(done) == threads
    records = profiling.spans()
    assert len(records) == 2 * threads * per_thread
    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        if r.name == "inner":
            parent = by_id[r.parent]
            assert parent.name == "outer" and parent.thread == r.thread
        else:
            assert r.parent is None
    for tid in done:
        mine = sorted(r.counts["i"] for r in records if r.thread == tid and r.name == "outer")
        assert mine == list(range(per_thread))
