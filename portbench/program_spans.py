"""The port's own spans of the traced steps, on the trace's clock.

The port records its training loop's spans in memory
(``recommender_tpu_torch.core.profiling.spans()``: ``host.step`` and its
children ``host.input_wait``, ``host.put_batch``, ``model.forward``,
``model.backward``, ``optimizer.step``, and whatever the port opens inside
them, such as a family's ``model.recurrence``), on ``time.time_ns()``. The trace
(``portbench.trace``) is on the profiler's clock, whose exported ``ts``
may count from another base. ``align`` finds the offsets that put each
traced step's program spans inside the benchmark's own spans around the
same calls: its ``host.put_batch`` inside ``portbench.put_batch``, its run
from the first ``model.forward`` to the end of ``optimizer.step`` inside
``portbench.train_step``, its ``optimizer.step`` inside
``portbench.optimizer``, the i-th step's against the i-th span of each.
The offsets that nest them all form an interval; its width is the least
time the benchmark's wrappers add around a call. No offset at all means
the two clocks disagree, or the spans are not of the same steps: nothing
is read.

A program without the buffer (``spans``) gives nothing to read, and the
metrics that read it are not reported.
"""
from __future__ import annotations

import dataclasses

from portbench.trace import SPAN_PREFIX

STEP = "host.step"


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float  # µs, the trace's clock
    end: float
    counts: dict


@dataclasses.dataclass(frozen=True)
class Aligned:
    spans: list     # the traced steps' spans (not the steps), by start
    offsets: tuple  # (lo, hi): trace µs minus µs since the first traced step's start

    @property
    def width_us(self) -> float:
        return self.offsets[1] - self.offsets[0]

    def of(self, *names: str) -> list:
        return [s for s in self.spans if s.name in names]

    def ms(self, *names: str) -> float:
        """Summed duration of the spans of ``names``, in ms."""
        return sum(s.end - s.start for s in self.of(*names)) * 1e-3

    def count(self, name: str, key: str) -> int:
        return sum(s.counts.get(key, 0) for s in self.of(name))


def port_records():
    """The port's span records, or None where the port keeps none."""
    from recommender_tpu_torch.core import profiling

    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def of_run(r) -> Aligned | None:
    """``align`` on a traced run's readings (``portbench.harness.Readings``)
    and the port's buffer in this process."""
    records = port_records()
    return align(r.trace, r.steps, records) if records else None


def align(trace, steps: int, records: list) -> Aligned | None:
    """The last ``steps`` ``host.step`` records and all their descendants,
    moved to the trace's clock by the middle of the feasible offsets; None
    where the counts differ or no offset nests every pair."""
    roots = [x for x in records if x.name == STEP and x.parent is None][-steps:]
    if steps <= 0 or len(roots) != steps:
        return None
    origin = roots[0].start_ns
    kids = {root.id: [] for root in roots}  # each root's descendants, in the records' order
    parent = {x.id: x.parent for x in records}
    for x in records:
        up = x.parent
        while up is not None and up not in kids:
            up = parent.get(up)
        if up is not None:
            kids[up].append(x)

    def us(ns):
        return (ns - origin) / 1000.0

    outer = {name: [(ts, ts + dur) for n, ts, dur in trace.spans if n == SPAN_PREFIX + name]
             for name in ("put_batch", "train_step", "optimizer")}
    if any(len(v) != steps for v in outer.values()):
        return None
    pairs = []  # ((inner start, inner end) on the program's µs, (outer start, outer end))
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
    spans = sorted((Span(x.name, us(x.start_ns) + mid, us(x.end_ns) + mid, dict(x.counts))
                    for root in roots for x in kids[root.id]), key=lambda s: s.start)
    return Aligned(spans=spans, offsets=(lo, hi))

