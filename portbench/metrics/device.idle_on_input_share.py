"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card while the port's training loop was inside
``host.input_wait`` or ``host.put_batch``, in % (the program's spans on
the trace's clock, ``portbench.program_spans``, against the trace's idle
gaps). The rest of ``device.idle_share`` is idle behind the host's other
work: its launches.

The spans' offset is known only to the alignment's interval, and a shift
by d moves a span's overlap with the gaps by up to |d|. So the share is
read at both ends of the interval and the mean reported; where the two
differ by more than ``SPREAD`` of their mean, nothing is."""
from portbench import program_spans

SPREAD = 0.5  # the ends may differ by half their mean: the value is ±25%


def _idle_us(spans, gaps, shift):
    idle = 0.0
    for s in spans:
        start, end = s.start + shift, s.end + shift
        for g0, g1 in gaps:  # sorted and disjoint
            if g0 >= end:
                break
            idle += max(0.0, min(end, g1) - max(start, g0))
    return idle


def read(r):
    a = program_spans.of_run(r)
    window = r.trace.window[1] - r.trace.window[0]
    if a is None or window <= 0:
        return None
    gaps = r.trace.idle_gaps()
    spans = a.of("host.input_wait", "host.put_batch")  # at the interval's middle
    lo, hi = (_idle_us(spans, gaps, d) for d in (-a.width_us / 2, a.width_us / 2))
    mean = (lo + hi) / 2
    if abs(hi - lo) > SPREAD * mean:
        return None
    return 100.0 * mean / window
