"""Attention: K2's least time at each traced step's mask (forward and
backward, the larger of bytes at 3.35 TB/s and 3xTF32 products at
495 TFLOP/s, ``roofline.k2_bound_s``) over K2's device time, in %."""
from portbench import roofline


def read(r):
    t = r.trace.seconds("attention.k2")
    calls = [c for batch in r.batches for c in r.family.k2_calls(r.model, batch)]
    if t <= 0 or not calls:
        return None
    return 100.0 * sum(roofline.k2_bound_s(*c) for c in calls) / t
