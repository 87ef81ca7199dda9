"""Embedding backward: K1's least time at each traced step's ids (its
kernels' bytes at 3.35 TB/s: ids, order and update rows read once, a row
written for each distinct id; ``roofline.k1_kernel_bytes``) over K1's
device time in the traced steps, in %."""
from portbench import roofline


def read(r):
    t = r.trace.seconds("embedding.k1")
    if t <= 0:
        return None
    bound = sum(roofline.k1_bound_s(**c) for batch in r.batches
                for c in r.family.k1_calls(r.model, batch))
    return 100.0 * bound / t
