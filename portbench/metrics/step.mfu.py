"""The whole step: the least time of an example's model FLOPs at the
card's peaks (the family's count on the traced batches, without the work
the port adds on pads or structural zeros; forward and backward at twice
the forward, no recomputation;
f32 products at the 3xTF32 rate of 165 TFLOP/s, bf16 products at
989 TFLOP/s, ``roofline.PEAK_FLOPS``) times the examples a second of the
window before the trace, in %."""
from portbench import roofline


def read(r):
    return 100.0 * roofline.peak_time_s(r.flops_per_example()) * r.examples_per_s
