"""Optimizer: device time of the kernels launched inside
``portbench.optimizer`` (the wrapped ``optimizer.step``), in ms a step."""


def read(r):
    t = r.trace.seconds("optimizer")
    return t * 1e3 / r.steps if t > 0 else None
