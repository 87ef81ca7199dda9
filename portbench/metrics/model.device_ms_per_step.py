"""Model forward and backward: device time of a traced step's kernels
other than the optimizer's (launched inside ``portbench.optimizer``), K1's
and K2's, in ms a step. Nothing where no launch could be tied to its host
span."""


def read(r):
    if not r.trace.kernels("optimizer"):
        return None
    return r.trace.seconds("model") * 1e3 / r.steps
