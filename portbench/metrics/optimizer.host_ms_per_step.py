"""Optimizer: the host's time in the port's ``Optimizer.step``
(``optimizer.step``), in ms a traced step; beside
``optimizer.device_ms_per_step`` (``portbench.program_spans``)."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    return None if a is None else a.ms("optimizer.step") / r.steps
