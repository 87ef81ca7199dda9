"""Model forward and backward: the host's time in the port's forward and
backward (``model.forward`` + ``model.backward``: the time to enqueue the
model's work), in ms a traced step; beside ``model.device_ms_per_step``
(``portbench.program_spans``)."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    return None if a is None else a.ms("model.forward", "model.backward") / r.steps
