"""Host loop: the host's time in the port's ``Trainer.put_batch``
(``host.put_batch``: the batch's leaves made tensors and copied to the
card), in ms a traced step (``portbench.program_spans``)."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    return None if a is None else a.ms("host.put_batch") / r.steps
