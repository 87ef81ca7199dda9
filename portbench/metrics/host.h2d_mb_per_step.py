"""Host loop: the bytes ``Trainer.put_batch`` copied to the card (its
``host.put_batch`` span's ``bytes`` count: the leaves' ``nbytes``), in MB
(10^6 bytes) a traced step (``portbench.program_spans``)."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    return None if a is None else a.count("host.put_batch", "bytes") / r.steps / 1e6
