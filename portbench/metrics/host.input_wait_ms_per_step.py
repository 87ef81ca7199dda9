"""Host loop: the time the port's training loop waited for its next batch
(``host.input_wait``: the ``Prefetcher``'s queue, or the bare stream), in
ms a traced step (``portbench.program_spans``)."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    return None if a is None else a.ms("host.input_wait") / r.steps
