"""Host loop: the bytes that reached the port's ``Trainer.put_batch`` in
pageable memory, which it had to pin on the loop's thread before their
asynchronous copy (its ``host.put_batch`` span's ``pageable_bytes``
count), in MB (10^6 bytes) a traced step (``portbench.program_spans``).
0 where every batch came pinned from the prefetcher's thread. Nothing
where no span carries the count: a program without it, or the CPU."""
from portbench import program_spans


def read(r):
    a = program_spans.of_run(r)
    if a is None:
        return None
    counted = [s.counts["pageable_bytes"] for s in a.of("host.put_batch")
               if "pageable_bytes" in s.counts]
    return sum(counted) / r.steps / 1e6 if counted else None
