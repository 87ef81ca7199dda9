"""Host loop: CUDA kernels launched a traced step (``Trainer.fit``,
``put_batch`` and the ``Prefetcher`` set how fast they are issued)."""


def read(r):
    n = len(r.trace.kernels())
    return n / r.steps if n else None
