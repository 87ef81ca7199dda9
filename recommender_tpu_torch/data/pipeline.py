"""Host input pipeline: fixed-shape batching of numpy arrays.

``batch_iterator`` is a copy of ``recommender_tpu/data/pipeline.py``'s (the
original module imports jax). It yields the same stream for the same seed,
``start_batch`` included. Batches stay numpy; ``Trainer.put_batch`` copies
them to the device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def batch_iterator(
    arrays: dict,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int | None = 1,
    start_batch: int = 0,
) -> Iterator[dict]:
    """Yield dict batches from a dict of equal-length numpy arrays.

    ``start_batch`` skips that many batches of the (seed-determined) stream
    before yielding, so a run restarted at step k continues on exactly the
    batches it would have seen. Skipping is index arithmetic; whole skipped
    epochs still draw their permutation so the stream stays bit-identical.
    """
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        stop = (n // batch_size) * batch_size if drop_remainder else n
        per_epoch = len(range(0, stop, batch_size))
        if start_batch >= per_epoch:
            if shuffle:
                rng.permutation(n)  # consume this epoch's draw
            start_batch -= per_epoch
            epoch += 1
            continue
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(start_batch * batch_size, stop, batch_size):
            sel = idx[s : s + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}
        start_batch = 0
        epoch += 1
