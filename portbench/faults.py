"""Faults planted in the port, for the tests and the calibration of the
check's limits, never in a benchmark run: each breaks the timed path in
one way a training cell can be broken, and the check has to fail it.

The shared faults, of the training loop and the port's shared kernels:

* ``frozen_state``: the optimizer's step returns the state unchanged;
* ``half_batch``: the loss is the mean over the batch's first half, the
  rest left out;
* ``k1_altered``: the embedding gradient K1 produces comes out doubled;
* ``k2_altered``: the attention output K2 produces has its first batch
  row doubled.

A family names the faults that apply to its cells in its module's
``FAULTS`` (``portbench.families``), and defines a fault of its own
mechanism there, in ``OWN_FAULTS``: its name and a function of no
arguments that returns a context manager yielding what ``plant`` yields.

``plant(name, family)`` is a context manager: it looks in the family's
module first, then at the shared faults; it patches the port's modules
where the fault needs it, undoes that on exit, and yields the function
that ``harness.run`` applies to the program it builds (or None).
"""
from __future__ import annotations

import contextlib

SHARED = ("frozen_state", "half_batch", "k1_altered", "k2_altered")


def _frozen_state(prog):
    prog.state.optimizer.step = lambda *args, **kwargs: None


def _half_batch(prog):
    loss_fn = prog.trainer.loss_fn

    def half(batch, train):
        return loss_fn({k: v[: v.shape[0] // 2] for k, v in batch.items()}, train)

    prog.trainer.loss_fn = half


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _k1(old):
    def altered(ids, updates, vocab_size):
        return old(ids, updates, vocab_size) * 2
    return altered


def _k2(old):
    import torch

    def altered(q, k, v, valid):
        o = old(q, k, v, valid)
        return torch.cat([o[:1] * 2, o[1:]])
    return altered


@contextlib.contextmanager
def plant(name: str, family):
    own = getattr(family, "OWN_FAULTS", {})
    if name in own:
        with own[name]() as fn:
            yield fn
    elif name == "frozen_state":
        yield _frozen_state
    elif name == "half_batch":
        yield _half_batch
    elif name == "k1_altered":
        from recommender_tpu_torch.ops import embedding_kernels

        with _patched(embedding_kernels, "scatter_add_dense", _k1):
            yield None
    elif name == "k2_altered":
        from recommender_tpu_torch.nn import transformer

        with _patched(transformer, "flash_mha", _k2):
            yield None
    else:
        raise KeyError(name)
