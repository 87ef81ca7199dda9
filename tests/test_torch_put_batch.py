"""``Trainer.put_batch`` and the batch staging of ``Trainer.fit``.

On the CPU (the path every other CPU test runs): ``put_batch`` returns
each leaf, nested dedup plans included, as ``torch.as_tensor`` of the
host array, makes no copy stream, and its span counts the leaves' bytes
and nothing else; ``fit`` gives its ``Prefetcher`` no ``put_fn``.

On the card (marked ``cuda``; skips without one; this file imports no
jax, so it also runs where jax is not installed)::

    python -m pytest tests/test_torch_put_batch.py -m cuda --noconftest

* ``fit`` steps of a tiny DLRM under ``torch.cuda.set_sync_debug_mode
  ("error")``: any call in the loop that waits for the device (a pageable
  copy, ``.item()``, a synchronize) fails the test;
* ``put_batch``'s device leaves equal the host arrays, nested dedup plans
  included, from numpy and from ``pin_batch``; its span counts the leaves
  that arrived pageable (all of them from numpy, none from ``pin_batch``);
* three ``fit`` steps give the losses, bit for bit, of the same steps fed
  by a plain synchronous copy.
"""
import numpy as np
import pytest
import torch

from recommender_tpu_torch.core import profiling, train
from recommender_tpu_torch.core.train import TrainConfig, Trainer, pin_batch
from recommender_tpu_torch.data import SyntheticCTR, batch_iterator, pipeline
from recommender_tpu_torch.models import DLRM, make_ctr_task

SMALL = dict(embed_dim=8, bottom_units=(16, 8), top_units=(16, 1))
VOCAB, BATCH, STEPS = 500, 64, 3
NEVER = 1 << 30  # a log cadence no test reaches: no host read of the loss


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _batches(n=STEPS + 1, plans=False):
    data = SyntheticCTR(vocab_size=VOCAB, seed=0).sample(n * BATCH, 1)
    batches = batch_iterator(data, BATCH, seed=0)
    return list(pipeline.with_dedup_plans(batches) if plans else batches)


def _trainer(device, optimizer="sgd"):
    torch.manual_seed(0)
    model = DLRM(VOCAB, **SMALL, device=device)
    loss_fn, _ = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=1e-2, optimizer=optimizer,
                                           log_every=NEVER, eval_every=0), device=device)
    return trainer, trainer.init_state(lambda: model)


def _leaves(batch, prefix=""):
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_leaves(got, host, device):
    got, host = dict(_leaves(got)), dict(_leaves(host))
    assert got.keys() == host.keys() and any("/" in k for k in host)
    for k, v in host.items():
        want = torch.as_tensor(np.asarray(v))
        assert got[k].device == device and got[k].dtype == want.dtype, k
        assert torch.equal(got[k].cpu(), want), k


def _put_counts(trainer, batch, tmp_path):
    with profiling.trace(str(tmp_path)):
        trainer.put_batch(batch)
    (put,) = [r for r in profiling.spans() if r.name == "host.put_batch"]
    return put.counts


def _nbytes(batch):
    return sum(np.asarray(v).nbytes for _, v in _leaves(batch))


# --------------------------------------------------------------- the CPU
def test_put_batch_on_the_cpu_copies_as_before_and_counts_bytes_alone(tmp_path):
    trainer, _ = _trainer("cpu")
    batch = _batches(1, plans=True)[0]
    _assert_same_leaves(trainer.put_batch(batch), batch, torch.device("cpu"))
    assert _put_counts(trainer, batch, tmp_path) == {"bytes": _nbytes(batch)}
    assert trainer._copy_stream is None


@pytest.mark.parametrize("prefetch", [1, 2])
def test_fit_gives_its_prefetcher_no_put_fn_on_the_cpu(monkeypatch, prefetch):
    made = []

    def recording(*args, **kwargs):
        made.append(kwargs)
        return pipeline.Prefetcher(*args, **kwargs)

    monkeypatch.setattr(train, "Prefetcher", recording)
    trainer, state = _trainer("cpu")
    state, _ = trainer.fit(state, iter(_batches()), STEPS, prefetch=prefetch)
    assert state.step == STEPS
    assert made == [{"size": prefetch, "put_fn": None}]


# -------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fit_steps_wait_for_the_device_nowhere(cuda_device, optimizer):
    trainer, state = _trainer(cuda_device, optimizer)
    batches = _batches(1 + 2 * STEPS)
    state, _ = trainer.fit(state, iter(batches[:1]), 1)  # builds K1, fills the caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # pinned by the prefetcher's thread, then by put_batch itself
        for i, prefetch in enumerate((2, 0)):
            chunk = batches[1 + i * STEPS:1 + (i + 1) * STEPS]
            state, _ = trainer.fit(state, iter(chunk), STEPS, prefetch=prefetch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.step == 1 + 2 * STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True])
def test_put_batch_copies_every_leaf_and_counts_the_pageable_ones(cuda_device, pinned,
                                                                  tmp_path):
    trainer, _ = _trainer(cuda_device)
    host = _batches(1, plans=True)[0]
    batch = pin_batch(host) if pinned else host
    if pinned:
        assert all(v.is_pinned() for _, v in _leaves(batch))
    out = trainer.put_batch(batch)
    torch.cuda.synchronize()
    _assert_same_leaves(out, host, torch.device("cuda", torch.cuda.current_device()))
    nbytes = _nbytes(host)
    assert _put_counts(trainer, batch, tmp_path) == {
        "bytes": nbytes, "pageable_bytes": 0 if pinned else nbytes}


@pytest.mark.cuda
def test_fit_losses_are_those_of_a_synchronous_copy(cuda_device):
    batches = _batches(STEPS)
    trainer, state = _trainer(cuda_device)
    losses = []
    real = trainer.train_step

    def step(state, batch):
        state, metrics = real(state, batch)
        losses.append(metrics["loss"])
        return state, metrics

    trainer.train_step = step
    trainer.fit(state, iter(batches), STEPS)
    got = [float(x) for x in losses]

    trainer, state = _trainer(cuda_device)
    want = []
    for batch in batches:
        plain = {k: torch.as_tensor(np.asarray(v)).to(cuda_device) for k, v in batch.items()}
        state, metrics = trainer.train_step(state, plain)
        want.append(float(metrics["loss"]))
    assert got == want
