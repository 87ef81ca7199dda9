"""``core.profiling`` and the last exported names against the JAX package:
``StepTimer`` (on scripted clock readings), ``trace`` and ``annotate`` (a
trace file on the CPU that names the span), ``sampled_sigmoid_ce`` and
``bag_combine`` (1e-6 abs, f32 on both sides), ``EmbeddingSpec``'s fields,
and the ``SyntheticInterestDrift`` and ``SyntheticMultiInterest`` samples
(bit for bit at two seeds, and their oracle AUCs equal)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommender_tpu.core import profiling as jax_profiling
from recommender_tpu.data import synthetic as jax_synthetic
from recommender_tpu.embedding import EmbeddingSpec as JaxEmbeddingSpec
from recommender_tpu.embedding.table import bag_combine as jax_bag_combine
from recommender_tpu.nn import sampled_sigmoid_ce as jax_sampled_sigmoid_ce
from recommender_tpu_torch.core import profiling
from recommender_tpu_torch.data import synthetic
from recommender_tpu_torch.embedding import EmbeddingSpec
from recommender_tpu_torch.embedding.table import bag_combine
from recommender_tpu_torch.nn import sampled_sigmoid_ce


def _scripted_clock(monkeypatch, module, ticks):
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_step_timer_matches_the_jax_copy(monkeypatch, warmup):
    # five steps of 10, 20, 5, 40 and 15 ms, the same clock for both
    ticks = [0.0, 0.010, 1.0, 1.020, 2.0, 2.005, 3.0, 3.040, 4.0, 4.015]
    summaries = []
    for module in (profiling, jax_profiling):
        _scripted_clock(monkeypatch, module, ticks)
        timer = module.StepTimer(warmup=warmup)
        for _ in range(5):
            with timer:
                pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 5 - warmup
    assert profiling.StepTimer().summary() == {} == jax_profiling.StepTimer().summary()


def test_trace_writes_a_file_that_names_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("host_phase_mark"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "host_phase_mark" for e in events)
    assert any(e.key == "host_phase_mark" for e in prof.key_averages())


def test_sampled_sigmoid_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(16, 6)) * 4).astype(np.float32)
    labels = np.zeros((16, 6), np.float32)
    labels[:, 0] = 1.0
    want = np.asarray(jax_sampled_sigmoid_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = sampled_sigmoid_ce(torch.tensor(logits), torch.tensor(labels)).numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_bag_combine_matches_jax(combiner):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(3, 5, 7, 4)).astype(np.float32)
    weights = (rng.random((3, 5, 7)) < 0.6).astype(np.float32) * rng.random((3, 5, 7))
    weights[0, 0] = 0.0  # an empty bag: the mean divides by max(0, 1)
    if combiner == "max":
        with pytest.raises(ValueError, match="unknown combiner"):
            jax_bag_combine(jnp.asarray(emb), jnp.asarray(weights), combiner)
        with pytest.raises(ValueError, match="unknown combiner"):
            bag_combine(torch.tensor(emb), torch.tensor(weights), combiner)
        return
    want = np.asarray(jax_bag_combine(jnp.asarray(emb), jnp.asarray(weights), combiner))
    got = bag_combine(torch.tensor(emb), torch.tensor(weights), combiner).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_embedding_spec_fields_are_the_jax_packages():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(EmbeddingSpec) == fields(JaxEmbeddingSpec)
    spec = EmbeddingSpec("items", 1000, 16, combiner="mean", sharded=True)
    assert dataclasses.astuple(spec) == dataclasses.astuple(
        JaxEmbeddingSpec("items", 1000, 16, combiner="mean", sharded=True))
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.features = 8


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize(
    "name,kw",
    [("SyntheticInterestDrift", dict(num_items=2000, num_cats=60, max_len=20, seed=0)),
     ("SyntheticInterestDrift", dict(num_items=500, num_cats=30, max_len=9, num_topics=3,
                                     hard_neg_frac=0.8, seed=4)),
     ("SyntheticMultiInterest", dict(num_items=2000, num_cats=60, max_len=20, hist_cats=12,
                                     seed=0)),
     ("SyntheticMultiInterest", dict(num_items=300, num_cats=40, max_len=30, hist_cats=25,
                                     seed=2))],
)
def test_generators_are_bit_identical_to_jax(name, kw, seed):
    ours_gen, ref_gen = getattr(synthetic, name)(**kw), getattr(jax_synthetic, name)(**kw)
    ours, ref = ours_gen.sample(64, seed), ref_gen.sample(64, seed)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert ours[k].tobytes() == ref[k].tobytes(), k
    assert ours_gen.oracle_aucs(ours) == ref_gen.oracle_aucs(ref)
