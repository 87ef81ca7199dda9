"""The port's copy of the embedding sharding planner against the original.

``recommender_tpu_torch/embedding/planner.py`` is a copy of the JAX
package's numpy planner (its package's ``__init__`` imports jax). The
plans, their rendering into module kwargs, the measured a2a capacity and
the summary are held equal to the original's over a sweep of table
statistics, and the original's own heuristic tests run against the copy.
"""
import itertools
import warnings

import numpy as np
import pytest

from recommender_tpu.embedding import planner as jax_planner
from recommender_tpu_torch.core.mesh import Mesh
from recommender_tpu_torch.embedding import planner
from recommender_tpu_torch.embedding.planner import (
    TablePlan,
    TableStats,
    capacity_factor_from_ids,
    module_kwargs,
    plan_summary,
    plan_tables,
)


def _plan_fields(p):
    return (p.name, p.partition, p.lookup, p.capacity_factor, p.bytes_per_device)


def _sweep():
    rng = np.random.default_rng(0)
    for vocab, dim, lookups, skew in itertools.product(
            (1000, 80_000, 1_000_000, 10_000_001), (8, 18, 64), (1, 26), (None, 1.2, "head")):
        freq = None
        if skew == 1.2:
            freq = np.bincount(rng.zipf(1.2, 50_000) % min(vocab, 100_000), minlength=vocab)
        elif skew == "head":
            freq = np.ones(min(vocab, 100_000))
            freq[: len(freq) // 8] = 100.0
        yield TableStats(f"t{vocab}_{dim}", vocab, dim, lookups_per_example=lookups, id_freq=freq)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [512, 8192])
def test_plans_equal_the_originals_over_a_sweep(shards, batch):
    tables = list(_sweep())
    jax_tables = [jax_planner.TableStats(t.name, t.vocab_size, t.dim, t.lookups_per_example,
                                         t.id_freq) for t in tables]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the odd vocab's replication warning, both sides
        for threshold in (1 << 20, 32 << 20):
            ours = plan_tables(tables, shards, batch, replicate_below_bytes=threshold)
            theirs = jax_planner.plan_tables(jax_tables, shards, batch,
                                             replicate_below_bytes=threshold)
            assert [_plan_fields(p) for p in ours] == [_plan_fields(p) for p in theirs]
            assert plan_summary(ours) == jax_planner.plan_summary(theirs)


def test_module_kwargs_and_capacity_equal_the_originals():
    plans = [TablePlan("small", None, "local"),
             TablePlan("big_a2a", "model", "all_to_all", capacity_factor=3.0),
             TablePlan("big_psum", "model", "psum")]
    jax_plans = [jax_planner.TablePlan(p.name, p.partition, p.lookup, p.capacity_factor)
                 for p in plans]
    mesh = Mesh(2, 4)
    for sub in ([0, 1, 2], [0, 2], [1]):
        ours = module_kwargs([plans[i] for i in sub], mesh)
        theirs = jax_planner.module_kwargs([jax_plans[i] for i in sub], object())
        assert {k: v for k, v in ours.items() if k != "mesh"} == {
            k: v for k, v in theirs.items() if k != "mesh"}
        assert (ours["mesh"] is mesh) == (theirs["mesh"] is not None)
        assert module_kwargs([plans[i] for i in sub]) == jax_planner.module_kwargs(
            [jax_plans[i] for i in sub])
    rng = np.random.default_rng(1)
    for ids, m, vocab in ((rng.integers(0, 64, (16, 26)), 4, 64),
                          (rng.zipf(1.3, (256, 26)) % 1000, 2, 1000),
                          (np.zeros((8, 3), np.int64), 8, 80)):
        assert capacity_factor_from_ids(ids, m, vocab) == jax_planner.capacity_factor_from_ids(
            ids, m, vocab)


# the original's heuristic tests (tests/test_planner.py), on the copy
def test_small_tables_replicate():
    plans = plan_tables([TableStats("cat", vocab_size=1000, dim=18)], num_model_shards=8,
                        batch_per_device=1024)
    assert plans[0].partition is None and plans[0].lookup == "local"


def test_large_table_shards_with_a2a():
    p = plan_tables([TableStats("ids", vocab_size=10_000_000, dim=64, lookups_per_example=26)],
                    num_model_shards=8, batch_per_device=8192)[0]
    assert p.partition == "model" and p.lookup == "all_to_all"
    assert p.bytes_per_device == 10_000_000 * 64 * 4 // 8


def test_skew_raises_capacity_and_dlrm_width_takes_psum():
    freq = np.ones(80000)
    freq[:10000] = 100.0
    kw = dict(num_model_shards=8, batch_per_device=8192, replicate_below_bytes=1)
    hot = plan_tables([TableStats("ids", 80000, 64, id_freq=freq, lookups_per_example=26)], **kw)
    flat = plan_tables([TableStats("ids", 80000, 64, id_freq=np.ones(80000),
                                   lookups_per_example=26)], **kw)
    assert hot[0].lookup == "all_to_all" and hot[0].capacity_factor > 2.0
    assert flat[0].capacity_factor < hot[0].capacity_factor
    # bench.py's table at model 2 (cli.train_ctr --lookup_mode auto): a2a's
    # 2 n D / m + n is over psum's n D, so the planner keeps psum
    [dlrm] = plan_tables([TableStats("embedding", 1_000_000, 16, lookups_per_example=26)],
                         num_model_shards=2, batch_per_device=8192)
    assert (dlrm.partition, dlrm.lookup) == ("model", "psum")


def test_the_copy_imports_no_jax():
    with open(planner.__file__) as f:
        src = f.read()
    assert "import jax" not in src and "recommender_tpu." not in src
