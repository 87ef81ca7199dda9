"""The plain reference against the port, at a size a CPU run holds: a
whole run of each cell drives the port and the reference through the same
first steps and reads within the cell's limits; the pieces the reference
copies agree with the port's."""
import time

import numpy as np
import pytest
import torch

from portbench import check, harness, weights
from portbench.reference import rounding
from portbench.tests.tiny import cells, tiny_cell


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", cells())
def test_a_whole_run_is_correct(name):
    cell = tiny_cell(name)
    result = harness.run(cell, 2**31 + 17, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result["check"]) == list(cell.limits)


@pytest.mark.parametrize("name", ["dlrm_kaggle.b65536", "bst_taobao.T1000_b1024"])
def test_reference_follows_the_port(name):
    cell = tiny_cell(name)
    s = harness.seeds(5)
    pool = cell.generator.pool(cell.traffic, cell.config["model"], s.data, harness.CHECK_STEPS)
    prog = harness.Program(cell, torch.device("cpu"), s)
    got = prog.first_steps(pool)
    want = harness.reference_readings(cell, s, pool, "cpu")
    assert len(got.loss) == 3 and len(set(got.loss)) == 3
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-6)
    values = check.numbers(got, want)
    assert values["loss_gap"] < 1e-6 and values["grad_gap"] < 1e-5
    assert all(values[k] <= v for k, v in cell.limits.items())


def test_weights_fit_the_ports_parameters():
    for name in ("dlrm_kaggle.b65536", "bst_taobao.T1000_b1024"):
        cell = tiny_cell(name)
        model, _ = cell.family.build(cell.config["model"], "cpu")
        w = weights.make(cell.family.leaves(cell.config["model"]), 3, "cpu")
        weights.load(model, w)
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), w[n])
        again = weights.make(cell.family.leaves(cell.config["model"]), 3, "cpu")
        assert all(torch.equal(w[n], again[n]) for n in w)


def test_sort_order_is_the_ports_leaf_order():
    from recommender_tpu_torch.convert import jax_leaf_order

    for name in ("dlrm_kaggle.b65536", "bst_taobao.T1000_b1024"):
        cell = tiny_cell(name)
        model, _ = cell.family.build(cell.config["model"], "cpu")
        ours = sorted((l.name for l in cell.family.leaves(cell.config["model"])),
                      key=lambda n: tuple(n.split(".")))
        assert ours == [n for n, _ in jax_leaf_order(model)]


def test_stochastic_rounding_is_the_ports():
    from recommender_tpu_torch.ops.rounding import fold_in, prng_key, stochastic_round_to

    x = torch.randn(4096) * 3
    for seed, data in ((0, 1), (2**32 - 1, 12345)):
        key = fold_in(prng_key(seed), data)
        assert rounding.fold_in(rounding.prng_key(seed), data) == key
        ours = rounding.round_bf16(x, key)
        theirs = stochastic_round_to(x, torch.bfloat16, key).to(torch.float32)
        assert torch.equal(ours, theirs)
