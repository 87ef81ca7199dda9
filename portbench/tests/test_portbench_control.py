"""The check fails the control and every fault a training cell can have,
at a size a CPU run holds, with the cells' own limits: the reference in
the nearest precision below the configuration's put in the port's place,
and whole runs with the timed path broken underneath (the harness's look
for a card skipped)."""
import time

import pytest
import torch

from portbench import check, faults, harness, limits
from portbench.tests.tiny import cell_faults, cells, tiny_cell


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(name, seed):
    cell = tiny_cell(name)
    s = harness.seeds(seed)
    pool = cell.generator.pool(cell.traffic, cell.config["model"], s.data, harness.CHECK_STEPS)
    want = harness.reference_readings(cell, s, pool, "cpu")
    low = harness.reference_readings(cell, s, pool, "cpu", precision="lower")
    correct, shown = check.judge(check.numbers(low, want), cell.limits)
    assert not correct, shown


@pytest.mark.parametrize("name, fault", cell_faults())
def test_fault_fails_a_run(name, fault):
    cell = tiny_cell(name)
    with faults.plant(fault, cell.family) as plant:
        result = harness.run(cell, 99, 0.2, False, "cpu", time.perf_counter(), plant=plant)
    assert not result["correct"], result["check"]


def test_frozen_state_reads_one():
    cell = tiny_cell(cells()[0])
    s = harness.seeds(4)
    pool = cell.generator.pool(cell.traffic, cell.config["model"], s.data, harness.CHECK_STEPS)
    with faults.plant("frozen_state", cell.family) as plant:
        prog = harness.Program(cell, torch.device("cpu"), s, plant)
        got = prog.first_steps(pool)
    values = check.numbers(got, harness.reference_readings(cell, s, pool, "cpu"))
    assert values["change_gap"] == pytest.approx(1.0) and values["grad_gap"] == pytest.approx(1.0)


def _rows(kind, values, seeds=(1, 2, 3)):
    keys = ("loss_gap", "loss1_gap", "grad_gap", "change_gap")
    return [{"kind": kind, "seed": s, "numbers": dict(zip(keys, v))} for s, v in zip(seeds, values)]


def test_limits_lie_between_the_lower_and_the_upper_reading():
    rows = (_rows("program", [(1e-5, 1e-6, 2e-3, 0.0)] * 2 + [(8e-6, 1e-6, 1e-3, 0.0)])
            + _rows("control", [(4e-5, 1e-6, 0.05, 0.02)] * 3)
            + _rows("half_batch", [(1e-3, 1e-4, 0.4, 0.3)] * 3))
    out = limits.compute(rows, "the test")
    # loss_gap: the control reads 4x the lower, so it is the upper reading
    assert out["upper"]["loss_gap"] == {"from": "control", "reading": 4e-5, "lower": 1e-5}
    assert out["limits"]["loss_gap"] == pytest.approx((1e-5 * 4e-5 ** 2) ** (1 / 3), rel=0.05)
    # grad_gap: the control's 0.05 is under the fault's, and 25x the lower
    assert out["upper"]["grad_gap"]["from"] == "control"
    # change_gap: sound runs read 0, which counts as one f32 ulp
    lim = out["limits"]["change_gap"]
    assert lim == pytest.approx(limits.ULP ** (1 / 3) * 0.02 ** (2 / 3), rel=0.05)
    assert 3 * limits.ULP < lim < 0.02 / 1.5
    assert set(out["limits"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_a_loss_gap_without_an_upper_reading_gives_way_to_the_first_steps():
    rows = (_rows("program", [(1e-3, 1e-6, 1e-3, 1e-3)] * 3)
            + _rows("control", [(2e-3, 1e-4, 0.05, 0.02)] * 3))
    out = limits.compute(rows, "the test")
    assert "loss1_gap" in out["limits"] and "loss_gap" in out["not_compared"]
