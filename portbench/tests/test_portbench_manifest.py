"""BENCHMARK.json against the benchmark's contract, and every file it
names."""
import json
import re
from pathlib import Path

import pytest

from portbench import faults, manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (manifest.ROOT / p).is_dir()
        assert not p.endswith("_torch") and p.split("/")[0] not in ("benchmarks", "tests")
    for word in cmd:  # names no file of the repo outside paths
        if (manifest.ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/") for p in paths), word


def test_names_units_and_entries():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        seen.add(c["name"])
    assert 1 <= len(seen) == len(BENCH["configs"]) <= 24
    names = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in seen
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.add(w["name"])
    assert 1 <= len(names) == len(BENCH["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(names)
    assert {w["config"] for w in BENCH["workloads"]} == seen
    metric_names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
        metric_names.add(m["name"])
    assert "setup_s" in metric_names and 1 <= len(BENCH["end_to_end"]) <= 16
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and _line(m["layer"])
        assert set(m.get("workloads", names)) <= names
        layers.add(m["layer"])
        metric_names.add(m["name"])
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len(metric_names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_within_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = manifest.cell(name)
    assert cell.family.KERNELS and cell.reference.loss_and_grads and cell.generator.pool
    assert set(cell.limits) <= {"loss_gap", "loss1_gap", "grad_gap", "change_gap"}
    assert {"grad_gap", "change_gap"} <= set(cell.limits) and len(cell.limits) == 3
    assert all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
        assert m["moves"] in reported
    for key in ("batch", "pool_batches", "warmup_steps", "profile_steps"):
        assert cell.traffic[key] > 0
    assert cell.traffic["pool_batches"] > 3  # the check's three steps differ
    assert cell.family.forward_macs and cell.family.k1_calls and cell.family.k2_calls
    model, traffic = cell.family.TINY
    assert set(model) <= set(cell.config["model"]) and set(traffic) <= set(cell.traffic)
    own = getattr(cell.family, "OWN_FAULTS", {})
    assert cell.family.FAULTS and set(cell.family.FAULTS) <= set(faults.SHARED) | set(own)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(entry):
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert cfg["source"] == entry["source"] and cfg["allow_tf32"] is False
    assert {"family", "model", "train", "dtypes", "assumed"} <= set(cfg)


def test_every_file_under_paths_is_named_from_name_characters():
    for path in Path(manifest.PKG).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_end_to_end_metrics_are_quantities_the_harness_measures():
    quantities = {"train_examples_per_s", "train_step_ms_p95", "setup_s"}
    units = {}
    for m in BENCH["end_to_end"]:
        quantity, _, group = m["name"].partition(".")
        assert quantity in quantities
        units.setdefault(quantity, m["unit"])
        assert m["unit"] == units[quantity]
        if group:  # the same quantity under a bound of its own, in the cells it lists
            assert m["workloads"] and quantity in {e["name"] for e in BENCH["end_to_end"]}
