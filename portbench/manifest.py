"""``BENCHMARK.json`` and the files it names.

``cell(name)`` resolves a workload to its configuration, traffic mix,
limits, family and reference modules, generator and metrics, all found by
name: ``configs/<config>.json`` (the file the manifest names),
``traffic/<traffic>.json``, ``checks/<cell>.json``,
``families/<family>.py``, ``reference/<family>.py``,
``generators/<generator>.py`` and ``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # manifest entries of the cell's end-to-end metrics
    per_layer: list    # manifest entries of the cell's per-layer metrics

    @property
    def family(self):
        return importlib.import_module(f"portbench.families.{self.config['family']}")

    @property
    def reference(self):
        return importlib.import_module(f"portbench.reference.{self.config['family']}")

    @property
    def generator(self):
        return importlib.import_module(f"portbench.generators.{self.traffic['generator']}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = load(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    w = found[0]
    (config_entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    pkg = root / PKG.relative_to(ROOT)
    return Cell(name=name, chips=int(w["chips"]), config=_json(root / config_entry["file"]),
                traffic=_json(pkg / "traffic" / f"{w['traffic']}.json"),
                limits=_json(pkg / "checks" / f"{name}.json")["limits"],
                end_to_end=end_to_end, per_layer=per_layer)
