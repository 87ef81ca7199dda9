"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: the
same configuration, traffic, limits and metrics, with the small tables and
batches that the cell's family gives in its ``TINY``."""
from __future__ import annotations

import copy

from portbench import manifest


def tiny_cell(name: str, bench: dict | None = None, root=manifest.ROOT) -> manifest.Cell:
    cell = manifest.cell(name, bench, root)
    model, traffic = cell.family.TINY
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(model)
    cell.traffic = {**cell.traffic, **traffic}
    return cell


def cells(bench: dict | None = None) -> list:
    bench = manifest.load() if bench is None else bench
    return [w["name"] for w in bench["workloads"]]


def cell_faults(bench: dict | None = None, root=manifest.ROOT) -> list:
    """``(cell, fault)`` for every cell and each fault its family names."""
    return [(name, fault) for name in cells(bench)
            for fault in manifest.cell(name, bench, root).family.FAULTS]
