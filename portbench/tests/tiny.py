"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: the
same configuration, traffic, limits and metrics, with small tables and
batches."""
from __future__ import annotations

import copy

from portbench import manifest

TINY = {
    "dlrm": (dict(vocab_size=26 * 40, cardinalities=[40] * 26),
             dict(batch=64, pool_batches=4, warmup_steps=2, profile_steps=2)),
    "bst": (dict(item_vocab=500, cat_vocab=20, max_len=32),
            dict(batch=32, pool_batches=4, history=20, warmup_steps=2, profile_steps=2)),
}


def tiny_cell(name: str) -> manifest.Cell:
    cell = manifest.cell(name)
    model, traffic = TINY[cell.config["family"]]
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(model)
    cell.traffic = {**cell.traffic, **traffic}
    return cell


def cells() -> list:
    return [w["name"] for w in manifest.load()["workloads"]]
