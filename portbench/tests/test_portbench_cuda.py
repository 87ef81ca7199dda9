"""Short runs of every cell on the card: ``correct``, the result line's
keys, every per-layer metric present, shares of a roofline or a peak
under 100%. Marked ``cuda``; skips where no card is found.

    python -m pytest portbench/tests -m cuda
"""
import json
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.tests.tiny import cells


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_cell_runs_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", "4242424242", "--seconds", "3", "--trace", "1"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check" and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    cell = manifest.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    for metric, v in line["metrics"].items():
        if metric.endswith("_roofline") or "mfu" in metric:
            assert 0 < v["value"] <= 100, (metric, v)
