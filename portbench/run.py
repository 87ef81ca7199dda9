"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's steps), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, then ``setup_parts`` (set-up's parts in
seconds: the kernels' build, the traffic, the model, the first steps and
warm-up, and the check's own time) and last ``check``, each number the
check compared with its limit; the same numbers are the last lines of
standard error. Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits with 2; if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``recommender_tpu`` is loaded once the run is
over, with 3.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``time.perf_counter()`` reading at this process's start, from
    its start time in ``/proc`` (to a clock tick), or now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recommender_tpu")


def loaded_forbidden() -> list:
    """Modules loaded whose top-level name is one of ``FORBIDDEN``,
    compared whole: ``recommender_tpu_torch`` is not ``recommender_tpu``."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, manifest
    import torch

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["setup_parts"] = result["setup_parts"]
    line["check"] = result["check"]
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
