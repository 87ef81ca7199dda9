"""Readings that set a cell's limits (``checks/<cell>.json``): the check's
numbers for sound runs of the port, for the control and for planted
faults, on many seeds in one process, without a measured window (training
needs none: the numbers come from the first steps).

    python3 -m portbench.calibrate --workload <cell> --seeds 1-12 \\
        --control-seeds 1-3 --fault-seeds 1-3 [--faults half_batch,k1_altered]

prints one JSON line a reading, ``{"kind", "seed", "numbers"}``: ``kind``
``program`` (a sound run against the reference), ``control`` (the
reference in the nearest precision below the configuration's, put in the
port's place) or a fault's name (``portbench.faults``; ``--faults``
defaults to every fault the cell's family names in its ``FAULTS``, the
shared ones and those its module defines), and a last line
with the largest and smallest reading of each kind. Where ``--out`` is
given the lines go to that file too, which ``portbench.limits`` turns into
the cell's ``checks/<cell>.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import check, faults, harness, manifest


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def program_readings(cell, s, pool, device, plant=None):
    prog = harness.Program(cell, device, s, plant)
    got = prog.first_steps(pool)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--fault-seeds", default="1-3")
    ap.add_argument("--faults", default=None, help="comma-separated; default: the family's FAULTS")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    cfg = cell.config
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
    program, control = set(_seeds(args.seeds)), set(_seeds(args.control_seeds))
    fault_seeds = set(_seeds(args.fault_seeds))
    fault_names = (list(cell.family.FAULTS) if args.faults is None
                   else [f for f in args.faults.split(",") if f])
    out = open(args.out, "a") if args.out else None
    summary: dict = {}

    def emit(kind, seed, found, **extra):
        values = {k: found[k] for k in check.GAPS}
        line = json.dumps({"kind": kind, "seed": seed, "numbers": values,
                           "worst": found["worst"], **extra})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
        for k, v in values.items():
            lo, hi = summary.setdefault(kind, {}).get(k, (v, v))
            summary[kind][k] = (min(lo, v), max(hi, v))

    for seed in sorted(program | control | fault_seeds):
        s = harness.seeds(seed)
        pool = cell.generator.pool(cell.traffic, cfg["model"], s.data, harness.CHECK_STEPS)
        ref = harness.reference_readings(cell, s, pool, device)
        if seed in program:
            got = program_readings(cell, s, pool, device)
            found = check.numbers(got, ref)
            emit("program", seed, found, loss=got.loss, ref_loss=ref.loss,
                 excluded=found["excluded"])
        if seed in control:
            low = harness.reference_readings(cell, s, pool, device, precision="lower")
            emit("control", seed, check.numbers(low, ref), loss=low.loss)
        if seed in fault_seeds:
            for name in fault_names:
                with faults.plant(name, cell.family) as plant:
                    got = program_readings(cell, s, pool, device, plant)
                emit(name, seed, check.numbers(got, ref), loss=got.loss)
    line = json.dumps({"summary": summary})
    print(line)
    if out:
        print(line, file=out)
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
