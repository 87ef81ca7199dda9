"""A cell's limits from its calibration readings (``portbench.calibrate``'s
``--out`` files), written to ``checks/<cell>.json``.

    python3 -m portbench.limits --workload <cell> --on <card> <readings.jsonl> [...]

Each compared number's limit lies between two readings: the lower, the
largest that sound runs of the port give (one under one f32 ulp, 2^-23
relative, counts as one ulp: a gap of two f32 numbers resolves no finer),
and the upper, the least of the control's readings where they are three
times the lower or more, a planted fault's where ten times or more, and 1
(a state left unchanged reads 1 by construction) for the gradient and the
change where three times or more. The limit is lower^(1/3) * upper^(2/3),
to two digits. A cell compares ``loss_gap``, ``grad_gap`` and
``change_gap``, and ``loss1_gap`` (the first step's loss) in place of
``loss_gap`` where that has no upper reading.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from portbench import manifest

ULP = 2.0 ** -23
RULE = __doc__.split("\n\n")[2].replace("\n", " ").strip()


def two_digits(x: float) -> float:
    return float(f"{x:.1e}")


def compute(rows: list, on: str) -> dict:
    """The check file's contents from calibration lines (``kind``, ``seed``,
    ``numbers``) measured on the card ``on``."""
    by = defaultdict(lambda: defaultdict(list))
    seeds = defaultdict(set)
    for r in rows:
        seeds[r["kind"]].add(r["seed"])
        for k, v in r["numbers"].items():
            by[r["kind"]][k].append(v)

    def bound(k):
        lower = max(by["program"][k])
        floor = max(lower, ULP)
        found = [("control", min(by["control"][k]))] if min(by["control"][k]) >= 3 * floor else []
        found += [(kind, min(v[k])) for kind, v in by.items()
                  if kind not in ("program", "control") and min(v[k]) >= 10 * floor]
        if k in ("grad_gap", "change_gap") and 1.0 >= 3 * floor:
            found.append(("frozen_state", 1.0))
        if not found:
            return lower, None
        return lower, min(found, key=lambda t: t[1])

    compared = ["loss_gap" if bound("loss_gap")[1] else "loss1_gap", "grad_gap", "change_gap"]
    limits, upper, not_compared = {}, {}, {}
    if compared[0] != "loss_gap":
        not_compared["loss_gap"] = "no upper reading: the first step's gap is compared"
    for k in compared:
        lower, up = bound(k)
        if up is None:
            not_compared[k] = f"no upper reading (sound runs up to {lower:.3g})"
            continue
        limits[k] = two_digits(max(lower, ULP) ** (1 / 3) * up[1] ** (2 / 3))
        upper[k] = {"from": up[0], "reading": float(f"{up[1]:.3g}"), "lower": float(f"{lower:.3g}")}
    readings = {kind: {"seeds": sorted(seeds[kind]),
                       **{k: [float(f"{min(v):.3g}"), float(f"{max(v):.3g}")] for k, v in d.items()}}
                for kind, d in by.items()}
    readings["frozen_state"] = {"grad_gap": [1.0, 1.0], "change_gap": [1.0, 1.0]}
    out = {"limits": limits, "rule": RULE,
           "measured": f"python3 -m portbench.calibrate on {on}: sound runs on {len(seeds['program'])} "
                       f"seeds, the control and each fault on {len(seeds['control'])}",
           "upper": upper, "readings": readings}
    if not_compared:
        out["not_compared"] = not_compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--on", required=True, help="the card the readings come from")
    ap.add_argument("readings", nargs="+")
    args = ap.parse_args(argv)
    rows = [json.loads(line) for path in args.readings for line in open(path)
            if '"kind"' in line]
    out = compute(rows, args.on)
    with open(manifest.PKG / "checks" / f"{args.workload}.json", "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"limits": out["limits"], "upper": out["upper"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
