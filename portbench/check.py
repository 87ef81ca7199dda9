"""The comparison that decides ``correct``.

The program's readings and the reference's (``reference.train.Readings``)
of the same first steps, from the same weights and batches, give three
numbers:

* ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
  the first step's alone;
* ``grad_gap``: the largest gap between the norms of a parameter's first
  gradient (from the optimizer's state after one step), over the larger of
  that parameter's reference norm and the median parameter's;
* ``change_gap``: the same of the norms of the parameters' change after
  the steps, over the parameters whose reference gradient is at least a
  thousandth of the median parameter's (those under it, a bias that
  softmax or a following normalisation makes constant, move by round-off
  alone under Adam).

A cell compares the numbers its ``checks/<cell>.json`` gives limits
(``limits``); a number that is not finite fails.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3  # of the median leaf's reference gradient: moved by round-off alone
GAPS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap")


def numbers(prog, ref) -> dict:
    """The three numbers of ``prog``'s readings against ``ref``'s, with
    ``worst`` (the leaf that sets ``grad_gap`` and the one that sets
    ``change_gap``) and ``excluded`` (the leaves ``change_gap`` leaves
    out)."""
    if len(prog.loss) != len(ref.loss) or set(prog.grad) != set(ref.grad) \
            or set(prog.change) != set(ref.change):
        return {**dict.fromkeys(GAPS, math.inf), "worst": {}, "excluded": []}
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog.loss, ref.loss)]
    med_g = statistics.median(ref.grad.values())
    grad = {n: abs(prog.grad[n] - g) / max(g, med_g) for n, g in ref.grad.items()}
    counted = [n for n, g in ref.grad.items() if g >= NOUGHT * med_g]
    med_c = statistics.median(ref.change[n] for n in counted)
    change = {n: abs(prog.change[n] - ref.change[n]) / max(ref.change[n], med_c)
              for n in counted}
    worst = {"grad_gap": max(grad, key=grad.get), "change_gap": max(change, key=change.get)}
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0], "grad_gap": grad[worst["grad_gap"]],
            "change_gap": change[worst["change_gap"]], "worst": worst,
            "excluded": sorted(set(ref.grad) - set(counted))}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    holds."""
    shown = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
