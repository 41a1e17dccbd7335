"""The comparison that decides `correct`: what the program produced in the
check steps against what the reference computes from the same inputs.

Three numbers, each with a limit of its own (`limits/<workload>.json`):

- loss_gap: the largest relative gap of a check step's loss;
- grad_gap: the first step's gradient, by the worst leaf: the gap between
  the program's norm (from Adam's first moment) and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf;
- change_gap: the same for the norm of each leaf's change over the check
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves them by round-off alone).
"""

from __future__ import annotations

import json
import math
import os
import statistics

ROUND_OFF_SHARE = 1e-3
NAMES = ("loss_gap", "grad_gap", "change_gap")


def worst(values) -> float:
    """The largest of `values`, nan if any is not a number."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """max over `leaves` of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    med = statistics.median(ref[k] for k in leaves)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                 for k in leaves)


def numbers(prog, ref: dict) -> dict:
    """The compared numbers of a run (nan where the program produced
    none that is finite)."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog.losses, ref["losses"])]
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moving = [k for k in grads if grads[k] >= ROUND_OFF_SHARE * med]
    out = dict(loss_gap=worst(losses),
               grad_gap=leaf_gap(prog.grad_norms, grads, list(grads)),
               change_gap=leaf_gap(prog.change_norms, ref["change_norms"],
                                   moving))
    return {k: (v if math.isfinite(v) else math.nan) for k, v in out.items()}


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return json.load(f)


def judge(nums: dict, limits: dict) -> bool:
    """Correct where every number is at most its limit (a nan is not)."""
    return all(nums[k] <= limits[k] for k in NAMES)
