"""The comparison that decides ``correct`` for a training cell.

The numbers, each held to its limit in ``limits/<workload>.json`` (the
file names the numbers a cell compares):

    loss_gap           the largest |loss_program - loss_reference| over
                       the followed steps, in nats
    grad_gap           over the leaves: |norm_program - norm_reference| of
                       the first clipped gradient, over the larger of the
                       reference's norm of that leaf and of the median leaf
    change_gap         the worst leaf's gap, likewise, of the norm of the
                       parameters' change over the followed steps

The gaps are between norms, not norms of a difference. Leaves whose
reference gradient is under a thousandth of the median leaf's (nought to
rounding, which AdamW would still move by its step) are left out of the
leaf numbers. A number that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
TINY_GRAD = 1e-3


def leaves_compared(reference: Dict) -> List[str]:
    grads = reference["grad"]
    median = statistics.median(grads.values())
    return sorted(k for k, g in grads.items() if g >= TINY_GRAD * median)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> Dict[str, float]:
    """Each leaf's |norm gap| over max(its reference norm, the median
    leaf's)."""
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def readings(program: Dict, reference: Dict) -> Dict[str, float]:
    keys = leaves_compared(reference)
    missing = [k for k in keys if k not in program["grad"]
               or k not in program["change"]]
    if missing:
        raise KeyError(f"the program has no leaves {missing}")
    grad = leaf_gaps(program["grad"], reference["grad"], keys).values()
    change = leaf_gaps(program["change"], reference["change"],
                       keys).values()
    steps = [abs(p - r) for p, r in zip(program["loss"], reference["loss"])]
    return {"loss_gap": max(steps), "grad_gap": max(grad),
            "change_gap": max(change)}


def compare(program: Dict, reference: Dict, limits: Dict) -> Dict:
    """{name: {"value", "limit"}} for every number the limits name, and
    whether all hold."""
    values = readings(program, reference)
    out = {n: {"value": values[n], "limit": lim["limit"]}
           for n, lim in limits.items()}
    out["correct"] = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                         for v in out.values())
    return out
