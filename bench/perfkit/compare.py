"""The numbers that decide ``correct``: the program's first steps held to
the reference's, by the worst leaf.

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: each leaf's norm of the first clipped gradient (the
  program's worked out from its first moment after step 1), the gap of
  the two norms over the larger of the reference leaf's norm and the
  median leaf's, worst leaf;
* ``change_gap``: the same of each leaf's change after the checked steps,
  leaving out leaves whose first reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone);
* ``rank_spread`` (more than one rank): the largest difference between a
  rank's weights and rank 0's after the checked steps, read as per-leaf
  sums and norms; exactly 0 when every rank applied the same mean.
"""
from __future__ import annotations

import statistics

SMALL_GRAD = 1e-3


def _worst(prog, ref, keep=None) -> float:
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx:
        return 0.0
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30)
               for i in idx)


def numbers(prog: dict, ref: dict) -> dict:
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"]))}
    out["grad_gap"] = _worst(prog["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"])
    keep = [g >= SMALL_GRAD * med for g in ref["grad_norms"]]
    out["change_gap"] = _worst(prog["change_norms"], ref["change_norms"],
                               keep)
    if prog.get("rank_spread") is not None:
        out["rank_spread"] = prog["rank_spread"]
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit.  A limit of
    ``null`` in the cell's file marks a number that is not compared (its
    readings are in ``PERF.md``); a number the file does not name, or one
    that is not finite, fails."""
    checks, ok = {}, True
    for name, value in nums.items():
        if name in limits and limits[name] is None:
            continue
        limit = limits.get(name)
        good = (limit is not None and value == value and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
