"""``plan_error_pct``: the gap between the Plan's predicted iteration time
and the window's median step (CUDA events), over the median step, in %
(the paper's Table 2 measure)."""
import statistics


def read(run):
    if not run.get("step_ms") or not run.get("plan_predicted_s"):
        return None
    med = statistics.median(run["step_ms"])
    return 100.0 * abs(run["plan_predicted_s"] * 1e3 - med) / med
