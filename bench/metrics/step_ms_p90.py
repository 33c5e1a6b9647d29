"""``step_ms_p90``: the 90th percentile of the window's step times, each
between CUDA events recorded around the step, with no host sync per
step."""
import statistics


def read(run):
    ms = run.get("step_ms") or []
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
