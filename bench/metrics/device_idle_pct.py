"""``device_idle_pct``: the share of the traced window in which no device
operation runs on rank 0's card, in %."""
from perfkit import trace


def read(run):
    view = run.get("view")
    if not view:
        return None
    t0, t1 = view["window"]
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - trace.busy_us(view) / (t1 - t0))
