"""``sync_exposed_ms``: per traced step, the ms in which rank 0's card runs
NCCL or gradient-staging kernels and no other operation."""
from perfkit import trace


def read(run):
    view = run.get("view")
    if not view or not view["steps"]:
        return None
    sync = trace.union((o["ts"], o["ts"] + o["dur"]) for o in view["ops"]
                       if o["cls"] == "sync")
    if not sync:
        return None
    other = trace.union((o["ts"], o["ts"] + o["dur"]) for o in view["ops"]
                        if o["cls"] != "sync")
    hidden, j = 0.0, 0
    for a, b in sync:
        while j < len(other) and other[j][1] <= a:
            j += 1
        k = j
        while k < len(other) and other[k][0] < b:
            hidden += min(b, other[k][1]) - max(a, other[k][0])
            k += 1
    exposed = sum(b - a for a, b in sync) - hidden
    return exposed / 1e3 / view["steps"]
