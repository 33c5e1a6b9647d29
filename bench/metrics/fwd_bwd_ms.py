"""``fwd_bwd_ms``: rank 0's device ms per traced step in the model's
operations, the forward, backward and clip: every device operation of a
step outside the sync and the optimizer."""


def read(run):
    view = run.get("view")
    if not view or not view["steps"]:
        return None
    ms = sum(o["dur"] for o in view["ops"] if o["cls"] == "model") / 1e3
    return ms / view["steps"] if ms > 0 else None
