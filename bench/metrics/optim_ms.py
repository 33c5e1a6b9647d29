"""``optim_ms``: rank 0's device ms per traced step in the operations
launched inside the optimizer's ``update``, which the harness passes to the
step wrapped in its ``bench.optimizer`` span."""


def read(run):
    view = run.get("view")
    if not view or not view["steps"]:
        return None
    ms = sum(o["dur"] for o in view["ops"] if o["cls"] == "optim") / 1e3
    return ms / view["steps"] if ms > 0 else None
