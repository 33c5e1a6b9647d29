"""``sync_kernels_roofline``: the gradient-staging kernels' HBM bound over
their device time, in %, over the traced steps.  The bound is the bytes of
``perfkit.flops.staging_launches`` (each input byte read once, each output
byte written once) over the card's HBM rate.  Nothing is returned where the
trace's launches of a kernel differ from what the Plan's buckets imply."""
from collections import Counter

from perfkit import hw


def read(run):
    view = run.get("view")
    if not view or not view["steps"]:
        return None
    ops = [o for o in view["ops"] if o["staging"]]
    if not ops:
        return None
    want = Counter(k for k, _ in run["staging"])
    got = Counter(o["staging"] for o in ops)
    if any(got[k] != want[k] * view["steps"] for k in set(want) | set(got)):
        return None
    nbytes = sum(b for _, b in run["staging"]) * view["steps"]
    seconds = sum(o["dur"] for o in ops) / 1e6
    return 100.0 * nbytes / hw.PEAK_HBM_BYTES_S / seconds
