"""``mfu``: model FLOPs of the window's steps (``perfkit.flops``, from the
configuration file) over the window's seconds times every chip's bf16
peak, in %."""
from perfkit import hw


def read(run):
    if not run.get("steps") or not run.get("window_s"):
        return None
    return (100.0 * run["flops_per_step"] * run["steps"]
            / (run["window_s"] * hw.PEAK_BF16_FLOPS * run["chips"]))
