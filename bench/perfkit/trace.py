"""Reducing a ``torch.profiler`` trace (its Chrome-trace JSON) of rank 0
to what the per-layer readers need.

The harness's own spans (``record_function``) mark the calls it makes:
``bench.traced`` around the traced steps, ``bench.step`` around each call
of the step, ``bench.optimizer`` around each call of the optimizer's
``update`` it passes in.  A device operation (kernel, copy or fill) belongs
to the span in which its launch was issued on the host (matched by the
launch's correlation id), whatever thread issued it.  Classes:

* ``sync``: NCCL kernels, and the gradient-staging kernels of
  ``grad_sync.cu`` (bucket pack, fused pack and unpack, convert-copy);
* ``optim``: everything launched inside ``bench.optimizer``;
* ``model``: every other device operation of a step."""
from __future__ import annotations

import json

STAGING = ("bucket_pack_kernel", "fused_pack_kernel", "fused_unpack_kernel",
           "convert_copy_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def staging_kind(name: str) -> str | None:
    for k in STAGING:
        if k in name:
            return k[:-len("_kernel")]
    return None


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def _spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("name") == name
                  and e.get("cat") in ("user_annotation", "cpu_op"))


def _inside(spans, t) -> int:
    """Index of the span holding host time ``t``, or -1."""
    for i, (a, b) in enumerate(spans):
        if a <= t <= b:
            return i
    return -1


def reduce_trace(trace: dict) -> dict:
    """``{"window": (t0, t1) in us, "steps": n, "ops": [...], "host":
    [...]}``: each device op as ``{"name", "ts", "dur", "cls", "step",
    "staging"}``, and the main thread's host events (``name``, ``ts``,
    ``dur``) for labelling idle gaps."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    window = _spans(events, "bench.traced")
    if not window:
        raise ValueError("the trace holds no bench.traced span")
    t0, t1 = window[0]
    steps = [s for s in _spans(events, "bench.step") if t0 <= s[0] <= t1]
    optim = _spans(events, "bench.optimizer")
    launch_ts = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    main_tid = next((e.get("tid") for e in events
                     if e.get("name") == "bench.traced"), None)
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            if not (t0 <= e["ts"] <= t1):
                continue
            at = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
            name = e.get("name", "")
            staging = staging_kind(name)
            if staging or is_nccl(name):
                cls = "sync"
            elif _inside(optim, at) >= 0:
                cls = "optim"
            else:
                cls = "model"
            ops.append({"name": name, "ts": e["ts"], "dur": e["dur"],
                        "cls": cls, "step": _inside(steps, at),
                        "staging": staging})
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime") and \
                e.get("tid") == main_tid and t0 <= e["ts"] <= t1:
            host.append({"name": e.get("name", ""), "ts": e["ts"],
                         "dur": e["dur"]})
    ops.sort(key=lambda o: o["ts"])
    return {"window": (t0, t1), "steps": len(steps), "ops": ops,
            "host": host}


def load(path) -> dict:
    with open(path) as f:
        return reduce_trace(json.load(f))


def union(intervals) -> list:
    """Merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def busy_us(view: dict) -> float:
    return covered((o["ts"], o["ts"] + o["dur"]) for o in view["ops"])


def idle_gaps(view: dict) -> list:
    """(start, length) of each gap in the window in which no device
    operation runs, longest first."""
    t0, t1 = view["window"]
    gaps, cur = [], t0
    for a, b in union((o["ts"], o["ts"] + o["dur"]) for o in view["ops"]):
        if a > cur:
            gaps.append((cur, a - cur))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1 - cur))
    return sorted(gaps, key=lambda g: -g[1])


def host_at(view: dict, t: float) -> str:
    """The innermost host event of the main thread running at ``t``."""
    best = None
    for h in view["host"]:
        if h["ts"] <= t <= h["ts"] + h["dur"]:
            if best is None or h["dur"] < best["dur"]:
                best = h
    return best["name"] if best else "host idle"


def breakdown(view: dict, top: int = 10) -> dict:
    by_name: dict = {}
    for o in view["ops"]:
        by_name[o["name"]] = by_name.get(o["name"], 0.0) + o["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps(view)[:top]
    return {"device_ops": [[n[:200], d / 1e6] for n, d in ops],
            "idle_gaps": [[host_at(view, a)[:200], g / 1e6]
                          for a, g in gaps]}
