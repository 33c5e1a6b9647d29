"""The port's own spans in a ``torch.profiler`` trace (its Chrome-trace
JSON): each device operation of the traced window with the step phase and
the model region it belongs to, and the readings taken from them.

The port (``repro_torch.spans``) names its step's phases (``step.fwd``,
``step.bwd``, ``step.sync`` with one ``sync.bucket`` per gradient bucket
inside it, ``step.clip``, ``step.update``) and its model's regions
(``model.attn``, ``model.ffn``, ``model.io``) with ``record_function``
ranges, the kind the harness's ``bench.*`` spans are.  A device operation
(kernel, copy or fill) is tied to the host thread and time of its launch
by the launch's correlation id, as ``perfkit.trace`` ties it, whichever
CUDA API category (``LAUNCH_CATS``) recorded the launch.  Then:

* its phase is the innermost phase span holding the launch time, among the
  spans of the thread that opened ``bench.traced`` (the step's thread:
  autograd's own thread runs inside its ``step.bwd``);
* its region is the innermost ``model.*`` span open on the launching
  thread at the launch (the forward, and remat's recompute, on whichever
  thread runs it); failing that, the region of the forward operation it
  differentiates.  The outermost backward node's evaluation around the
  launch (an operation whose ``Fwd thread id`` is set) carries the node's
  autograd ``Sequence number``.  Every operation records the number the
  next node will take, so the forward operation that made the node is the
  last one to start with that number inside ``step.fwd`` on the step's
  thread.

An operation that neither finds gets None.  A trace without the port's
spans (a program that lacks them) gives None for every operation, and the
readings find nothing to read."""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from . import trace

PHASES = ("step.fwd", "step.bwd", "step.sync", "sync.bucket", "step.clip",
          "step.update")
REGIONS = ("model.attn", "model.ffn", "model.io")
SYNC = ("step.sync", "sync.bucket")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Innermost:
    """Properly nested (start, end, label) intervals of one thread, cut
    into disjoint pieces, each labelled by the innermost interval over
    it."""

    def __init__(self, spans):
        pieces, stack, cur = [], [], None
        for a, b, label in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= a:
                top = stack.pop()
                pieces.append((cur, top[1], top[2]))
                cur = top[1]
            if stack:
                pieces.append((cur, a, stack[-1][2]))
            stack.append((a, b, label))
            cur = a
        while stack:
            top = stack.pop()
            pieces.append((cur, top[1], top[2]))
            cur = top[1]
        self.pieces = [p for p in pieces if p[1] > p[0]]
        self.starts = [p[0] for p in self.pieces]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _outermost(spans) -> list:
    """The intervals that no other one of ``spans`` holds."""
    out = []
    for a, b, label in sorted(spans, key=lambda s: (s[0], -s[1])):
        if not out or a >= out[-1][1]:
            out.append((a, b, label))
    return out


def reduce_trace(raw) -> dict:
    """``{"window": (t0, t1) in us, "steps": n, "ops": [...]}``: each
    device op of the window as ``{"name", "ts", "dur", "phase", "region",
    "nccl", "step"}`` (``step``: the index of the ``bench.step`` span over
    its launch, or -1)."""
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    window = trace._spans(events, "bench.traced")
    if not window:
        raise ValueError("the trace holds no bench.traced span")
    t0, t1 = window[0]
    steps = [s for s in trace._spans(events, "bench.step")
             if t0 <= s[0] <= t1]
    main_tid = next((e.get("tid") for e in events
                     if e.get("name") == "bench.traced"), None)
    phases, models, seqs = [], defaultdict(list), defaultdict(list)
    launches = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args", {})
        span = (e["ts"], e["ts"] + e["dur"], name)
        if cat == "user_annotation":
            if name in PHASES and e.get("tid") == main_tid:
                phases.append(span)
            elif name in REGIONS:
                models[e.get("tid")].append(span)
        elif cat == "cpu_op" and args.get("Sequence number", -1) >= 0:
            kind = "bwd" if args.get("Fwd thread id", 0) else "fwd"
            seqs[kind, e.get("tid")].append(
                (e["ts"], e["ts"] + e["dur"], args["Sequence number"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), e["ts"])
    phase_at = _Innermost(phases)
    region_at = {tid: _Innermost(s) for tid, s in models.items()}
    forward = {}
    if main_tid in region_at:
        for a, _, seq in sorted(seqs["fwd", main_tid]):
            if phase_at.at(a) == "step.fwd":
                forward[seq] = region_at[main_tid].at(a)
    node_at = {tid: _Innermost(_outermost(s))
               for (kind, tid), s in seqs.items() if kind == "bwd"}
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS \
                or not t0 <= e["ts"] <= t1:
            continue
        tid, at = launches.get(e.get("args", {}).get("correlation"),
                               (None, e["ts"]))
        region = region_at[tid].at(at) if tid in region_at else None
        if region is None and tid in node_at:
            region = forward.get(node_at[tid].at(at))
        name = e.get("name", "")
        ops.append({"name": name, "ts": e["ts"], "dur": e["dur"],
                    "phase": phase_at.at(at), "region": region,
                    "nccl": trace.is_nccl(name),
                    "step": trace._inside(steps, at)})
    ops.sort(key=lambda o: o["ts"])
    return {"window": (t0, t1), "steps": len(steps), "ops": ops}


# ------------------------------------------------------------ readings
def _per_step_ms(view, keep) -> float | None:
    us = sum(o["dur"] for o in view["ops"] if keep(o))
    return us / 1e3 / view["steps"] if us > 0 else None


def _exposed_us(mine, other) -> float:
    """Microseconds of the union of ``mine`` that ``other`` leaves
    uncovered."""
    mine, other = trace.union(mine), trace.union(other)
    hidden, j = 0.0, 0
    for a, b in mine:
        while j < len(other) and other[j][1] <= a:
            j += 1
        k = j
        while k < len(other) and other[k][0] < b:
            hidden += min(b, other[k][1]) - max(a, other[k][0])
            k += 1
    return sum(b - a for a, b in mine) - hidden


def bus_bytes(collective_bytes: dict, n: int) -> float:
    """Bytes on each rank's links for ``collective_bytes`` (the payloads
    of ``COLLECTIVE_BYTES``) at NCCL's bus factors over ``n`` ranks:
    2(n-1)/n for an all-reduce, (n-1)/n for a reduce-scatter or an
    all-gather."""
    return ((n - 1) / n * (2 * collective_bytes.get("all_reduce", 0)
                           + collective_bytes.get("reduce_scatter", 0)
                           + collective_bytes.get("all_gather", 0)))


def readings(view, *, collective_bytes=None, plan_comm_s=None,
             chips: int = 1) -> dict:
    """Per traced step, from a span view (:func:`reduce_trace`): the device
    ms in each phase and each model region, the ms in which sync ops run
    and no other op runs, and, over more than one chip, the gradient
    buckets' NCCL bus bandwidth (``collective_bytes``: payload bytes a
    step) and the gap between the Plan's serialized comm price
    (``plan_comm_s``) and their NCCL seconds.  The NCCL seconds are the
    median step's: a rank's kernel waits for the last rank to arrive, so
    one stall on another rank's host lengthens one step's.  None where
    nothing was found."""
    out = dict.fromkeys(("fwd_ms", "bwd_ms", "attn_ms", "ffn_ms", "io_ms",
                         "clip_ms", "update_ms", "grad_sync_exposed_ms",
                         "sync_busbw_gbs", "comm_model_error_pct"))
    if not view or not view["steps"]:
        return out
    ops = view["ops"]
    for key, phase in (("fwd_ms", "step.fwd"), ("bwd_ms", "step.bwd"),
                       ("clip_ms", "step.clip"),
                       ("update_ms", "step.update")):
        out[key] = _per_step_ms(view, lambda o: o["phase"] == phase)
    for key, region in (("attn_ms", "model.attn"), ("ffn_ms", "model.ffn"),
                        ("io_ms", "model.io")):
        out[key] = _per_step_ms(view, lambda o: o["region"] == region)
    mine = [(o["ts"], o["ts"] + o["dur"]) for o in ops if o["phase"] in SYNC]
    if mine:
        other = [(o["ts"], o["ts"] + o["dur"]) for o in ops
                 if o["phase"] not in SYNC]
        out["grad_sync_exposed_ms"] = (_exposed_us(mine, other) / 1e3
                                       / view["steps"])
    by_step = defaultdict(float)
    for o in ops:
        if o["nccl"] and o["phase"] == "sync.bucket" and o["step"] >= 0:
            by_step[o["step"]] += o["dur"] / 1e6
    nccl_s = statistics.median(by_step.values()) if by_step else 0.0
    if chips > 1 and nccl_s > 0:
        if collective_bytes:
            out["sync_busbw_gbs"] = bus_bytes(collective_bytes,
                                              chips) / nccl_s / 1e9
        if plan_comm_s:
            out["comm_model_error_pct"] = (100.0 * abs(plan_comm_s - nccl_s)
                                           / nccl_s)
    return out
