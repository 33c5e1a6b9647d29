"""First-class tensor-parallel activation traffic (DESIGN.md Sec. 14).

An earlier model priced TP activation collectives as :class:`BackgroundTraffic` — a
periodic average over the compute horizon.  That prices *statistical*
contention: the search schedules gradient buckets into windows that are
quiet on average, not windows that are actually quiet.  This module
promotes the tp class to first-class scheduled jobs, dep-coupled to the
compute that produces and consumes them, the same promotion the pp class
has (:mod:`.pipeline`):

* :class:`TPTraffic` — the declarative description: ``n_layers`` per-layer
  collectives of ``fwd_bytes`` (forward activations) and ``bwd_bytes``
  (backward activation-gradients) each, of a given collective
  ``algo``/``kind``.  ``to_tuple``/``from_tuple`` round-trip it through the
  Plan artifact (schema v3) and the search worker pool.
* :func:`balanced_spans` — the busy-balanced contiguous bisection of a
  serialized schedule shared with the pipeline stage split
  (``Simulator.pipeline_inputs`` delegates here so the two lowerings can
  never drift).
* :func:`couple_tp` — the single-device lowering: the serialized schedule
  is split into ``n_layers`` spans; each span's **forward** TP job deps on
  the span's last compute job and *gates the next span's first compute
  job* (forward activations block downstream compute); each span's
  **backward** TP job deps on the same producer and is handed back to the
  caller to gate the gradient buckets that span provides (backward
  collectives gate gradient readiness).
* :func:`couple_tp_pipeline` — the 1F1B lowering: every (stage,
  microbatch, fwd/bwd) unit carries its share of the per-layer collectives
  (``n_layers / (S * v * M)`` layers per unit, so total tp bytes are
  conserved exactly against the legacy background model); the unit's TP
  job deps on the unit and gates the device's *next* unit — synchronous TP
  blocks the device until its collective completes — and the last backward
  unit's TP job replaces ``last_bwd[s]`` as the stage's gradient gate.

Zero-byte legs follow the p2p rule of :mod:`.pipeline`: a free TP collective is never
emitted as a job (a zero-byte comm job would be pre-finished at t=0 and
carry no scheduling information) — the compute chain *is* the direct
dependency, so the lowering degenerates bit-exactly to the un-TP'd
schedule.

:meth:`TPTraffic.to_background` is the fallback the tentpole keeps: when
no layer mapping is available (serialized channel, legacy callers) the
same description lowers to the PR-4 periodic averages — ``n_layers``
forward jobs phase-offset from ``n_layers`` backward jobs, total bytes
identical to the dep-coupled lowering by construction.

Import-light on purpose (no torch): loadable by the search worker pool and
the Plan artifact from bare interpreters.
"""
from __future__ import annotations

import bisect
import dataclasses

from ..cluster.collectives import KIND_AR
from .events import BackgroundTraffic, CommJob, ComputeJob, TC_TP


@dataclasses.dataclass(frozen=True)
class TPTraffic:
    """Per-layer tensor-parallel activation collectives.

    ``fwd_bytes`` / ``bwd_bytes`` are bytes per layer per iteration (the
    pipeline lowering divides them over microbatches and virtual stages so
    totals conserve).  ``bwd_bytes=None`` mirrors the forward volume — the
    usual Megatron pattern where the backward all-reduce moves the same
    activation-gradient bytes."""
    n_layers: int
    fwd_bytes: float
    bwd_bytes: float | None = None
    algo: str = "ring"
    kind: str = KIND_AR

    def __post_init__(self):
        if self.n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {self.n_layers}")
        if self.fwd_bytes < 0.0:
            raise ValueError("fwd_bytes must be >= 0")
        if self.bwd_bytes is not None and self.bwd_bytes < 0.0:
            raise ValueError("bwd_bytes must be >= 0")

    @property
    def bwd(self) -> float:
        return self.fwd_bytes if self.bwd_bytes is None else self.bwd_bytes

    @property
    def total_bytes(self) -> float:
        """Per-iteration tp volume: every lowering (span, pipeline-unit,
        background fallback) moves exactly this many bytes."""
        return self.n_layers * (self.fwd_bytes + self.bwd)

    # ------------------------------------------------- plan serialization
    def to_tuple(self) -> tuple:
        return (self.n_layers, self.fwd_bytes, self.bwd_bytes,
                self.algo, self.kind)

    @staticmethod
    def from_tuple(t) -> "TPTraffic":
        n_layers, fwd, bwd, algo, kind = t
        return TPTraffic(
            n_layers=int(n_layers), fwd_bytes=float(fwd),
            bwd_bytes=None if bwd is None else float(bwd),
            algo=str(algo), kind=str(kind))

    # -------------------------------------------------- legacy fallback
    def to_background(self, horizon: float) -> tuple[BackgroundTraffic, ...]:
        """The PR-4 periodic-average model of the same traffic: one
        forward job per layer spread evenly over ``horizon``, one backward
        job per layer half a period out of phase.  Total bytes equal the
        dep-coupled lowering exactly (``count`` pins the job count, so the
        engine's own horizon estimate cannot change the volume)."""
        period = horizon / self.n_layers if horizon > 0.0 else 0.0
        out = []
        if self.fwd_bytes > 0.0:
            out.append(BackgroundTraffic(
                TC_TP, self.fwd_bytes, period, algo=self.algo,
                kind=self.kind, offset=0.0, count=self.n_layers))
        if self.bwd > 0.0:
            out.append(BackgroundTraffic(
                TC_TP, self.bwd, period, algo=self.algo, kind=self.kind,
                offset=0.5 * period, count=self.n_layers))
        return tuple(out)


def balanced_spans(busy_after: list, n: int) -> list[int]:
    """Split a serialized pop order into ``n`` contiguous, busy-balanced
    spans; returns the exclusive end index of each span.

    ``busy_after`` is the cumulative compute-busy vector of the serialized
    schedule (``UnifiedResult.busy_after``).  This is the pipeline stage
    bisection extracted verbatim from the PR-6 ``pipeline_inputs`` (which
    now delegates here): bisect the cumulative busy at each ``total*(s+1)/n``
    cut, then clamp so every span keeps at least one job, in order.
    Precondition: ``1 <= n <= len(busy_after)``."""
    size = len(busy_after)
    total = busy_after[-1] if busy_after else 0.0
    ends = []
    for s in range(n - 1):
        cut = total * (s + 1) / n
        ends.append(bisect.bisect_left(busy_after, cut) + 1)
    ends.append(size)
    # every span keeps at least one job, in order
    for s in range(n):
        lo = (ends[s - 1] if s else 0) + 1
        hi = size - (n - 1 - s)
        ends[s] = min(max(ends[s], lo), hi)
    return ends


def couple_tp(compute: list[ComputeJob], ends: list[int], tp: TPTraffic,
              next_id: int):
    """Dep-couple per-span TP collectives into a chained compute job list.

    ``compute`` must already be dep-chained in execution order (job ``i+1``
    deps on job ``i`` — the coupled engine's per-stream serialization
    contract); ``ends`` are the span end indices from
    :func:`balanced_spans` (one span per modeled layer).

    Per span ``s``: a forward TP job deps on the span's last compute job
    and the *next* span's first compute job gains a dep on it (forward
    activations block downstream compute); a backward TP job deps on the
    same producer and is returned for the caller to attach to the gradient
    buckets the span provides.  Zero-byte legs are never emitted (the p2p
    rule: the compute chain is already the direct dependency).

    Returns ``(compute, fwd_jobs, bwd_jobs, next_id)`` where
    ``bwd_jobs[s]`` is span ``s``'s backward job (lists are empty when the
    respective volume is zero).
    """
    fwd_jobs: list[CommJob] = []
    bwd_jobs: list[CommJob] = []
    if not compute or (tp.fwd_bytes <= 0.0 and tp.bwd <= 0.0):
        return compute, fwd_jobs, bwd_jobs, next_id
    out = list(compute)
    for s, e in enumerate(ends):
        producer = out[e - 1].job_id
        if tp.fwd_bytes > 0.0:
            job = CommJob(bucket=s, ready=0.0, nbytes=tp.fwd_bytes,
                          algo=tp.algo, kind=tp.kind, job_id=next_id,
                          deps=(producer,), traffic_class=TC_TP)
            next_id += 1
            fwd_jobs.append(job)
            if e < len(out):
                nxt = out[e]
                out[e] = dataclasses.replace(
                    nxt, deps=nxt.deps + (job.job_id,))
        if tp.bwd > 0.0:
            job = CommJob(bucket=s, ready=0.0, nbytes=tp.bwd,
                          algo=tp.algo, kind=tp.kind, job_id=next_id,
                          deps=(producer,), traffic_class=TC_TP)
            next_id += 1
            bwd_jobs.append(job)
    return out, fwd_jobs, bwd_jobs, next_id


def couple_tp_pipeline(compute: list[ComputeJob], sched, tp: TPTraffic,
                       next_id: int):
    """Dep-couple per-unit TP collectives into a lowered 1F1B job list.

    Every (stage, microbatch, fwd/bwd) unit covers ``n_layers / (S * v)``
    layers for one microbatch, so its TP job carries
    ``layer_bytes * n_layers / (S * v * M)`` — summed over all units the
    total tp volume equals :attr:`TPTraffic.total_bytes` exactly (byte
    conservation against the background fallback).  Synchronous TP blocks
    the device until the collective completes: each unit's TP job deps on
    the unit and the device's *next* unit in 1F1B issue order deps on the
    TP job.  The last backward unit's TP job per stage is returned in
    ``grad_gate`` — it replaces ``last_bwd[s]`` as the stage's
    gradient-readiness gate.  Zero-byte legs are never emitted.

    Returns ``(compute, tp_jobs, grad_gate, next_id)``; ``grad_gate`` is
    ``None`` when there is no backward volume (buckets keep their
    ``last_bwd`` gates).
    """
    S = sched.n_stages
    M = sched.n_microbatches
    v = sched.chunks_per_stage
    per_unit = tp.n_layers / float(S * v * M)
    fb = tp.fwd_bytes * per_unit
    bb = tp.bwd * per_unit
    if fb <= 0.0 and bb <= 0.0:
        return compute, [], None, next_id
    tp_jobs: list[CommJob] = []
    tp_of: dict[int, int] = {}   # unit job_id -> its TP job id
    grad_gate: list | None = [None] * S if bb > 0.0 else None
    for u in compute:
        nb = fb if u.kind == "fwd" else bb
        if nb <= 0.0:
            continue
        job = CommJob(bucket=u.stream, ready=0.0, nbytes=nb, algo=tp.algo,
                      kind=tp.kind, job_id=next_id, deps=(u.job_id,),
                      traffic_class=TC_TP)
        next_id += 1
        tp_jobs.append(job)
        tp_of[u.job_id] = job.job_id
        if u.kind == "bwd" and grad_gate is not None:
            # units arrive in issue order, so the last write per stage is
            # the stage's final backward — the gradient gate
            grad_gate[u.stream] = job.job_id
    # the device cannot start its next unit before the previous unit's
    # collective completed (synchronous TP occupies the device)
    out: list[ComputeJob] = []
    prev_tp: dict[int, int | None] = {}
    for u in compute:
        d = prev_tp.get(u.stream)
        if d is not None:
            u = dataclasses.replace(u, deps=u.deps + (d,))
        prev_tp[u.stream] = tp_of.get(u.job_id)
        out.append(u)
    return out, tp_jobs, grad_gate, next_id
