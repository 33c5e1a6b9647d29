"""Pipeline-parallel stage schedules lowered to unified engine jobs
(DESIGN.md Sec. 11).

A :class:`PipelineSchedule` describes a Megatron-style 1F1B (or
interleaved-1F1B) schedule: ``n_stages`` devices, ``n_microbatches``
microbatches per iteration, optionally ``interleave`` virtual-stage chunks
per device.  :func:`lower_schedule` turns it into the job graph the
:class:`~repro_torch.core.events.EventEngine` prices:

* one :class:`~repro_torch.core.events.ComputeJob` per (stage, chunk,
  microbatch, fwd/bwd) unit, placed on compute stream ``s`` and
  dep-chained in the device's 1F1B issue order (warmup fwds, steady
  fwd/bwd pairs, cooldown bwds — warmup depth ``S-1-s``, or
  ``2*(S-1-s) + (v-1)*S`` interleaved);
* one :class:`~repro_torch.core.events.CommJob` of kind ``p2p`` / class ``pp``
  per crossed stage boundary and microbatch (forward activations and
  backward activation-gradients), dep'd on the producing unit and feeding
  the consuming unit's deps — so stage-boundary transfers contend with
  gradient buckets on the shared link levels instead of being modeled as
  blind background noise.

The simulator derives the per-stage unit durations by bisecting its own
serialized single-device schedule into ``n_stages`` contiguous,
busy-balanced spans (``Simulator._run_pipeline``); this module is pure
schedule structure and stays import-light (no torch, loadable by the search
worker pool).

With uniform stage times ``f + b`` and free p2p, the lowered 1F1B
schedule's makespan is the textbook ``(M + S - 1) * (f + b)`` and its
bubble fraction ``(S - 1) / (M + S - 1)`` — asserted by the property
tests.  Compute units display as ``ref = microbatch * REF_MB + chunk``
(the stage is the stream name in the timeline record).
"""
from __future__ import annotations

import dataclasses

from ..cluster.collectives import KIND_P2P
from .events import CommJob, ComputeJob, TC_PP

SCHED_1F1B = "1f1b"
SCHED_INTERLEAVED = "interleaved_1f1b"
SCHEDULES = (SCHED_1F1B, SCHED_INTERLEAVED)

# compute-unit display encoding: ref = microbatch * REF_MB + chunk
REF_MB = 1000


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """The searched-over PP knobs: stage count, microbatch count, schedule
    family, interleaving depth, and the fwd share of a stage's time.
    ``p2p_bytes`` overrides the simulator's activation-size estimate for
    stage-boundary transfers (bytes per boundary per microbatch)."""
    n_stages: int
    n_microbatches: int
    schedule: str = SCHED_1F1B
    interleave: int = 1
    fwd_bwd_ratio: float = 0.5     # fwd_time / bwd_time
    p2p_bytes: float | None = None

    def __post_init__(self):
        if self.n_stages < 1:
            raise ValueError(f"n_stages must be >= 1, got {self.n_stages}")
        if self.n_microbatches < 1:
            raise ValueError(
                f"n_microbatches must be >= 1, got {self.n_microbatches}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")
        if self.interleave < 1:
            raise ValueError(
                f"interleave must be >= 1, got {self.interleave}")
        if not 0.0 < self.fwd_bwd_ratio:
            raise ValueError("fwd_bwd_ratio must be positive")
        if (self.chunks_per_stage > 1
                and self.n_microbatches % self.n_stages != 0):
            # Megatron's interleaved schedule requires microbatch groups of
            # exactly n_stages to keep the chunk rotation aligned
            raise ValueError("interleaved 1F1B needs n_microbatches divisible"
                             " by n_stages")

    @property
    def chunks_per_stage(self) -> int:
        return self.interleave if self.schedule == SCHED_INTERLEAVED else 1

    # ------------------------------------------------- plan serialization
    def to_tuple(self) -> tuple:
        return (self.n_stages, self.n_microbatches, self.schedule,
                self.interleave, self.fwd_bwd_ratio, self.p2p_bytes)

    @staticmethod
    def from_tuple(t) -> "PipelineSchedule":
        n_stages, n_microbatches, schedule, interleave, ratio, p2p = t
        return PipelineSchedule(
            n_stages=int(n_stages), n_microbatches=int(n_microbatches),
            schedule=str(schedule), interleave=int(interleave),
            fwd_bwd_ratio=float(ratio),
            p2p_bytes=None if p2p is None else float(p2p))


def resolve_schedule(base: PipelineSchedule | None, knobs,
                     n_groups: int) -> PipelineSchedule | None:
    """Apply a graph's searched pipeline-knob overrides onto the
    simulator's base schedule (DESIGN.md Sec. 14).

    ``knobs`` is :attr:`FusionGraph.pp_knobs` — ``None`` or a partial
    ``(n_stages, n_microbatches, interleave)`` tuple whose ``None`` slots
    inherit from ``base``.  Resolution is *total*: rather than rejecting
    invalid combinations mid-search it clamps them to the nearest valid
    schedule —

    * ``n_stages`` is clamped to ``[1, n_groups]`` (the stage bisection
      needs at least one fused group per stage);
    * ``interleave > 1`` requires ``n_microbatches`` divisible by
      ``n_stages`` (Megatron's chunk rotation); otherwise the interleave
      override collapses to 1;
    * the schedule family follows the interleave: ``interleaved_1f1b``
      iff the resolved interleave exceeds 1.

    ``fwd_bwd_ratio`` and ``p2p_bytes`` always come from ``base`` — they
    are measurements, not searched knobs.  With ``knobs=None`` the base is
    returned untouched (bit-identity for every pre-existing caller)."""
    if base is None or not knobs:
        return base
    S, M, v = knobs
    S = base.n_stages if S is None else int(S)
    M = base.n_microbatches if M is None else int(M)
    v = base.chunks_per_stage if v is None else int(v)
    S = max(1, min(S, int(n_groups))) if n_groups >= 1 else 1
    M = max(1, M)
    v = max(1, v)
    if v > 1 and M % S != 0:
        v = 1
    schedule = SCHED_INTERLEAVED if v > 1 else SCHED_1F1B
    if (S == base.n_stages and M == base.n_microbatches
            and v == base.chunks_per_stage and schedule == base.schedule):
        return base
    return dataclasses.replace(base, n_stages=S, n_microbatches=M,
                               schedule=schedule, interleave=v)


def _unit_sequence(sched: PipelineSchedule, s: int):
    """Device ``s``'s issue order as ``(kind, unit_index)`` pairs, kind in
    {"f", "b"}: warmup forwards, steady one-fwd-one-bwd pairs, cooldown
    backwards.  Unit indices count each kind separately, 0..M*v-1."""
    S, M, v = sched.n_stages, sched.n_microbatches, sched.chunks_per_stage
    total = M * v
    if v == 1:
        w = min(S - 1 - s, total)
    else:
        w = min((S - 1 - s) * 2 + (v - 1) * S, total)
    seq = [("f", k) for k in range(w)]
    for k in range(total - w):
        seq.append(("f", w + k))
        seq.append(("b", k))
    for k in range(total - w, total):
        seq.append(("b", k))
    return seq


def _unit_chunk_mb(sched: PipelineSchedule, kind: str,
                   k: int) -> tuple[int, int]:
    """Map device-local unit index ``k`` to (chunk, microbatch).  v == 1 is
    the identity; interleaved rotates through the device's chunks in
    microbatch groups of ``S`` (Megatron), backwards in reverse chunk
    order."""
    S, v = sched.n_stages, sched.chunks_per_stage
    if v == 1:
        return 0, k
    c = (k // S) % v
    if kind == "b":
        c = v - 1 - c
    mb = (k // (S * v)) * S + k % S
    return c, mb


def lower_schedule(sched: PipelineSchedule, stage_fwd: list[float],
                   stage_bwd: list[float], p2p_bytes: float, *,
                   next_id: int = 0):
    """Lower a schedule to engine jobs.

    ``stage_fwd`` / ``stage_bwd``: per-stage whole-stage durations per
    microbatch (split across ``interleave`` chunks).  ``p2p_bytes``: bytes
    per stage-boundary transfer per microbatch.  ``next_id`` allocates the
    (non-negative) p2p comm job ids; compute job ids are negative.

    Returns ``(compute_jobs, p2p_jobs, last_bwd, next_id)`` where
    ``last_bwd[s]`` is the job id of stage ``s``'s final backward unit —
    the point its gradient accumulation completes, which DP bucket jobs
    dep on."""
    S, M, v = sched.n_stages, sched.n_microbatches, sched.chunks_per_stage
    unit_f = [stage_fwd[s] / v for s in range(S)]
    unit_b = [stage_bwd[s] / v for s in range(S)]

    # pass 1: allocate unit job ids in each device's issue order, chained
    # so every stream is serialized
    jid_of: dict[tuple, int] = {}       # (kind, stage, chunk, mb) -> jid
    units: list[dict] = []
    last_bwd = [0] * S
    n = 0
    for s in range(S):
        prev = None
        for kind, k in _unit_sequence(sched, s):
            c, mb = _unit_chunk_mb(sched, kind, k)
            jid = ~n
            n += 1
            jid_of[(kind, s, c, mb)] = jid
            units.append({
                "jid": jid, "kind": kind, "stage": s, "chunk": c, "mb": mb,
                "key": n, "deps": [] if prev is None else [prev],
            })
            prev = jid
            if kind == "b":
                last_bwd[s] = jid

    # pass 2: cross virtual-stage deps — p2p transfers between devices,
    # direct deps within one (S == 1 degenerates to chunk chaining)
    V = S * v
    p2p: list[CommJob] = []

    def cross(src_key, dst_key, boundary):
        nonlocal next_id
        src = jid_of[src_key]
        dst = jid_of[dst_key]
        # same device — or a free transfer: a zero-byte comm job would be
        # pre-finished at t=0 by the engine and sever the chain, so free
        # p2p becomes a direct (instantaneous) dependency instead
        if src_key[1] == dst_key[1] or p2p_bytes <= 0.0:
            _unit(dst)["deps"].append(src)
            return
        job = CommJob(bucket=boundary, ready=0.0, nbytes=p2p_bytes,
                      algo="ring", kind=KIND_P2P, job_id=next_id,
                      deps=(src,), traffic_class=TC_PP)
        next_id += 1
        p2p.append(job)
        _unit(dst)["deps"].append(job.job_id)

    by_jid = {u["jid"]: u for u in units}

    def _unit(jid):
        return by_jid[jid]

    for vs in range(V - 1):
        src_s, src_c = vs % S, vs // S
        dst_s, dst_c = (vs + 1) % S, (vs + 1) // S
        for mb in range(M):
            # forward activations flow up the virtual-stage chain
            cross(("f", src_s, src_c, mb), ("f", dst_s, dst_c, mb), vs)
            # backward activation-gradients flow down it
            cross(("b", dst_s, dst_c, mb), ("b", src_s, src_c, mb), V - 1 + vs)
    # loss turnaround: the top virtual stage's backward needs its forward
    top_s, top_c = (V - 1) % S, (V - 1) // S
    for mb in range(M):
        _unit(jid_of[("b", top_s, top_c, mb)])["deps"].append(
            jid_of[("f", top_s, top_c, mb)])

    compute = [
        ComputeJob(ref=u["mb"] * REF_MB + u["chunk"],
                   duration=(unit_f if u["kind"] == "f" else unit_b)[u["stage"]],
                   job_id=u["jid"], stream=u["stage"], key=u["key"],
                   deps=tuple(u["deps"]),
                   kind="fwd" if u["kind"] == "f" else "bwd")
        for u in units
    ]
    return compute, p2p, last_bwd, next_id


def bubble_stats(sched: PipelineSchedule, stage_busy: list[float],
                 makespan: float) -> dict:
    """Per-stage idle (bubble) time within the compute makespan and the
    aggregate bubble fraction ``1 - sum(busy) / (S * makespan)``."""
    S = sched.n_stages
    bubbles = [max(makespan - b, 0.0) for b in stage_busy]
    denom = S * makespan
    frac = (sum(bubbles) / denom) if denom > 0.0 else 0.0
    return {"per_stage_s": bubbles, "fraction": frac}
