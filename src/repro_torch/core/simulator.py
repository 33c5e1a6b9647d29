"""End-to-end HLO execution-time simulator (paper Sec. 4.4).

Replays a :class:`FusionGraph` on one device:

* one serialized **compute stream** — a FIFO ready queue of fused ops; a
  ready op starts at ``max(device_free, preds done)``;
* one serialized **communication channel** — AllReduce buckets start when
  (a) every gradient in the bucket has been produced (its provider group is
  done) and (b) the channel is clear; communication overlaps compute.

Per-iteration time = max(last compute completion, last AllReduce completion).
The FO (full-overlap) bound is ``max(total_compute, total_comm)`` — maximal
overlap ignoring dependencies (paper Sec. 6.2).

The communication channel is priced by the phase-level event engine
(:mod:`repro_torch.core.events`): with the default ``streams=1`` it is the
serialized channel above, bit-identical to the seed; with ``streams > 1``
buckets pipeline their per-link-level phases concurrently under fair-share
bandwidth division (DESIGN.md Sec. 8).

Incremental (delta) cost evaluation
-----------------------------------

``Simulator`` memoises the full schedule of every graph it replays (pop
order, per-group completion times, running busy time) in an LRU keyed by a
state token stamped onto the graph.  A mutated clone carries a *journal* of
mutations relative to its ancestor's token (see :mod:`repro_torch.core.graph`),
and ``run()`` re-simulates only the suffix of the schedule the journal can
affect:

* The compute stream is serialized and the pop order is independent of op
  times, so the schedule prefix up to the *divergence bound* ``k`` is reused
  verbatim.  ``k`` is the earliest position at which any group removed by
  the journal was popped, or at which a journal-created group could first
  have been popped (one past the max position of its quotient
  predecessors) — before ``k`` the old and new ready heaps pop identically.
* From ``k`` the replay continues with the maintained quotient: remaining
  in-degrees are counted against the already-popped prefix, completion
  times accumulate from the cached prefix sums, and AllReduce bucket
  readiness is re-derived as the max completion over each bucket's provider
  groups.  Floating-point accumulation order matches the full replay, so
  delta results are **bit-identical** to a from-scratch run.
* Tensor-fusion (bucket) and collective-algorithm mutations never perturb
  the compute stream: only the O(B log B) communication pass is recomputed.

The delta path **falls back to full replay** whenever it would not be
exact: no cached ancestor state (evicted or never simulated), a journal
longer than ``max_journal``, a timeline request, or any inconsistency
detected while replaying (missing groups, cyclic quotient).  ``Simulator.stats``
counts full/delta/fallback evaluations.  Construct with
``incremental=False`` for the seed full-replay-only behaviour (the golden
equivalence tests run both paths and assert identical results).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import OrderedDict

from ..cluster import (COLLECTIVE_ALGOS, ClusterSpec, KIND_AR, KIND_RS_AG,
                       comm_coeffs, overlap_discount_for, phases)
from .costs import OracleEstimator, total_comm_time, total_compute_time
from .events import (BackgroundTraffic, CommJob, ComputeJob, EventEngine,
                     TC_COMPUTE, TC_DP, TC_PP, TC_TP, bucket_jobs)
from .graph import FusionGraph
from .hw import H100_SXM, Hardware
from .tp_traffic import (TPTraffic, balanced_spans, couple_tp,
                         couple_tp_pipeline)

_token_counter = itertools.count(1)


@dataclasses.dataclass
class SimResult:
    iteration_time: float
    compute_time: float          # sum of fused-op times (busy compute)
    comm_time: float             # sum of AllReduce times (busy channel)
    compute_finish: float
    comm_finish: float
    overlap_ratio: float         # (compute_time+comm_time)/iteration_time
    timeline: list | None = None
    # pipeline-schedule runs only: bubble / per-stage occupancy stats
    # (None for the default single-device replay)
    pipeline: dict | None = None
    # dep-coupled TP-traffic runs only (Simulator(tp=...)): lowering mode,
    # per-layer volumes and tp-class busy/finish tallies (DESIGN.md Sec. 14)
    tp: dict | None = None


@dataclasses.dataclass
class _SimState:
    """Cached schedule of one full/delta replay (delta-resume substrate)."""
    order: list            # gids in pop order
    done_at: dict          # gid -> completion time
    busy_after: list       # cumulative compute-busy after each pop
    times: dict            # gid -> fused-op time (gids are never reused
    #                        across a state's descendants, so these stay
    #                        valid for every journal that resumes from it)
    result: SimResult
    _pos: dict | None = None

    @property
    def pos(self) -> dict:
        # built lazily: about half of all states are never resumed from
        if self._pos is None:
            self._pos = {gid: i for i, gid in enumerate(self.order)}
        return self._pos


class Simulator:
    """Cost model Cost(H) driving the backtracking search."""

    def __init__(self, estimator=None, hw: Hardware = H100_SXM, n_devices: int = 256,
                 keep_timeline: bool = False, incremental: bool = True,
                 state_cache_size: int = 64, max_journal: int = 24,
                 cluster: ClusterSpec | None = None, streams: int = 1,
                 background: tuple = (), pipeline=None,
                 overlap_discount: float | None = None,
                 tp: TPTraffic | None = None,
                 level_chunks: bool = False):
        self.estimator = estimator or OracleEstimator(hw)
        self.hw = hw
        # legacy (hw, n_devices) maps to the flat back-compat spec — comm
        # times stay bit-identical to the seed's allreduce_time model.  A
        # real ClusterSpec overrides n_devices and prices each bucket by its
        # chosen collective algorithm (DESIGN.md Sec. 7).
        if cluster is None:
            cluster = ClusterSpec.flat(hw, n_devices)
        else:
            n_devices = cluster.n_devices
        self.cluster = cluster
        self.n_devices = n_devices
        # the comm pass is the phase-level event engine; streams=1 is the
        # serialized channel, bit-identical to the seed (DESIGN.md Sec. 8).
        # Every collective model is linear in bytes: resolve the (C, D)
        # pairs per (algo, comm-kind) once so the hot serialized pass stays
        # a dict hit + multiply-add (no per-bucket job objects).
        self.streams = max(int(streams), 1)
        # recurring TP/PP collectives (BackgroundTraffic) injected alongside
        # the gradient buckets on multi-stream sims: searched strategies are
        # priced under fabric contention from non-gradient traffic
        # (DESIGN.md Sec. 9).  Ignored on the serialized channel, which is
        # the seed model and must stay bit-identical.
        self.background: tuple[BackgroundTraffic, ...] = tuple(background)
        # a PipelineSchedule routes run() through the coupled engine path
        # (_run_pipeline): fused groups are split into stages, lowered to
        # 1F1B compute+p2p job graphs, and priced together with the
        # gradient buckets (DESIGN.md Sec. 11).  None = the paper's
        # single-device replay.
        self.pipeline = pipeline
        # a TPTraffic promotes tensor-parallel activation collectives from
        # periodic BackgroundTraffic averages to first-class scheduled jobs
        # dep-coupled to the compute that produces and consumes them
        # (DESIGN.md Sec. 14): span-lowered on the single-device replay
        # (_run_tp), per-1F1B-unit under a pipeline schedule.  Ignored on
        # the serialized channel (streams=1), like background traffic —
        # the seed model stays bit-identical.
        self.tp = tp
        # in-kernel fusion overlap discount (DESIGN.md Sec. 13): how far a
        # fused bucket's collective reaches back into its producing compute
        # job's tail, as a fraction of the producer's duration.  Resolved
        # from the per-preset calibration table (0.0 on flat/uncalibrated
        # specs, where fused buckets price exactly as their base kind and
        # METHOD_FUSED drops out of the search).
        if overlap_discount is None:
            overlap_discount = overlap_discount_for(cluster)
        self.overlap_discount = float(overlap_discount)
        # per-level chunk sizing (DESIGN.md Sec. 14): opt-in, off keeps
        # uniform chunk_phases schedules bit-identical to the default
        self.level_chunks = bool(level_chunks)
        self._engine = EventEngine(cluster, streams=self.streams,
                                   level_chunks=self.level_chunks)
        self._ar_coeffs = {
            algo: comm_coeffs(cluster, algo, KIND_AR)
            for algo in COLLECTIVE_ALGOS
        }
        self._rs_ag_coeffs = {
            algo: comm_coeffs(cluster, algo, KIND_RS_AG)
            for algo in COLLECTIVE_ALGOS
        }
        self.keep_timeline = keep_timeline
        self.incremental = incremental
        self.max_journal = max_journal
        self._states: OrderedDict[int, _SimState] = OrderedDict()
        self._state_cache_size = state_cache_size
        self.stats = {"full": 0, "delta": 0, "cached": 0, "fallback": 0}

    def cost(self, g: FusionGraph) -> float:
        return self.run(g).iteration_time

    def run(self, g: FusionGraph) -> SimResult:
        if self.pipeline is not None:
            # multi-stream coupled schedule: the pop-order prefix argument
            # behind delta resume does not hold, so pipeline pricing is
            # always a full (non-incremental) replay
            self.stats["full"] += 1
            return self._run_pipeline(g)
        if self.tp is not None and self.streams > 1:
            # dep-coupled TP jobs add comm->compute edges, so the pop-order
            # prefix argument behind delta resume does not hold either:
            # always a full replay
            self.stats["full"] += 1
            return self._run_tp(g)
        if not self.incremental:
            return self._run_full(g, record=False).result
        base = None
        if g._base_token is not None:
            base = self._states.get(g._base_token)
            if base is not None:
                self._states.move_to_end(g._base_token)
        if base is not None and not g._journal:
            # a keep_timeline sim only ever remembers timeline-carrying
            # states, so the cached result can be returned as-is
            self.stats["cached"] += 1
            return base.result
        state = None
        if base is not None and len(g._journal) <= self.max_journal:
            state = self._run_delta(g, base)
            if state is None:
                self.stats["fallback"] += 1
        if state is None:
            state = self._run_full(g, record=True)
            self.stats["full"] += 1
        else:
            self.stats["delta"] += 1
        self._remember(g, state)
        return state.result

    # ------------------------------------------------------------ full path
    def _compute_jobs(self, g: FusionGraph):
        """Fused groups as engine compute jobs: ``job_id = ~gid`` (compute
        ids are negative by convention), ``key`` the serialized pop-order
        tie-break, ``deps`` the quotient predecessors.  Returns
        ``(jobs, times)`` with ``times`` the per-gid durations (the
        ``_SimState.times`` cache)."""
        _, preds = g.quotient()
        key = g._group_key
        group_time = self.estimator.group_time
        times: dict[int, float] = {}
        jobs = []
        for gid in g.groups:
            t = group_time(g, gid)
            times[gid] = t
            # (content key, gid): duplication-allowed fusion means min
            # member pids can tie across groups; the key's members and
            # provided pids break that tie by content (graph.py), and the
            # gid only makes the key unique
            jobs.append(ComputeJob(
                ref=gid, duration=t, job_id=~gid, key=(key[gid], gid),
                deps=tuple(~p for p in preds[gid])))
        return jobs, times

    def _grad_jobs(self, g: FusionGraph):
        """Gradient buckets as dependency-carrying comm jobs: bucket ``i``
        deps on the compute jobs of its provider groups (the engine derives
        readiness — no ``bucket_waiting`` side-channel).  Zero-byte buckets
        are skipped in both channel models: nothing transfers, so no
        latency is charged (streams=1 parity with the seed comm pass).
        ``streams=1`` keeps whole-bucket jobs (the serialized channel
        ignores chunking, as the seed did); ``streams > 1`` applies the
        chunk decomposition.  Returns ``(jobs, next_id)``."""
        algos = g.bucket_algos
        kinds = g.bucket_comm
        buckets = g.buckets
        deps_of = g.bucket_deps()
        jobs = []
        next_id = len(buckets)
        if self.streams == 1:
            for i in range(len(buckets)):
                nbytes = g.bucket_bytes(buckets[i])
                if nbytes <= 0.0:
                    continue
                jobs.append(CommJob(
                    bucket=i, ready=0.0, nbytes=nbytes, algo=algos[i],
                    kind=kinds[i], deps=tuple(~p for p in deps_of[i])))
            return jobs, next_id
        chunks = g.bucket_chunks
        fused = g.bucket_fused
        disc = self.overlap_discount
        for i in range(len(buckets)):
            nbytes = g.bucket_bytes(buckets[i])
            if nbytes <= 0.0:
                continue
            js, next_id = bucket_jobs(i, 0.0, nbytes, algos[i], kinds[i],
                                      chunks[i], next_id,
                                      deps=tuple(~p for p in deps_of[i]),
                                      discount=disc if fused[i] else 0.0)
            jobs.extend(js)
        return jobs, next_id

    def _run_full(self, g: FusionGraph, record: bool) -> _SimState:
        compute, times = self._compute_jobs(g)
        comm, next_id = self._grad_jobs(g)
        timeline = [] if self.keep_timeline else None
        bg = self.background if self.streams > 1 else ()
        try:
            u = self._engine.run_unified(compute, comm, timeline,
                                         background=bg, bg_base_id=next_id)
        except RuntimeError as e:
            raise RuntimeError("cyclic fusion graph in simulator") from e
        result = self._make_result(u.compute_busy, u.comm_busy,
                                   u.compute_finish, u.comm_finish, timeline)
        if not record:
            return _SimState(order=[], done_at={}, busy_after=[], times={},
                             result=result)
        return _SimState(order=u.order, done_at=u.done_at,
                         busy_after=u.busy_after, times=times, result=result)

    # -------------------------------------------------------- pipeline path
    def pipeline_inputs(self, g: FusionGraph) -> dict:
        """Derive the 1F1B lowering's inputs from the fused graph: the
        serialized single-device schedule is bisected into ``n_stages``
        contiguous, busy-balanced spans; each span's time splits into
        per-microbatch fwd/bwd unit durations by ``fwd_bwd_ratio``; the
        stage-boundary p2p volume defaults to the mean activation
        (out_bytes) of the groups at the stage cuts, per microbatch.

        The schedule is the base ``self.pipeline`` with the graph's
        searched ``pp_knobs`` overrides resolved onto it
        (:func:`repro_torch.core.pipeline.resolve_schedule`)."""
        sched = self._resolve_pipeline(g)
        compute, _ = self._compute_jobs(g)
        u = self._engine.run_unified(compute, [])
        S = sched.n_stages
        if S > len(u.order):
            raise ValueError(f"n_stages={S} exceeds {len(u.order)} fused "
                             "groups — nothing to split")
        ends = balanced_spans(u.busy_after, S)
        group_stage: dict[int, int] = {}
        stage_busy = []
        stage_groups = []
        prev = 0
        for s in range(S):
            hi = ends[s]
            for gid in u.order[prev:hi]:
                group_stage[gid] = s
            lo_busy = u.busy_after[prev - 1] if prev else 0.0
            stage_busy.append(u.busy_after[hi - 1] - lo_busy)
            stage_groups.append(hi - prev)
            prev = hi
        M = sched.n_microbatches
        r = sched.fwd_bwd_ratio
        stage_fwd = [b / M * (r / (1.0 + r)) for b in stage_busy]
        stage_bwd = [b / M - f for b, f in zip(stage_busy, stage_fwd)]
        if sched.p2p_bytes is not None:
            pbytes = sched.p2p_bytes
        else:
            outs = []
            for s in range(S - 1):
                boundary_gid = u.order[ends[s] - 1]
                outs.append(sum(g.prims[p].out_bytes
                                for p in g.groups[boundary_gid]))
            pbytes = (sum(outs) / len(outs) / M) if outs else 0.0
        return {"group_stage": group_stage, "stage_busy": stage_busy,
                "stage_groups": stage_groups, "stage_fwd": stage_fwd,
                "stage_bwd": stage_bwd, "p2p_bytes": pbytes}

    def _resolve_pipeline(self, g: FusionGraph):
        """The base schedule with ``g.pp_knobs`` overrides applied (clamped
        to this graph's group count — the stage bisection needs at least
        one group per stage)."""
        from .pipeline import resolve_schedule
        return resolve_schedule(self.pipeline, getattr(g, "pp_knobs", None),
                                len(g.groups))

    def _run_pipeline(self, g: FusionGraph) -> SimResult:
        from .pipeline import bubble_stats, lower_schedule
        sched = self._resolve_pipeline(g)
        pi = self.pipeline_inputs(g)
        buckets = g.buckets
        chunks = g.bucket_chunks
        nb = [g.bucket_bytes(b) for b in buckets]
        # id layout: buckets 0..B-1, then chunk jobs, then p2p, then
        # background — count the chunk ids before lowering allocates p2p's
        cid = len(buckets)
        for i in range(len(buckets)):
            if nb[i] > 0.0 and chunks[i] > 1:
                cid += chunks[i]
        cjobs, p2p, last_bwd, bg_base = lower_schedule(
            sched, pi["stage_fwd"], pi["stage_bwd"], pi["p2p_bytes"],
            next_id=cid)
        # dep-coupled TP activation traffic (DESIGN.md Sec. 14): each
        # (stage, microbatch, fwd/bwd) unit carries its share of the
        # per-layer collectives; synchronous TP blocks the device's next
        # unit, and the last backward unit's collective replaces
        # last_bwd[s] as the stage's gradient gate
        tp_jobs: list = []
        if self.tp is not None:
            cjobs, tp_jobs, grad_gate, bg_base = couple_tp_pipeline(
                cjobs, sched, self.tp, bg_base)
            if grad_gate is not None:
                last_bwd = [grad_gate[s] if grad_gate[s] is not None
                            else last_bwd[s] for s in range(sched.n_stages)]
        # gradient buckets dep on the *last backward unit* of every stage
        # that provides them: that is when the stage's gradient
        # accumulation over all microbatches completes
        group_stage = pi["group_stage"]
        deps_of = g.bucket_deps()
        algos = g.bucket_algos
        kinds = g.bucket_comm
        comm = []
        next_id = len(buckets)
        for i in range(len(buckets)):
            if nb[i] <= 0.0:
                continue
            stages = sorted({group_stage[p] for p in deps_of[i]})
            bdeps = tuple(last_bwd[s] for s in stages)
            # fused buckets are priced conservatively (no overlap discount)
            # under a pipeline schedule: the coupled fluid scheduler cannot
            # know a dep's finish ahead of service, so early-ready has no
            # exact seam there (DESIGN.md Sec. 13)
            js, next_id = bucket_jobs(i, 0.0, nb[i], algos[i], kinds[i],
                                      chunks[i], next_id, deps=bdeps)
            comm.extend(js)
        timeline = [] if self.keep_timeline else None
        u = self._engine.run_unified(cjobs, comm + p2p + tp_jobs, timeline,
                                     background=self.background,
                                     bg_base_id=bg_base)
        info = {
            "schedule": sched.schedule,
            "n_stages": sched.n_stages,
            "n_microbatches": sched.n_microbatches,
            "interleave": sched.chunks_per_stage,
            "stage_busy_s": pi["stage_busy"],
            "stage_groups": pi["stage_groups"],
            "bubble": bubble_stats(sched, pi["stage_busy"],
                                   u.compute_finish),
            "p2p_bytes": pi["p2p_bytes"],
            "p2p_busy_s": self._engine.class_busy.get(TC_PP, 0.0),
            "pp_knobs": g.pp_knobs,
        }
        tp_info = None
        if self.tp is not None:
            tp_info = {
                "mode": "pipeline-unit",
                "n_layers": self.tp.n_layers,
                "fwd_bytes": self.tp.fwd_bytes,
                "bwd_bytes": self.tp.bwd,
                "jobs": len(tp_jobs),
                "tp_busy_s": self._engine.class_busy.get(TC_TP, 0.0),
                "tp_finish_s": self._engine.class_finish.get(TC_TP, 0.0),
            }
        it = u.finish
        return SimResult(
            iteration_time=it,
            # per-device busy sums: with S stages compute_time can exceed
            # the iteration (distinct devices are busy concurrently)
            compute_time=u.compute_busy,
            comm_time=u.comm_busy,
            compute_finish=u.compute_finish,
            comm_finish=u.comm_finish,
            overlap_ratio=(u.compute_busy + u.comm_busy) / it if it > 0
            else 1.0,
            timeline=timeline,
            pipeline=info,
            tp=tp_info,
        )

    # ------------------------------------------------------------- TP path
    def _run_tp(self, g: FusionGraph) -> SimResult:
        """Price the graph under dep-coupled TP activation traffic
        (DESIGN.md Sec. 14).

        The serialized schedule is re-emitted as an explicitly chained job
        list (the coupled engine's per-stream serialization contract: pop
        order is a linear extension of the quotient deps, so chaining it
        preserves the schedule), split into ``tp.n_layers`` busy-balanced
        spans by the same bisection the pipeline stage split uses, and
        per-span collectives are coupled in: forward TP jobs gate the next
        span's first compute job, backward TP jobs gate the gradient
        buckets of the groups their span provides.  Iteration time keeps
        the background-model convention — gated by compute and gradient
        sync; TP traffic matters through the contention and compute delays
        it causes (tallies reported in ``SimResult.tp``).  Fused buckets
        are priced conservatively (no overlap discount) on the coupled
        scheduler, as under a pipeline schedule."""
        tp = self.tp
        compute, times = self._compute_jobs(g)
        u = self._engine.run_unified(compute, [])
        order = u.order
        L = max(1, min(tp.n_layers, len(order)))
        ends = balanced_spans(u.busy_after, L)
        chained = []
        prev = None
        for idx, gid in enumerate(order):
            chained.append(ComputeJob(
                ref=gid, duration=times[gid], job_id=~gid, key=(idx,),
                deps=() if prev is None else (prev,)))
            prev = ~gid
        # id layout: buckets 0..B-1, then chunk jobs, then TP jobs, then
        # background (mirrors _run_pipeline)
        buckets = g.buckets
        chunks = g.bucket_chunks
        nb = [g.bucket_bytes(b) for b in buckets]
        cid = len(buckets)
        for i in range(len(buckets)):
            if nb[i] > 0.0 and chunks[i] > 1:
                cid += chunks[i]
        chained, fwd_jobs, bwd_jobs, bg_base = couple_tp(chained, ends, tp,
                                                         cid)
        # provider group -> span, for backward gating of the buckets
        span_of: dict[int, int] = {}
        prev_e = 0
        for s, e in enumerate(ends):
            for gid in order[prev_e:e]:
                span_of[gid] = s
            prev_e = e
        deps_of = g.bucket_deps()
        algos = g.bucket_algos
        kinds = g.bucket_comm
        comm = []
        next_id = len(buckets)
        for i in range(len(buckets)):
            if nb[i] <= 0.0:
                continue
            bdeps = [~p for p in deps_of[i]]
            if bwd_jobs:
                # gradients are ready only once the producing spans'
                # backward TP collectives completed
                bdeps.extend(bwd_jobs[s].job_id for s in
                             sorted({span_of[p] for p in deps_of[i]}))
            js, next_id = bucket_jobs(i, 0.0, nb[i], algos[i], kinds[i],
                                      chunks[i], next_id, deps=tuple(bdeps))
            comm.extend(js)
        timeline = [] if self.keep_timeline else None
        u2 = self._engine.run_unified(chained, comm + fwd_jobs + bwd_jobs,
                                      timeline, background=self.background,
                                      bg_base_id=bg_base)
        result = self._make_result(u2.compute_busy, u2.comm_busy,
                                   u2.compute_finish, u2.comm_finish,
                                   timeline)
        result.tp = {
            "mode": "span",
            "n_layers": L,
            "fwd_bytes": tp.fwd_bytes,
            "bwd_bytes": tp.bwd,
            "jobs": len(fwd_jobs) + len(bwd_jobs),
            "tp_busy_s": self._engine.class_busy.get(TC_TP, 0.0),
            "tp_finish_s": self._engine.class_finish.get(TC_TP, 0.0),
        }
        return result

    # ----------------------------------------------------------- delta path
    def _run_delta(self, g: FusionGraph, base: _SimState) -> _SimState | None:
        """Exact suffix replay from the journal's divergence bound; returns
        None when the delta is invalid (caller falls back to full replay)."""
        if getattr(self.estimator, "comm_sensitive", False) \
                and any(rec[0] != "fuse" for rec in g._journal):
            # bucket-dimension mutations (algo/comm/chunk/merge) change a
            # comm-sensitive estimator's fused-op predictions, so cached
            # group times from the ancestor schedule are stale
            return None
        n_base = len(base.order)
        k = n_base
        pos = base.pos
        for rec in g._journal:
            if rec[0] != "fuse":
                continue
            _, removed, _new_gid, new_preds = rec
            for x in removed:
                p = pos.get(x)
                if p is not None:
                    k = min(k, p)
            known = [pos[x] for x in new_preds if x in pos]
            k = min(k, (max(known) + 1) if known else 0)

        succs, preds = g.quotient()
        prefix = base.order[:k]
        popped = set(prefix)
        groups = g.groups
        for gid in prefix:
            if gid not in groups:
                return None  # journal/state mismatch
        done_at = dict(base.done_at)
        remaining = [gid for gid in groups if gid not in popped]
        indeg: dict[int, int] = {}
        for gid in remaining:
            c = 0
            for x in preds[gid]:
                if x not in popped:
                    c += 1
            indeg[gid] = c
        key = g._group_key
        ready = [(key[gid], gid) for gid in remaining if indeg[gid] == 0]
        heapq.heapify(ready)
        device_free = done_at[prefix[-1]] if k > 0 else 0.0
        compute_busy = base.busy_after[k - 1] if k > 0 else 0.0
        order = list(prefix)
        busy_after = base.busy_after[:k]
        times = dict(base.times)
        group_time = self.estimator.group_time
        while ready:
            _, gid = heapq.heappop(ready)
            # a surviving gid always denotes the same fused group, so its
            # cached time from the base schedule is still exact
            t = times.get(gid)
            if t is None:
                t = group_time(g, gid)
                times[gid] = t
            end = device_free + t
            done_at[gid] = end
            device_free = end
            compute_busy += t
            order.append(gid)
            busy_after.append(compute_busy)
            for d in succs[gid]:
                if d in indeg:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        heapq.heappush(ready, (key[d], d))
        if len(order) != len(groups):
            return None  # cyclic or inconsistent — let the full path decide

        bucket_ready_at: dict[int, float] = {}
        fused = g.bucket_fused
        disc = self.overlap_discount if self.streams > 1 else 0.0
        for i, b in enumerate(g.buckets):
            provs = g.bucket_ready_groups(b)
            try:
                if disc > 0.0 and fused[i]:
                    # in-kernel fusion: ready reaches discount x duration
                    # back into each provider's tail — same subtraction the
                    # unified engine applies per dep, so delta stays
                    # bit-identical to the full path (max is arithmetic-free)
                    bucket_ready_at[i] = max(done_at[x] - disc * times[x]
                                             for x in provs)
                else:
                    bucket_ready_at[i] = max(done_at[x] for x in provs)
            except KeyError:
                return None
        timeline = None
        if self.keep_timeline:
            # reconstruct the serialized compute records the full path
            # would emit: on one stream each pop starts where the previous
            # ended, so the chained starts are bit-exact (never derived by
            # subtraction, which would not be)
            timeline = []
            prev = 0.0
            for gid in order:
                end = done_at[gid]
                timeline.append(("compute", gid, prev, end, TC_COMPUTE,
                                 "stream0", prev, end))
                prev = end
        comm_busy, comm_finish = self._comm_pass(g, bucket_ready_at, timeline,
                                                 horizon=device_free)
        compute_finish = device_free if order else 0.0
        result = self._make_result(compute_busy, comm_busy, compute_finish,
                                   comm_finish, timeline)
        # stale (removed-gid) entries are harmless — gids are never reused
        # within a lineage — but prune once they dominate the dicts
        if len(done_at) > 2 * len(groups):
            done_at = {gid: done_at[gid] for gid in groups}
            times = {gid: times[gid] for gid in groups}
        return _SimState(order=order, done_at=done_at,
                         busy_after=busy_after, times=times, result=result)

    # -------------------------------------------------------------- shared
    def _comm_pass(self, g: FusionGraph, bucket_ready_at: dict[int, float],
                   timeline: list | None,
                   horizon: float = 0.0) -> tuple[float, float]:
        # communication: buckets transfer in order of readiness (paper: "in
        # order of production of their respective gradient tensors").
        algos = g.bucket_algos
        kinds = g.bucket_comm
        buckets = g.buckets
        if self.streams > 1:
            # phase-level event engine: per-link-level pipelining with
            # fair-share contention (DESIGN.md Sec. 8).  A bucket with
            # chunks > 1 becomes a store-and-forward chain of chunk jobs
            # (chunk c may not start a phase before chunk c-1 finished it);
            # recurring TP/PP background traffic contends on the same
            # levels over the compute horizon (DESIGN.md Sec. 9).
            chunks = g.bucket_chunks
            fused = g.bucket_fused
            disc = self.overlap_discount
            jobs = []
            next_id = len(buckets)
            for i, r in bucket_ready_at.items():
                nbytes = g.bucket_bytes(buckets[i])
                if nbytes <= 0.0:
                    continue  # nothing to transfer: no latency D charged
                # a fused bucket's ready was already discounted into the
                # producer tail by the caller; the discount is re-stamped
                # on the jobs so their phases carry the fused_* tags (the
                # deps are resolved, so no second subtraction happens)
                js, next_id = bucket_jobs(i, r, nbytes,
                                          algos[i], kinds[i], chunks[i],
                                          next_id,
                                          discount=disc if fused[i] else 0.0)
                jobs.extend(js)
            if self.background:
                for traffic in self.background:
                    bjobs = traffic.materialize(horizon, next_id)
                    next_id += len(bjobs)
                    jobs.extend(bjobs)
                self._engine.run(jobs, timeline)
                # iteration time is gated by gradient sync; background
                # traffic only matters through the contention it causes
                return (self._engine.class_busy.get(TC_DP, 0.0),
                        self._engine.class_finish.get(TC_DP, 0.0))
            return self._engine.run(jobs, timeline)
        # streams=1 hot path: the serialized channel inline, identical to
        # CommEngine(streams=1) without per-bucket job objects — and
        # bit-identical to the seed's comm pass for all-AllReduce buckets
        chan_free = 0.0
        comm_busy = 0.0
        comm_finish = 0.0
        order = sorted(bucket_ready_at.items(), key=lambda kv: (kv[1], kv[0]))
        ar_coeffs = self._ar_coeffs
        rs_ag_coeffs = self._rs_ag_coeffs
        for i, ready_t in order:
            nbytes = g.bucket_bytes(buckets[i])
            if nbytes <= 0.0:
                continue  # nothing to transfer: no latency D charged
            kind = kinds[i]
            c, d = (ar_coeffs if kind == KIND_AR else rs_ag_coeffs)[algos[i]]
            t = c * nbytes + d
            start = max(chan_free, ready_t)
            chan_free = start + t
            comm_busy += t
            comm_finish = chan_free
            if timeline is not None:
                timeline.append((
                    "allreduce" if kind == KIND_AR else KIND_RS_AG, i, 0,
                    TC_DP, algos[i], self._engine._chan_level, start,
                    chan_free))
        return comm_busy, comm_finish

    @staticmethod
    def _make_result(compute_busy, comm_busy, compute_finish, comm_finish,
                     timeline) -> SimResult:
        it = max(compute_finish, comm_finish)
        return SimResult(
            iteration_time=it,
            compute_time=compute_busy,
            comm_time=comm_busy,
            compute_finish=compute_finish,
            comm_finish=comm_finish,
            overlap_ratio=(compute_busy + comm_busy) / it if it > 0 else 1.0,
            timeline=timeline,
        )

    def _remember(self, g: FusionGraph, state: _SimState) -> None:
        tok = next(_token_counter)
        self._states[tok] = state
        if len(self._states) > self._state_cache_size:
            self._states.popitem(last=False)
        g._base_token = tok
        g._journal = []

    # ------------------------------------------------------------- FO bound
    def full_overlap_bound(self, g: FusionGraph) -> float:
        """Lower bound on iteration time under maximal overlap.

        The comm floor depends on the channel model: serialized (streams=1)
        communication cannot finish before the sum of all bucket times (the
        seed's ``total_comm_time``, bit-identical); the multi-stream engine
        can pipeline buckets across link levels, but every level still has
        to advance its total phase work at capacity 1 — the floor is the
        busiest level's work sum.  Chunking conserves per-level work
        exactly (per-chunk coefficients sum to the unchunked ones), so the
        unchunked phase sums below stay an exact floor for chunked
        schedules; background TP/PP traffic is excluded (the bound is on
        the gradient traffic the search controls).  In-kernel fused buckets
        conserve link work too — the overlap discount moves a job's start
        earlier, never shrinks its phases — so the same floor holds."""
        comp = total_compute_time(g, self.estimator, self.hw)
        if self.streams == 1:
            comm = total_comm_time(g, cluster=self.cluster)
        else:
            level_work = [0.0] * len(self.cluster.levels)
            for i, b in enumerate(g.buckets):
                nb = g.bucket_bytes(b)
                if nb <= 0.0:
                    continue
                for p in phases(self.cluster, g.bucket_algos[i],
                                g.bucket_comm[i]):
                    level_work[p.level] += p.c * nb + p.d
            comm = max(level_work, default=0.0)
        return max(comp, comm)
