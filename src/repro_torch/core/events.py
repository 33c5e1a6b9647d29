"""Dependency-aware event engine over link levels *and* compute streams
(DESIGN.md Sec. 8-9, 11).

The seed simulator priced communication as one serialized channel: each
bucket's collective was a single opaque interval, FIFO in readiness order.
A first revision replaced that with a phase-level engine — collectives decompose into
per-link-level phases, concurrent phases on one level share its bandwidth —
but jobs were still a flat list of independent transfers, and compute was a
separate hand-rolled loop inside the simulator.  This revision makes the
engine a general dependency-aware scheduler over *both* resource kinds:

* **Compute jobs** (:class:`ComputeJob`) occupy a serialized compute
  stream (``stream{i}``) for ``duration`` seconds; their ``deps`` are the
  quotient predecessors (or, for pipeline schedules, the previous unit on
  the stream plus the stage-boundary p2p transfer).  Compute job-ids are
  negative (``~gid``) so they can never collide with comm job-ids, which
  stay non-negative.  :meth:`EventEngine.run_unified` schedules a compute
  job list and a comm job list as one dependency graph and returns a
  :class:`UnifiedResult`; when no compute job depends on a comm job the
  two resource kinds decouple and the engine runs the exact seed
  arithmetic (serialized compute pop-order loop, then the comm pass).

* **Jobs** (:class:`CommJob`) carry ``deps`` — job-ids that must *finish*
  before the job may start — and a ``traffic_class`` (``dp`` gradient
  bucket / ``tp`` tensor-parallel / ``pp`` pipeline-parallel), so
  non-gradient collectives extracted from the compiled HLO can contend with
  gradient buckets on the same link levels (:class:`BackgroundTraffic`
  turns a recurring TP/PP collective into concrete jobs over a horizon).
* **Chunked store-and-forward** — a job may name an ``after`` predecessor
  (the previous chunk of the same bucket): it may not *start phase p*
  before the predecessor has *finished its phase p*.  Chunks of one fused
  bucket thereby pipeline through the link levels (chunk 1's intra-host
  leg under chunk 0's inter-host leg) without ever overtaking each other —
  the CoCoNet-style dependency-ordered chunk schedule.  Per-chunk phase
  coefficients (:func:`repro_torch.cluster.collectives.chunk_phases`) sum exactly
  to the unchunked ones, so chunking conserves channel work and wins only
  by scheduling.
* **Per-level discipline** — each level serves its contenders either
  **fair-share** (``k`` active phases progress at rate ``1/k`` each; the
  PR-3 fluid model, still the default and bit-identical to it) or **FIFO**
  (one phase at a time, arrival order, full rate).  ``discipline`` is a
  single mode or a ``{level_index: mode}`` mapping.
* ``streams`` bounds how many **distinct DP buckets** are in flight
  (NCCL-channel style); chunks of one bucket share their bucket's slot and
  TP/PP background traffic bypasses the bound (it is not issued by the
  gradient hook).  ``streams=1`` with dependency-free jobs is the
  **serialized channel**, bit-identical to the seed's ``_comm_pass``.

Timeline records are 8-tuples
``(kind, bucket, chunk, traffic_class, algo, level, start, end)``
(``--timeline`` output; see DESIGN.md Sec. 9 for the field semantics).
``record_load=True`` additionally keeps per-level utilisation segments
``(level, t0, t1, work_seconds)`` so tests can assert no oversubscription
from observed progress, not from the prescribed shares.  After ``run()``
the engine exposes ``job_finish`` (jid -> finish time) and per-class
``class_busy`` / ``class_finish`` tallies so callers can gate on gradient
traffic alone while background traffic keeps contending.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

from ..cluster import ClusterSpec
from ..cluster.collectives import (KIND_AR, KIND_RS_AG, chunk_phases,
                                   comm_coeffs, fused_phases,
                                   level_chunk_phases)

# traffic classes a job can belong to
TC_DP = "dp"    # data-parallel gradient bucket (the searched dimension)
TC_TP = "tp"    # tensor-parallel activation collective
TC_PP = "pp"    # pipeline-parallel stage-boundary transfer
TRAFFIC_CLASSES = (TC_DP, TC_TP, TC_PP)
# compute jobs carry their own class so per-class tallies separate device
# occupancy from channel occupancy; deliberately NOT in TRAFFIC_CLASSES,
# which enumerates the *communication* classes background traffic may use
TC_COMPUTE = "compute"

# per-level service disciplines
DISC_FAIR = "fair"
DISC_FIFO = "fifo"
DISCIPLINES = (DISC_FAIR, DISC_FIFO)


@dataclasses.dataclass(frozen=True)
class CommJob:
    """One collective transfer: ready time, volume, how to run it, and its
    position in the dependency structure.

    ``job_id`` defaults to ``bucket`` (the PR-3 identity); chunk jobs and
    background jobs need explicit distinct ids.  ``deps`` are job-ids that
    must have *finished all phases* before this job may start.  ``after``
    is the store-and-forward predecessor: this job may not start its phase
    ``p`` before ``after`` has completed its phase ``p`` (chunks of one
    bucket share a phase sequence, so positions align)."""
    bucket: int
    ready: float
    nbytes: float
    algo: str = "ring"
    kind: str = KIND_AR
    job_id: int | None = None
    deps: tuple[int, ...] = ()
    after: int | None = None
    chunk: int = 0
    chunks: int = 1
    traffic_class: str = TC_DP
    # in-kernel fusion overlap discount (DESIGN.md Sec. 13): > 0 lets this
    # job's effective ready reach ``discount x dep_duration`` back into the
    # tail of each *compute* dep — the fused kernel streams chunks onto the
    # wire before the producer retires.  Link work stays full; only the
    # start moves.  0.0 (every non-fused job) changes nothing.
    discount: float = 0.0

    @property
    def jid(self) -> int:
        return self.bucket if self.job_id is None else self.job_id


@dataclasses.dataclass(frozen=True)
class ComputeJob:
    """One fused-op group (or pipeline fwd/bwd unit) on a serialized
    compute stream.

    ``ref`` is the display identity (the group id, or an encoded
    microbatch/chunk for pipeline units); ``job_id`` must be negative
    (``~gid`` by convention) so compute ids and comm ids share one
    ``deps`` namespace without collisions.  ``key`` orders the serialized
    ready heap and must be unique across one run's compute jobs (the
    simulator passes ``(_group_key, gid)`` — the group's content key,
    min member pid first, since duplication-allowed fusion lets min pids
    collide across groups).  ``deps`` may name both compute and
    comm job-ids; on a single stream with compute-only deps the engine
    reduces to the seed's serialized loop bit-exactly."""
    ref: int
    duration: float
    job_id: int
    stream: int = 0
    key: tuple | int = 0
    deps: tuple[int, ...] = ()
    kind: str = "compute"          # "compute" | "fwd" | "bwd"
    ready: float = 0.0
    traffic_class: str = TC_COMPUTE

    @property
    def jid(self) -> int:
        return self.job_id

    # CommJob-shaped views so the phased scheduler handles both kinds
    # uniformly (sort keys, slot accounting, timeline bookkeeping)
    @property
    def bucket(self) -> int:
        return self.ref

    @property
    def chunk(self) -> int:
        return 0

    @property
    def chunks(self) -> int:
        return 1

    @property
    def algo(self) -> str:
        return ""

    @property
    def after(self) -> None:
        return None

    @property
    def nbytes(self) -> float:
        return self.duration


@dataclasses.dataclass
class UnifiedResult:
    """One unified schedule's outcome: per-resource-kind busy/finish plus
    the serialized compute schedule (pop order, cumulative busy, per-ref
    completion times) that the simulator's delta-resume substrate snapshots
    into a ``_SimState``."""
    compute_busy: float
    compute_finish: float
    comm_busy: float
    comm_finish: float
    finish: float                  # max finish over every job of any kind
    order: list                    # compute refs in pop order
    busy_after: list               # cumulative compute busy after each pop
    done_at: dict                  # compute ref -> completion time


@dataclasses.dataclass(frozen=True)
class BackgroundTraffic:
    """A recurring non-gradient collective: one TP activation AllReduce or
    PP boundary transfer issued every ``period`` seconds starting at
    ``offset``.  ``materialize`` expands it into concrete :class:`CommJob`s
    over a horizon (the iteration's compute span)."""
    traffic_class: str
    nbytes: float
    period: float
    algo: str = "ring"
    kind: str = KIND_AR
    offset: float = 0.0
    count: int | None = None

    # safety cap: a mis-sized period cannot explode the event loop
    MAX_JOBS = 512

    def materialize(self, horizon: float, base_id: int) -> list[CommJob]:
        if self.nbytes <= 0.0:
            return []
        if self.count is not None:
            n = int(self.count)
        elif self.period > 0.0:
            n = int(math.ceil(max(horizon - self.offset, 0.0) / self.period))
        else:
            n = 1
        n = max(min(n, self.MAX_JOBS), 0)
        return [
            CommJob(bucket=-1 - k, ready=self.offset + k * self.period,
                    nbytes=self.nbytes, algo=self.algo, kind=self.kind,
                    job_id=base_id + k, traffic_class=self.traffic_class)
            for k in range(n)
        ]


class _Active:
    """A job in flight: its phase worklist and current-phase progress."""
    __slots__ = ("bucket", "algo", "steps", "idx", "level", "kind",
                 "remaining", "work", "phase_start", "jid", "after",
                 "chunk", "tclass", "order", "started")

    def __init__(self, job: CommJob, steps: list[tuple[str, int, float]],
                 order: int):
        self.bucket = job.bucket
        self.algo = job.algo
        self.steps = steps     # [(phase_kind, level, work_seconds), ...]
        self.idx = -1
        self.jid = job.jid
        self.after = job.after
        self.chunk = job.chunk
        self.tclass = job.traffic_class
        self.order = order     # admission order (FIFO tie-break)

    def advance(self, now: float) -> bool:
        """Move to the next non-empty phase; False when the job is done."""
        while True:
            self.idx += 1
            if self.idx >= len(self.steps):
                return False
            kind, level, work = self.steps[self.idx]
            if work > 0.0:
                self.kind = kind
                self.level = level
                self.work = work
                self.remaining = work
                # queue-entry time; re-stamped at first service so FIFO-
                # queued / after-blocked waits are not reported as occupancy
                self.phase_start = now
                self.started = False
                return True


def bucket_jobs(bucket: int, ready: float, nbytes: float, algo: str,
                kind: str, chunks: int, next_id: int,
                deps: tuple[int, ...] = (),
                discount: float = 0.0) -> tuple[list[CommJob], int]:
    """The canonical job decomposition of one gradient bucket: a single
    job when ``chunks <= 1``, else ``chunks`` store-and-forward chunk jobs
    (each ``nbytes/chunks``, ``after``-chained, ids allocated from
    ``next_id``).  ``deps`` (e.g. the bucket's provider compute jobs) are
    stamped onto every chunk, as is the in-kernel fusion ``discount`` of a
    fused bucket (0.0 otherwise).  Shared by the simulator's comm pass and
    ``repro_torch.plan.Plan.comm_jobs`` so plan pricing can never drift from
    search pricing.  Returns ``(jobs, next_id)``."""
    deps = tuple(deps)
    if chunks <= 1:
        return [CommJob(bucket=bucket, ready=ready, nbytes=nbytes,
                        algo=algo, kind=kind, deps=deps,
                        discount=discount)], next_id
    jobs = []
    prev = None
    for c in range(chunks):
        jobs.append(CommJob(bucket=bucket, ready=ready,
                            nbytes=nbytes / chunks, algo=algo, kind=kind,
                            job_id=next_id, after=prev, chunk=c,
                            chunks=chunks, deps=deps, discount=discount))
        prev = next_id
        next_id += 1
    return jobs, next_id


class EventEngine:
    """Schedules one iteration's jobs on the link levels of a
    :class:`ClusterSpec` plus any compute streams the job list names.

    ``run`` is the comm-only entry point (returns ``(busy_seconds,
    finish_time)``; bit-identical to the PR-3 ``CommEngine``);
    ``run_unified`` schedules compute and comm jobs as one dependency
    graph."""

    def __init__(self, spec: ClusterSpec, streams: int = 1,
                 record_load: bool = False,
                 discipline: str | dict[int, str] = DISC_FAIR,
                 level_chunks: bool = False):
        self.spec = spec
        self.streams = max(int(streams), 1)
        self.record_load = record_load
        # per-level chunk sizing (DESIGN.md Sec. 14): fat link levels
        # coalesce chunk cohorts into bigger transfers.  Off by default —
        # uniform chunk_phases schedules stay bit-identical.
        self.level_chunks = bool(level_chunks)
        if isinstance(discipline, str):
            if discipline not in DISCIPLINES:
                raise ValueError(f"unknown discipline {discipline!r}; "
                                 f"expected one of {DISCIPLINES}")
            self._disc = [discipline] * len(spec.levels)
        else:
            self._disc = [DISC_FAIR] * len(spec.levels)
            for lvl, d in discipline.items():
                if d not in DISCIPLINES:
                    raise ValueError(f"unknown discipline {d!r}; "
                                     f"expected one of {DISCIPLINES}")
                if not 0 <= lvl < len(spec.levels):
                    raise ValueError(
                        f"discipline level {lvl} out of range for "
                        f"{len(spec.levels)}-level spec {spec.name!r}")
                self._disc[lvl] = d
        self.level_load: list[tuple[int, float, float, float]] = []
        self.job_finish: dict[int, float] = {}
        self.class_busy: dict[str, float] = {}
        self.class_finish: dict[str, float] = {}
        self._coeffs: dict[tuple[str, str], tuple[float, float]] = {}
        self._steps: dict[tuple[str, str, int, float, int], tuple] = {}
        self._chan_level = spec.levels[spec.bottleneck_index()].name

    # ------------------------------------------------------------- helpers
    def _job_coeffs(self, algo: str, kind: str) -> tuple[float, float]:
        key = (algo, kind)
        cd = self._coeffs.get(key)
        if cd is None:
            cd = comm_coeffs(self.spec, algo, kind)
            self._coeffs[key] = cd
        return cd

    def _job_steps(self, job) -> list[tuple[str, int, float]]:
        if isinstance(job, ComputeJob):
            # one phase on the job's compute stream; stream resources are
            # indexed past the link levels (see _run_phased's names/disc)
            return [(job.kind, len(self.spec.levels) + job.stream,
                     job.duration)]
        # with per-level chunk sizing on, undiscounted chunked jobs get a
        # per-chunk-index decomposition (carrier vs zero-work phases), so
        # the memo key gains the chunk index; fused jobs keep fused_phases
        # (their early comm start already prices the fat-level advantage)
        lc = (self.level_chunks and job.discount <= 0.0 and job.chunks > 1)
        key = (job.algo, job.kind, job.chunks, job.discount,
               job.chunk if lc else -1)
        ph = self._steps.get(key)
        if ph is None:
            if job.discount > 0.0:
                # fused_* phase kinds tag the timeline; (c, d) are the
                # chunk_phases ones unchanged (link work is conserved)
                ph = fused_phases(self.spec, job.algo, job.kind,
                                  job.chunks, job.discount)
            elif lc:
                ph = level_chunk_phases(self.spec, job.algo, job.kind,
                                        job.chunks, job.chunk)
            else:
                ph = chunk_phases(self.spec, job.algo, job.kind, job.chunks)
            self._steps[key] = ph
        return [(p.kind, p.level, p.c * job.nbytes + p.d) for p in ph]

    def _account(self, tclass: str, work: float) -> None:
        self.class_busy[tclass] = self.class_busy.get(tclass, 0.0) + work

    def _finish_job(self, jid: int, tclass: str, t: float) -> None:
        self.job_finish[jid] = t
        if t > self.class_finish.get(tclass, 0.0):
            self.class_finish[tclass] = t

    # ----------------------------------------------------------------- run
    def run(self, jobs: list[CommJob],
            timeline: list | None = None) -> tuple[float, float]:
        # each run is an independent schedule starting at t=0: utilisation
        # segments and per-job/per-class tallies must not accumulate
        self.level_load = []
        self.job_finish = {}
        self.class_busy = {}
        self.class_finish = {}
        # zero-byte jobs transfer nothing: free, and they satisfy deps
        # immediately (a dep on an empty chunk must not deadlock the chain)
        for job in jobs:
            if job.nbytes <= 0.0:
                self._finish_job(job.jid, job.traffic_class, 0.0)
        if self.streams == 1:
            return self._run_serialized(jobs, timeline)
        return self._run_phased(jobs, timeline)

    # ---------------------------------------------------------- unified run
    def run_unified(self, compute: list[ComputeJob], comm: list[CommJob],
                    timeline: list | None = None, background: tuple = (),
                    bg_base_id: int = 0) -> UnifiedResult:
        """Schedule compute and comm jobs as one dependency graph.

        When no compute job depends on a comm job (the default DP training
        iteration: comm depends on compute, never the reverse) the two
        resource kinds decouple and the engine runs the exact seed
        arithmetic: the serialized compute pop-order loop first, then comm
        job readiness is resolved from the finished compute deps and the
        comm pass runs as before — bit-identical to the split schedulers.
        With a cyclic coupling (pipeline schedules: fwd units wait on p2p
        transfers that wait on upstream fwd units) everything runs in the
        phased fluid scheduler with compute streams as extra FIFO
        resources.

        ``background`` traffic is materialized over the compute-finish
        horizon with job ids from ``bg_base_id``; as in the comm-only path,
        when background is present the comm busy/finish reported are the
        DP-class tallies (iteration time gates on gradient sync)."""
        self.level_load = []
        self.job_finish = {}
        self.class_busy = {}
        self.class_finish = {}
        comm_ids = {j.jid for j in comm}
        coupled = any(d in comm_ids
                      for j in compute for d in j.deps)
        if coupled:
            return self._run_coupled(compute, comm, timeline, background,
                                     bg_base_id)
        c_busy, c_fin, order, busy_after, done = \
            self._run_compute_serial(compute, timeline)
        dur: dict[int, float] | None = None  # compute durations, on demand
        jobs = []
        for j in comm:
            if j.deps:
                r = j.ready
                left = []
                for d in j.deps:
                    t = self.job_finish.get(d)
                    if t is None:
                        if d in comm_ids:
                            left.append(d)   # comm-on-comm dep: keep it
                    else:
                        if j.discount > 0.0:
                            # in-kernel fusion: the collective is issued
                            # from inside the producing kernel, so it may
                            # start discount x duration into the dep's tail
                            # (never before the dep started: discount < 1)
                            if dur is None:
                                dur = {cj.job_id: cj.duration
                                       for cj in compute}
                            t -= j.discount * dur.get(d, 0.0)
                        if t > r:
                            r = t
                if r != j.ready or len(left) != len(j.deps):
                    j = dataclasses.replace(j, ready=r, deps=tuple(left))
            jobs.append(j)
        for tr in background:
            made = tr.materialize(c_fin, bg_base_id)
            bg_base_id += len(made)
            jobs.extend(made)
        # zero-byte comm jobs transfer nothing: free, deps satisfied at 0
        for job in jobs:
            if job.nbytes <= 0.0:
                self._finish_job(job.jid, job.traffic_class, 0.0)
        if self.streams == 1:
            m_busy, m_fin = self._run_serialized(jobs, timeline)
        else:
            m_busy, m_fin = self._run_phased(jobs, timeline)
        if background:
            m_busy = self.class_busy.get(TC_DP, 0.0)
            m_fin = self.class_finish.get(TC_DP, 0.0)
        return UnifiedResult(
            compute_busy=c_busy, compute_finish=c_fin,
            comm_busy=m_busy, comm_finish=m_fin,
            finish=max(self.job_finish.values(), default=0.0),
            order=order, busy_after=busy_after, done_at=done)

    def _run_compute_serial(self, jobs: list[ComputeJob],
                            timeline: list | None):
        """Serialized compute stream(s): a ready heap ordered by ``key``
        pops jobs whose deps have finished.  On a single stream this is
        the seed simulator's compute loop bit-exactly: the pop order is
        independent of durations (``key`` is total), every dep of a popped
        job finished at or before ``stream_free`` (ends are
        non-decreasing), so ``start == stream_free`` and the busy sum
        accumulates in pop order."""
        by_id = {j.job_id: j for j in jobs}
        indeg: dict[int, int] = {}
        succs: dict[int, list[int]] = {}
        for j in jobs:
            c = 0
            for d in j.deps:
                if d in by_id:
                    succs.setdefault(d, []).append(j.job_id)
                    c += 1
            indeg[j.job_id] = c
        ready = [(j.key, j.job_id) for j in jobs if indeg[j.job_id] == 0]
        heapq.heapify(ready)
        free: dict[int, float] = {}
        busy = 0.0
        finish = 0.0
        order: list[int] = []
        busy_after: list[float] = []
        done: dict[int, float] = {}
        while ready:
            _, jid = heapq.heappop(ready)
            j = by_id[jid]
            start = free.get(j.stream, 0.0)
            for d in j.deps:     # cross-stream deps (no-op on one stream)
                t = self.job_finish.get(d)
                if t is not None and t > start:
                    start = t
            end = start + j.duration
            free[j.stream] = end
            busy += j.duration
            done[j.ref] = end
            order.append(j.ref)
            busy_after.append(busy)
            if end > finish:
                finish = end
            self._account(j.traffic_class, j.duration)
            self._finish_job(jid, j.traffic_class, end)
            if timeline is not None:
                timeline.append((j.kind, j.ref, start, end, j.traffic_class,
                                 f"stream{j.stream}", start, end))
            for d in succs.get(jid, ()):
                indeg[d] -= 1
                if indeg[d] == 0:
                    heapq.heappush(ready, (by_id[d].key, d))
        if len(order) != len(jobs):
            raise RuntimeError("cyclic dependency among compute jobs")
        return busy, finish, order, busy_after, done

    def _run_coupled(self, compute: list[ComputeJob], comm: list[CommJob],
                     timeline: list | None, background: tuple,
                     bg_base_id: int) -> UnifiedResult:
        """Compute and comm in one phased fluid schedule (pipeline path).

        Per-stream serialization is the lowering's responsibility: every
        compute job must dep on its stream predecessor, so at most one
        compute phase is active per stream and its share is always 1.
        The background horizon is the whole-model serialized compute span
        (an upper-bound proxy — the coupled makespan is unknown until the
        schedule runs)."""
        jobs: list = list(compute) + list(comm)
        horizon = sum(j.duration for j in compute)
        for tr in background:
            made = tr.materialize(horizon, bg_base_id)
            bg_base_id += len(made)
            jobs.extend(made)
        for job in jobs:
            if not isinstance(job, ComputeJob) and job.nbytes <= 0.0:
                self._finish_job(job.jid, job.traffic_class, 0.0)
        self._run_phased(jobs, timeline)
        done = {j.ref: self.job_finish[j.job_id] for j in compute}
        order = sorted(done, key=lambda r: (done[r], r))
        return UnifiedResult(
            compute_busy=self.class_busy.get(TC_COMPUTE, 0.0),
            compute_finish=self.class_finish.get(TC_COMPUTE, 0.0),
            comm_busy=self.class_busy.get(TC_DP, 0.0),
            comm_finish=self.class_finish.get(TC_DP, 0.0),
            finish=max(self.job_finish.values(), default=0.0),
            order=order, busy_after=[], done_at=done)

    # ------------------------------------------------------ serialized path
    def _run_serialized(self, jobs: list[CommJob],
                        timeline: list | None) -> tuple[float, float]:
        # the seed's comm pass: buckets transfer in order of readiness
        # (ties by index), serialized on one channel.  Arithmetic must stay
        # bit-identical: one c*x + d per job, start = max(chan_free, ready).
        if any(j.deps or j.after is not None for j in jobs):
            return self._run_serialized_deps(jobs, timeline)
        chan_free = 0.0
        busy = 0.0
        finish = 0.0
        for job in sorted(jobs, key=lambda j: (j.ready, j.bucket, j.chunk)):
            if job.nbytes <= 0.0:
                continue  # nothing to transfer: no latency D charged
            t = self._opaque_interval(job)
            start = max(chan_free, job.ready)
            chan_free = start + t
            busy += t
            finish = chan_free
            self._account(job.traffic_class, t)
            self._finish_job(job.jid, job.traffic_class, chan_free)
            if timeline is not None:
                kind = "allreduce" if job.kind == KIND_AR else job.kind
                timeline.append((kind, job.bucket, job.chunk,
                                 job.traffic_class, job.algo,
                                 self._chan_level, start, chan_free))
        return busy, finish

    def _opaque_interval(self, job: CommJob) -> float:
        """Serialized (single-channel) cost of one job: ``c*x + d`` with
        the phase latency split across the bucket's chunks (``d / 1 == d``
        bit-exactly, so unchunked jobs keep the seed arithmetic)."""
        c, d = self._job_coeffs(job.algo, job.kind)
        return c * job.nbytes + d / max(job.chunks, 1)

    def _run_serialized_deps(self, jobs: list[CommJob],
                             timeline: list | None) -> tuple[float, float]:
        """Serialized channel with finish-first ordering: the next job run
        is the earliest-(ready, bucket, chunk) job whose ``deps`` (and
        ``after`` predecessor — on one channel store-and-forward degenerates
        to whole-job ordering) have all finished."""
        ids = {j.jid for j in jobs}
        pending = sorted((j for j in jobs if j.nbytes > 0.0),
                         key=lambda j: (j.ready, j.bucket, j.chunk))
        chan_free = 0.0
        busy = 0.0
        finish = 0.0
        while pending:
            picked = None
            for i, job in enumerate(pending):
                need = list(job.deps)
                if job.after is not None:
                    need.append(job.after)
                if all(d not in ids or d in self.job_finish for d in need):
                    picked = i
                    break
            if picked is None:
                raise RuntimeError("dependency cycle in comm jobs")
            job = pending.pop(picked)
            t = self._opaque_interval(job)
            dep_ready = max((self.job_finish[x] for x in job.deps
                             if x in ids), default=0.0)
            if job.after is not None and job.after in ids:
                dep_ready = max(dep_ready, self.job_finish[job.after])
            start = max(chan_free, job.ready, dep_ready)
            chan_free = start + t
            busy += t
            finish = max(finish, chan_free)
            self._account(job.traffic_class, t)
            self._finish_job(job.jid, job.traffic_class, chan_free)
            if timeline is not None:
                kind = "allreduce" if job.kind == KIND_AR else job.kind
                timeline.append((kind, job.bucket, job.chunk,
                                 job.traffic_class, job.algo,
                                 self._chan_level, start, chan_free))
        return busy, finish

    # ---------------------------------------------------------- phased path
    def _runnable(self, a: _Active, by_id: dict[int, "_Active"],
                  ids: set[int]) -> bool:
        """Store-and-forward gate: a chunk may run its phase ``idx`` only
        once its ``after`` predecessor has completed that phase."""
        if a.after is None or a.after not in ids:
            return True
        if a.after in self.job_finish:
            return True
        pred = by_id.get(a.after)
        # a predecessor still waiting in the pending queue blocks the chain
        return pred is not None and pred.idx > a.idx

    def _run_phased(self, jobs: list,
                    timeline: list | None) -> tuple[float, float]:
        ids = {j.jid for j in jobs}
        # zero-duration compute jobs stay in the queue (they must wait for
        # their deps before "finishing"); zero-byte comm jobs were already
        # pre-finished by the caller
        pending = sorted((j for j in jobs
                          if isinstance(j, ComputeJob) or j.nbytes > 0.0),
                         key=lambda j: (j.ready, j.bucket, j.chunk))
        active: list[_Active] = []
        by_id: dict[int, _Active] = {}
        # slot accounting: distinct DP buckets in flight (chunks share their
        # bucket's slot; TP/PP background traffic bypasses the bound)
        inflight: dict[int, int] = {}
        t = 0.0
        busy = 0.0
        finish = 0.0
        order = 0
        names = [l.name for l in self.spec.levels]
        disc = self._disc
        # compute streams are extra serialized resources past the link
        # levels; FIFO is nominal — the lowering chains each stream's jobs
        # by deps, so at most one compute phase is active per stream
        n_streams = 0
        for j in jobs:
            if isinstance(j, ComputeJob) and j.stream >= n_streams:
                n_streams = j.stream + 1
        if n_streams:
            names = names + [f"stream{i}" for i in range(n_streams)]
            disc = disc + [DISC_FIFO] * n_streams
        while pending or active:
            # ---- admission: ready, deps finished, slot available
            i = 0
            while i < len(pending):
                job = pending[i]
                if job.ready > t:
                    break
                if any(d in ids and d not in self.job_finish
                       for d in job.deps):
                    i += 1
                    continue
                if (job.traffic_class == TC_DP
                        and job.bucket not in inflight
                        and len(inflight) >= self.streams):
                    i += 1
                    continue
                del pending[i]
                a = _Active(job, self._job_steps(job), order)
                order += 1
                if a.advance(t):
                    active.append(a)
                    by_id[a.jid] = a
                    if job.traffic_class == TC_DP:
                        inflight[job.bucket] = inflight.get(job.bucket, 0) + 1
                else:
                    finish = max(finish, t)  # all-empty phase list
                    self._finish_job(job.jid, job.traffic_class, t)
            if not active:
                if not pending:
                    break  # admission drained everything as zero-work jobs
                later = [j.ready for j in pending if j.ready > t]
                if not later:
                    raise RuntimeError("dependency cycle in comm jobs")
                t = min(later)
                continue
            runnable = [a for a in active if self._runnable(a, by_id, ids)]
            if not runnable:
                later = [j.ready for j in pending if j.ready > t]
                if not later:
                    raise RuntimeError("store-and-forward cycle in comm jobs")
                t = min(later)
                continue
            counts: dict[int, int] = {}
            for a in runnable:
                counts[a.level] = counts.get(a.level, 0) + 1
            # per-level discipline: fair-share divides a level's rate over
            # its contenders; FIFO serves them one at a time in admission /
            # phase-arrival order at full rate.  ``share`` is the divisor a
            # running phase's progress rate pays (None: not served now).
            share: dict[int, int] = {}
            heads: dict[int, _Active] = {}
            for a in runnable:
                if disc[a.level] == DISC_FAIR:
                    share[id(a)] = counts[a.level]
                else:
                    h = heads.get(a.level)
                    if h is None or (a.phase_start, a.order) < \
                            (h.phase_start, h.order):
                        heads[a.level] = a
            for a in heads.values():
                share[id(a)] = 1
            # next event: earliest phase completion under the current
            # rates, or the next admissible arrival
            dt = min(a.remaining * share[id(a)] for a in runnable
                     if id(a) in share)
            arrival = self._next_admissible_arrival(pending, inflight, t)
            if arrival is not None:
                dt = min(dt, arrival - t)
            dt = max(dt, 0.0)
            t1 = t + dt
            progressed: dict[int, float] = {}
            for a in runnable:
                s = share.get(id(a))
                if s is None:
                    continue
                if not a.started:
                    a.phase_start = t
                    a.started = True
                step = dt / s
                a.remaining -= step
                if self.record_load:
                    progressed[a.level] = progressed.get(a.level, 0.0) + step
            if self.record_load and dt > 0.0:
                # record the *observed* seconds of work each level advanced
                # during [t, t1] — the capacity test divides by the segment
                # span, so a rate bug cannot hide behind the prescription
                for lvl, w in progressed.items():
                    self.level_load.append((lvl, t, t1, w))
            t = t1
            still: list[_Active] = []
            for a in active:
                if a.remaining <= 1e-12 * a.work:
                    busy += a.work
                    self._account(a.tclass, a.work)
                    if timeline is not None:
                        if a.tclass == TC_COMPUTE:
                            # compute layout: spans at both (2,3) — legacy
                            # consumers — and (6,7) — the unified schema
                            timeline.append((a.kind, a.bucket,
                                             a.phase_start, t, a.tclass,
                                             names[a.level],
                                             a.phase_start, t))
                        else:
                            timeline.append((a.kind, a.bucket, a.chunk,
                                             a.tclass, a.algo,
                                             names[a.level],
                                             a.phase_start, t))
                    if a.advance(t):
                        still.append(a)
                    else:
                        finish = max(finish, t)
                        del by_id[a.jid]
                        self._finish_job(a.jid, a.tclass, t)
                        if a.tclass == TC_DP:
                            inflight[a.bucket] -= 1
                            if not inflight[a.bucket]:
                                del inflight[a.bucket]
                else:
                    still.append(a)
            active = still
        return busy, finish

    def _next_admissible_arrival(self, pending: list[CommJob],
                                 inflight: dict[int, int],
                                 now: float) -> float | None:
        """Earliest *future* ready time among pending jobs that could be
        admitted when they arrive (slot free, or slot-exempt, given the
        current in-flight set).  Jobs already ready but held back by a
        dependency or a full slot table are not arrival events — their
        admission is retried at the finish event that unblocks them."""
        slot_free = len(inflight) < self.streams
        best = None
        for j in pending:
            if j.ready <= now:
                continue
            if (j.traffic_class == TC_DP and not slot_free
                    and j.bucket not in inflight):
                continue
            if best is None or j.ready < best:
                best = j.ready
        return best


# the PR-3..5 comm-only name; same class, kept so existing callers and
# pickled references keep working
CommEngine = EventEngine
