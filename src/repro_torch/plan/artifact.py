"""The Plan artifact: a frozen, versioned record of one searched strategy
(port of ``repro/plan/artifact.py``; same JSON schema and version).

DisCo's workflow is "search once, then train with the optimized
configuration" (paper Sec. 3.1), but until this layer existed the searched
strategy was not a value — it was mutable :class:`~repro_torch.core.graph.
FusionGraph` state plus an ad-hoc ``strategy.json``.  :class:`Plan` is the
compilation artifact separable from the run (the same discipline as Alpa's
serializable parallelism plans / TASO's exported substitutions): everything
the search decided, everything needed to re-price it, and nothing tied to a
live process.

Contents (DESIGN.md Sec. 10):

* **Op fusion** — the group partition and per-prim provider, in a canonical
  content-sorted order (gid-free, so two graphs with the same strategy
  serialize identically).
* **Tensor fusion** — buckets plus the per-bucket ``(algo, comm kind,
  chunks)`` triple and each bucket's gradient byte volume (so a saved plan
  can be *priced* without re-tracing the model).
* **Pricing context** — stream count, background-traffic classes, a full
  cluster fingerprint (exact level constants, or the legacy flat
  ``Hardware``), and estimator provenance.
* **Prediction** — the simulator's iteration time for the plan, plus a
  free-form ``provenance`` dict (search stats; excluded from equality).

Round-tripping: ``Plan.from_graph(plan.to_graph(base)) == plan`` and the
reconstructed graph keeps the original ``fast_signature()`` and simulated
cost.  ``save``/``load`` are schema-versioned JSON; corrupted files,
foreign versions and cluster-fingerprint mismatches raise
:class:`PlanError` (``PlanVersionError`` / ``ClusterMismatchError``).  A
legacy v0 ``strategy.json`` (the old hand-rolled enactment format) loads
through a migration shim — bucket-only, enactable via :meth:`Plan.
grad_sync`, not re-priceable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Sequence

from ..cluster import ClusterSpec, LinkLevel, comm_time
from ..core.costs import OracleEstimator
from ..core.events import (BackgroundTraffic, CommEngine, CommJob, TC_DP,
                           bucket_jobs)
from ..core.graph import FusionGraph
from ..core.hw import Hardware
from ..core.pipeline import PipelineSchedule
from ..core.simulator import Simulator

SCHEMA = "repro.plan"
# v2 added the optional pipeline-schedule knobs; v1 artifacts load with
# pipeline=None.  v3 added the searched pipeline-knob overrides
# (``pp_knobs``), the first-class TP traffic description (``tp``) and the
# per-level chunk flag (``level_chunks``); v1/v2 artifacts load with all
# three at their None/False defaults (every other field is unchanged).
PLAN_VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)


class PlanError(Exception):
    """A Plan artifact could not be read, validated, or applied."""


class PlanVersionError(PlanError):
    """The file is not a Plan of a schema version this code understands."""


class ClusterMismatchError(PlanError):
    """The plan was searched against a different cluster than requested."""


# ------------------------------------------------------------- fingerprints
def cluster_fingerprint(spec: ClusterSpec) -> tuple:
    """Canonical, reconstructible identity of a cluster spec.  Flat
    back-compat specs record the full legacy ``Hardware`` (their pricing
    delegates to it); real specs record the exact per-level constants."""
    if spec.is_flat_compat:
        hw = dataclasses.asdict(spec.compat_hw)
        return ("flat", int(spec.n_devices), tuple(sorted(hw.items())))
    return ("spec", spec.name,
            tuple((l.name, int(l.degree), float(l.bandwidth),
                   float(l.alpha), float(l.straggler), float(l.contention))
                  for l in spec.levels))


_LEVEL_FIELDS = ("name", "degree", "bandwidth", "alpha", "straggler",
                 "contention")


def cluster_fingerprint_diff(a: tuple, b: tuple) -> list[str]:
    """Human-readable field-level differences between two cluster
    fingerprints — which levels and which per-level constants disagree —
    so a ``--plan`` / ``--cluster`` mismatch reports *what* differs
    instead of only that something does.  Empty list iff equal.  Accepts
    either tuple- or (JSON round-tripped) list-shaped fingerprints."""
    a, b = _tuplize(_listize(a)), _tuplize(_listize(b))
    if a == b:
        return []
    if a[0] != b[0]:
        return [f"topology family: {a[0]} != {b[0]}"]
    diffs: list[str] = []
    if a[0] == "flat":
        if a[1] != b[1]:
            diffs.append(f"n_devices: {a[1]} != {b[1]}")
        for (ka, va), (kb, vb) in zip(a[2], b[2]):
            if va != vb:
                diffs.append(f"hw.{ka}: {va} != {vb}")
        return diffs or [f"flat fingerprint differs: {a} != {b}"]
    if a[1] != b[1]:
        diffs.append(f"name: {a[1]!r} != {b[1]!r}")
    la, lb = a[2], b[2]
    if len(la) != len(lb):
        diffs.append(f"levels: {len(la)} != {len(lb)} "
                     f"({[l[0] for l in la]} vs {[l[0] for l in lb]})")
    for i, (lvl_a, lvl_b) in enumerate(zip(la, lb)):
        for f, va, vb in zip(_LEVEL_FIELDS, lvl_a, lvl_b):
            if va != vb:
                diffs.append(f"level[{i}].{f}: {va} != {vb}")
    return diffs or [f"fingerprint differs: {a} != {b}"]


def _listize(x):
    """Mirror of ``_tuplize`` so diffing works on raw JSON shapes too."""
    if isinstance(x, tuple):
        return [_listize(e) for e in x]
    return x


def _spec_from_fingerprint(fp: tuple) -> ClusterSpec:
    if fp[0] == "flat":
        return ClusterSpec.flat(Hardware(**dict(fp[2])), fp[1])
    if fp[0] == "spec":
        return ClusterSpec(fp[1], tuple(LinkLevel(*lvl) for lvl in fp[2]))
    raise PlanError(f"unknown cluster fingerprint tag {fp[0]!r}")


def _bg_tuple(b: BackgroundTraffic) -> tuple:
    return (b.traffic_class, float(b.nbytes), float(b.period), b.algo,
            b.kind, float(b.offset), b.count)


def estimator_name(est) -> str:
    if est is None or isinstance(est, OracleEstimator):
        return "oracle"
    return type(est).__name__


def _tuplize(x):
    """JSON gives lists; equality needs the exact nested-tuple shape."""
    if isinstance(x, list):
        return tuple(_tuplize(e) for e in x)
    return x


# ------------------------------------------------------------------- artifact
@dataclasses.dataclass(frozen=True)
class Plan:
    """A complete searched strategy, frozen and serializable.

    ``provenance`` (search statistics, lineage notes) is carried along but
    excluded from equality — two plans prescribing the same strategy under
    the same pricing context are equal regardless of how they were found.
    """
    version: int
    # op fusion: canonical content-sorted groups; provider[pid] indexes them
    groups: tuple[tuple[int, ...], ...]
    provider: tuple[int, ...]
    # tensor fusion: buckets of grad-param indices + per-bucket choices
    buckets: tuple[tuple[int, ...], ...]
    bucket_algos: tuple[str, ...]
    bucket_comm: tuple[str, ...]
    bucket_chunks: tuple[int, ...]
    bucket_bytes: tuple[float, ...]      # () when unknown (v0 migration)
    # per-bucket in-kernel compute+comm fusion flags (0/1, DESIGN.md
    # Sec. 13).  Optional v2 field: () in pre-fused artifacts means "no
    # bucket fused", so old plans load (and fingerprint) unchanged.
    bucket_fused: tuple[int, ...] = ()
    # pricing context
    streams: int = 1
    background: tuple[tuple, ...] = ()
    # PipelineSchedule.to_tuple(), or None when the plan was priced on the
    # single-device replay (v1 artifacts)
    pipeline: tuple | None = None
    # searched pipeline-knob overrides (n_stages, n_microbatches,
    # interleave; each may be None) resolved against ``pipeline`` at
    # pricing time — part of the *strategy*, unlike ``pipeline`` which is
    # pricing context.  None in v1/v2 artifacts.
    pp_knobs: tuple | None = None
    # TPTraffic.to_tuple(), or None when the plan was priced without
    # first-class tp traffic (v1/v2 artifacts, background-only sims)
    tp: tuple | None = None
    # per-level chunk pipelining flag (DESIGN.md Sec. 14); False in
    # v1/v2 artifacts
    level_chunks: bool = False
    cluster: tuple | None = None         # cluster_fingerprint(), or unknown
    hw: tuple | None = None              # sorted Hardware items, or unknown
    estimator: str = "oracle"
    predicted_iteration_time: float | None = None
    barriers: bool = False               # enactment fence (v0 carry-over)
    provenance: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        # per-bucket vectors must agree in length (truncated artifacts must
        # fail loudly at load, not silently drop strategy at enactment)
        nb = len(self.buckets)
        for f in ("bucket_algos", "bucket_comm", "bucket_chunks"):
            n = len(getattr(self, f))
            if n != nb:
                raise PlanError(f"corrupt plan: {f} has {n} entries for "
                                f"{nb} buckets")
        if self.bucket_bytes and len(self.bucket_bytes) != nb:
            raise PlanError(f"corrupt plan: bucket_bytes has "
                            f"{len(self.bucket_bytes)} entries for "
                            f"{nb} buckets")
        if self.bucket_fused and len(self.bucket_fused) != nb:
            raise PlanError(f"corrupt plan: bucket_fused has "
                            f"{len(self.bucket_fused)} entries for "
                            f"{nb} buckets")

    # ------------------------------------------------------------ graph I/O
    @classmethod
    def from_graph(cls, g: FusionGraph, *, sim: Simulator | None = None,
                   predicted: float | None = None,
                   provenance: dict | None = None) -> "Plan":
        """Capture ``g``'s complete strategy.  With ``sim`` the pricing
        context (cluster, streams, background, estimator) is recorded and
        ``predicted`` defaults to ``sim.cost(g)``."""
        # canonical group order: by (members, provided) content, never by
        # gid — gids are allocation order, not strategy
        order = sorted(
            g.groups,
            key=lambda gid: (tuple(sorted(g.groups[gid])),
                             tuple(sorted(g.provided_set(gid)))))
        index = {gid: i for i, gid in enumerate(order)}
        kw: dict = {}
        if sim is not None:
            hw = getattr(sim, "hw", None)
            pp = getattr(sim, "pipeline", None)
            tp = getattr(sim, "tp", None)
            kw = dict(
                streams=int(getattr(sim, "streams", 1)),
                background=tuple(_bg_tuple(b)
                                 for b in getattr(sim, "background", ())),
                pipeline=None if pp is None else pp.to_tuple(),
                tp=None if tp is None else tp.to_tuple(),
                level_chunks=bool(getattr(sim, "level_chunks", False)),
                cluster=cluster_fingerprint(sim.cluster),
                hw=(tuple(sorted(dataclasses.asdict(hw).items()))
                    if hw is not None else None),
                estimator=estimator_name(getattr(sim, "estimator", None)),
            )
            if predicted is None:
                predicted = sim.cost(g)
        return cls(
            version=PLAN_VERSION,
            groups=tuple(tuple(sorted(g.groups[gid])) for gid in order),
            provider=tuple(index[g.provider[pid]]
                           for pid in range(len(g.prims))),
            buckets=tuple(tuple(b) for b in g.buckets),
            bucket_algos=tuple(g.bucket_algos),
            bucket_comm=tuple(g.bucket_comm),
            bucket_chunks=tuple(int(k) for k in g.bucket_chunks),
            bucket_bytes=tuple(float(g.bucket_bytes(b)) for b in g.buckets),
            bucket_fused=tuple(int(bool(f)) for f in g.bucket_fused),
            pp_knobs=(None if getattr(g, "pp_knobs", None) is None
                      else tuple(g.pp_knobs)),
            predicted_iteration_time=predicted,
            provenance=dict(provenance or {}),
            **kw,
        )

    def to_graph(self, base: FusionGraph) -> FusionGraph:
        """Re-apply this strategy onto ``base`` (the traced/profiled prim
        graph the plan was searched over, or an equivalent re-trace).  The
        result's ``fast_signature()`` and simulated cost equal the searched
        graph's.  Raises :class:`PlanError` when the plan does not fit."""
        n = len(base.prims)
        if self.groups:
            if len(self.provider) != n:
                raise PlanError(
                    f"plan was built over {len(self.provider)} prims but "
                    f"this graph has {n} — wrong trace for this artifact")
            groups = {i: frozenset(m) for i, m in enumerate(self.groups)}
            provider = {}
            for pid, gi in enumerate(self.provider):
                if not 0 <= gi < len(self.groups) or pid not in groups[gi]:
                    raise PlanError(
                        f"corrupt plan: prim {pid} names provider group "
                        f"{gi} which does not contain it")
                provider[pid] = gi
            for gi, members in groups.items():
                if any(not 0 <= p < n for p in members):
                    raise PlanError(
                        f"corrupt plan: group {gi} names unknown prims")
            g = FusionGraph._from_parts(
                base.prims, base.psuccs, base.ppreds, groups, provider,
                len(self.groups), base.grad_prim,
                [tuple(b) for b in self.buckets],
                family=base.family_token(),
                bucket_algos=list(self.bucket_algos),
                bucket_comm=list(self.bucket_comm),
                bucket_chunks=list(self.bucket_chunks),
                bucket_fused=([bool(f) for f in self.bucket_fused]
                              if self.bucket_fused else None),
                pp_knobs=self.pp_knobs)
        else:
            # v0-migrated bucket-only plan: keep base's op-fusion state
            g = FusionGraph._from_parts(
                base.prims, base.psuccs, base.ppreds, base.groups,
                base.provider, base._next_gid, base.grad_prim,
                [tuple(b) for b in self.buckets],
                family=base.family_token(),
                bucket_algos=list(self.bucket_algos),
                bucket_comm=list(self.bucket_comm),
                bucket_chunks=list(self.bucket_chunks),
                bucket_fused=([bool(f) for f in self.bucket_fused]
                              if self.bucket_fused else None),
                pp_knobs=self.pp_knobs)
        seen: set[int] = set()
        for b in g.buckets:
            for p in b:
                if p not in g.grad_prim:
                    raise PlanError(
                        f"plan bucket names gradient {p} which this graph "
                        f"does not produce")
                if p in seen:
                    raise PlanError(f"gradient {p} appears in two buckets")
                seen.add(p)
        try:
            g.topo_groups()
        except RuntimeError as e:
            raise PlanError(f"plan op-fusion state is cyclic: {e}") from e
        return g

    # -------------------------------------------------------------- lowering
    def grad_sync(self, params=None):
        """Lower the tensor-fusion half of the plan to an enactable
        :class:`repro_torch.distributed.train_step.GradSyncStrategy` — buckets,
        per-bucket comm kinds *and* chunk counts (chunked collectives are
        enacted for real; see ``sync_grads``).  With ``params`` the buckets
        are clipped to the real leaf count and uncovered leaves get
        singleton AllReduce buckets (the ``from_fusion_graph`` contract)."""
        from ..distributed.train_step import GradSyncStrategy

        return GradSyncStrategy.from_buckets(
            self.buckets, self.bucket_comm, self.bucket_chunks,
            fused=self.bucket_fused or None,
            params=params, barriers=self.barriers)

    def cluster_spec(self) -> ClusterSpec | None:
        """Reconstruct the exact ClusterSpec the plan was searched against
        (None when the artifact records no pricing context)."""
        return (None if self.cluster is None
                else _spec_from_fingerprint(self.cluster))

    def simulator(self, *, cluster: ClusterSpec | None = None,
                  estimator=None, **kw) -> Simulator:
        """Reconstruct the pricing configuration the plan was searched
        under: cluster, stream count and background traffic.  Passing
        ``cluster`` asserts it matches the recorded fingerprint
        (:class:`ClusterMismatchError` otherwise) — re-pricing a plan on a
        different topology must be an explicit re-compile, not an
        accident."""
        spec = self.cluster_spec()
        if cluster is not None:
            if (self.cluster is not None
                    and cluster_fingerprint(cluster) != self.cluster):
                diff = cluster_fingerprint_diff(
                    self.cluster, cluster_fingerprint(cluster))
                raise ClusterMismatchError(
                    f"plan was searched against "
                    f"{spec.name if spec else '<unknown>'} but "
                    f"{cluster.name} was requested "
                    f"({'; '.join(diff)}); re-run compile() to "
                    f"target a different cluster")
            spec = cluster
        if self.estimator != "oracle" and estimator is None:
            raise PlanError(
                f"plan was priced by a {self.estimator!r} estimator, which "
                f"an artifact cannot reconstruct — pass estimator=")
        # restore the recorded compute hardware too: the oracle estimator's
        # fused-op times depend on it, not just on the cluster
        sim_kw = dict(kw)
        if self.hw is not None:
            sim_kw.setdefault("hw", Hardware(**dict(self.hw)))
        if self.pipeline is not None:
            sim_kw.setdefault(
                "pipeline", PipelineSchedule.from_tuple(self.pipeline))
        if self.tp is not None:
            from ..core.tp_traffic import TPTraffic
            sim_kw.setdefault("tp", TPTraffic.from_tuple(self.tp))
        if self.level_chunks:
            sim_kw.setdefault("level_chunks", True)
        return Simulator(
            estimator=estimator, cluster=spec,
            streams=self.streams,
            background=tuple(BackgroundTraffic(*b)
                             for b in self.background),
            **sim_kw)

    # --------------------------------------------------------------- pricing
    def comm_jobs(self, ready: Sequence[float] | None = None) -> list[CommJob]:
        """The plan's gradient traffic as event-engine jobs (the same
        chunked decomposition the simulator prices), ready at ``ready[i]``
        (default: all at 0).  Needs recorded bucket volumes."""
        if not self.bucket_bytes:
            raise PlanError("artifact records no bucket volumes "
                            "(v0-migrated plans are enact-only)")
        jobs: list[CommJob] = []
        next_id = len(self.buckets)
        for i, nb in enumerate(self.bucket_bytes):
            r = float(ready[i]) if ready is not None else 0.0
            js, next_id = bucket_jobs(i, r, nb, self.bucket_algos[i],
                                      self.bucket_comm[i],
                                      self.bucket_chunks[i], next_id)
            jobs.extend(js)
        return jobs

    def price(self, *, cluster: ClusterSpec | None = None,
              streams: int | None = None) -> dict:
        """Price the saved gradient traffic without re-tracing or
        re-searching: the serialized-channel sum and the event-engine
        finish of the plan's bucket set (all buckets ready at 0 — the
        comm-bound floor), on the recorded cluster or an explicit
        override.  When the plan records background TP/PP traffic and the
        engine is multi-stream, the recorded classes are materialized over
        the uncontended finish horizon and the contended gradient finish is
        reported alongside (mirroring the simulator's injection rule)."""
        spec = cluster or self.cluster_spec()
        if spec is None:
            raise PlanError("artifact records no cluster; pass cluster=")
        s = max(int(streams or self.streams), 1)
        serialized = sum(
            comm_time(nb, spec, a, k)
            for nb, a, k in zip(self.bucket_bytes, self.bucket_algos,
                                self.bucket_comm)
            if nb > 0.0)
        jobs = self.comm_jobs()
        busy, finish = CommEngine(spec, streams=s).run(list(jobs))
        out = {
            "cluster": spec.describe(),
            "cluster_fingerprint_match": (
                self.cluster is None
                or cluster_fingerprint(spec) == self.cluster),
            "streams": s,
            "buckets": len(self.buckets),
            "total_grad_bytes": float(sum(self.bucket_bytes)),
            "serialized_comm_s": serialized,
            "engine_busy_s": busy,
            "engine_finish_s": finish,
            "predicted_iteration_time_s": self.predicted_iteration_time,
        }
        if self.background and s > 1:
            next_id = max((j.jid for j in jobs),
                          default=len(self.buckets)) + 1
            bg: list[CommJob] = []
            for t in self.background:
                made = BackgroundTraffic(*t).materialize(finish, next_id)
                next_id += len(made)
                bg.extend(made)
            if bg:
                eng = CommEngine(spec, streams=s)
                eng.run(list(jobs) + bg)
                contended = eng.class_finish.get(TC_DP, 0.0)
                out["contention"] = {
                    "background_jobs": len(bg),
                    "grad_finish_alone_s": finish,
                    "grad_finish_contended_s": contended,
                    "slowdown": contended / finish if finish > 0 else 1.0,
                }
                out["engine_busy_s"] = eng.class_busy.get(TC_DP, 0.0)
                out["engine_finish_s"] = contended
        return out

    # ------------------------------------------------------------------ misc
    def describe(self) -> dict:
        """Strategy statistics, mirroring ``FusionGraph.describe`` for the
        fields a plan carries (sweep/report consumers)."""
        return {
            "groups": len(self.groups),
            "fused_groups": sum(1 for m in self.groups if len(m) > 1),
            "allreduce_buckets": len(self.buckets),
            "grad_tensors": sum(len(b) for b in self.buckets),
            "bucket_algos": {a: self.bucket_algos.count(a)
                             for a in set(self.bucket_algos)},
            "bucket_comm": {k: self.bucket_comm.count(k)
                            for k in set(self.bucket_comm)},
            "bucket_chunks": {k: self.bucket_chunks.count(k)
                              for k in set(self.bucket_chunks)},
            "fused_comm_buckets": sum(1 for f in self.bucket_fused if f),
            "streams": self.streams,
            "estimator": self.estimator,
            "pipeline": self.pipeline,
            "pp_knobs": self.pp_knobs,
            "tp": self.tp,
            "level_chunks": self.level_chunks,
            "predicted_iteration_time_s": self.predicted_iteration_time,
        }

    def fingerprint(self) -> str:
        """Process-stable identity of the strategy + pricing context
        (PYTHONHASHSEED-independent; provenance excluded)."""
        d = self._to_json()
        d.pop("provenance", None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def strategy_fingerprint(self) -> str:
        """Identity of the *strategy alone* — op-fusion partition, buckets
        and per-bucket choices — excluding the pricing context, so two
        searches that converge on the same strategy under different
        clusters/streams fingerprint identically (the cross-topology
        distinctness metric of ``fig_cluster_sweep``)."""
        parts = [self.groups, self.provider, self.buckets, self.bucket_algos,
                 self.bucket_comm, self.bucket_chunks]
        if any(self.bucket_fused):
            # appended only when some bucket is fused: all-unfused (and
            # pre-fused) plans keep their historical fingerprints
            parts.append(self.bucket_fused)
        if self.pp_knobs is not None:
            # same rule for the searched pipeline knobs: plans that never
            # touched them keep their historical fingerprints
            parts.append(list(self.pp_knobs))
        blob = json.dumps(parts, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    # -------------------------------------------------------------- file I/O
    def _to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = SCHEMA
        return d

    def save(self, path: str) -> None:
        """Atomic write: temp file in the target directory + ``os.replace``,
        so an interrupted save can never leave a torn JSON artifact (a
        half-written plan in a cache directory must stay a *miss*, not
        become a crash or a silently-wrong strategy)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._to_json(), f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    @staticmethod
    def load(path: str) -> "Plan":
        try:
            with open(path) as f:
                d = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise PlanError(f"{path}: not a Plan artifact "
                            f"(corrupt JSON: {e})") from e
        return Plan.from_dict(d, source=path)

    @staticmethod
    def from_dict(d: dict, source: str = "<dict>") -> "Plan":
        if not isinstance(d, dict):
            raise PlanError(f"{source}: not a Plan artifact")
        if d.get("schema") != SCHEMA:
            if "schema" not in d and "buckets" in d:
                return Plan._migrate_v0(d, source)
            raise PlanVersionError(
                f"{source}: schema {d.get('schema')!r} is not {SCHEMA!r}")
        version = d.get("version")
        if version not in SUPPORTED_VERSIONS:
            raise PlanVersionError(
                f"{source}: plan version {version!r} is not supported by "
                f"this build (wants one of {SUPPORTED_VERSIONS}); "
                f"re-run compile()")
        try:
            cluster = d.get("cluster")
            pipeline = d.get("pipeline")   # absent in v1 artifacts
            pp_knobs = d.get("pp_knobs")   # absent in v1/v2 artifacts
            tp = d.get("tp")               # absent in v1/v2 artifacts
            return Plan(
                version=PLAN_VERSION,
                groups=_tuplize(d["groups"]),
                provider=_tuplize(d["provider"]),
                buckets=_tuplize(d["buckets"]),
                bucket_algos=_tuplize(d["bucket_algos"]),
                bucket_comm=_tuplize(d["bucket_comm"]),
                bucket_chunks=_tuplize(d["bucket_chunks"]),
                bucket_bytes=_tuplize(d["bucket_bytes"]),
                bucket_fused=_tuplize(d.get("bucket_fused", [])),
                streams=int(d.get("streams", 1)),
                background=_tuplize(d.get("background", [])),
                pipeline=None if pipeline is None else _tuplize(pipeline),
                pp_knobs=None if pp_knobs is None else _tuplize(pp_knobs),
                tp=None if tp is None else _tuplize(tp),
                level_chunks=bool(d.get("level_chunks", False)),
                cluster=None if cluster is None else _tuplize(cluster),
                hw=(None if d.get("hw") is None
                    else _tuplize(d["hw"])),
                estimator=d.get("estimator", "oracle"),
                predicted_iteration_time=d.get("predicted_iteration_time"),
                barriers=bool(d.get("barriers", False)),
                provenance=dict(d.get("provenance", {})),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise PlanError(f"{source}: corrupt plan artifact: {e}") from e

    @staticmethod
    def _migrate_v0(d: dict, source: str) -> "Plan":
        """Legacy hand-rolled ``strategy.json`` (buckets / barriers /
        comms) -> bucket-only Plan.  Enactable via ``grad_sync``; carries
        no op-fusion state, volumes or pricing context."""
        try:
            buckets = tuple(tuple(int(i) for i in b) for b in d["buckets"])
        except (KeyError, TypeError, ValueError) as e:
            raise PlanError(f"{source}: corrupt legacy strategy "
                            f"file: {e}") from e
        comms = d.get("comms") or ["ar"] * len(buckets)
        if len(comms) != len(buckets):
            raise PlanError(f"{source}: legacy strategy comms/buckets "
                            f"length mismatch")
        return Plan(
            version=PLAN_VERSION,
            groups=(), provider=(),
            buckets=buckets,
            bucket_algos=("ring",) * len(buckets),
            bucket_comm=tuple(comms),
            bucket_chunks=tuple(int(k) for k in
                                d.get("chunks") or (1,) * len(buckets)),
            bucket_bytes=(),
            barriers=bool(d.get("barriers", False)),
            provenance={"migrated_from": "v0 strategy.json",
                        "source": source},
        )
