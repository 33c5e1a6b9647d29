"""``repro_torch.plan.cache`` — content-addressed Plan cache + warm-start
ranking (port of ``repro/plan/cache.py``).

DisCo's search output is a reusable artifact
(:class:`~repro_torch.plan.artifact.Plan`); without a cache ``compile()``
re-runs the backtracking search from scratch for every (model, cluster,
knobs) point.  This module is the storage/index layer above the artifact
(DESIGN.md Sec. 12): a :class:`PlanCache` directory keyed on

    ``sha256(graph content-signature x cluster fingerprint x search-knob
    digest)``

whose values are the Plan JSON files themselves.  Exact-key hits *replay*
the artifact — bit-identical strategy, fingerprints and predicted price, no
simulator evaluations (the ``compile once, replay everywhere`` discipline;
DeepCompile/DistIR in PAPERS.md argue simulator-driven search only scales
across fleets of (model, topology) points this way).

Near misses go through :func:`rank_entries`: cached entries are scored by a
similarity over (same traced graph > same arch, same cluster fingerprint >
same level structure, close gradient volume / device count / stream count),
and ``compile(cache=...)`` re-applies the nearest Plan's strategy onto the
fresh :class:`~repro_torch.core.graph.FusionGraph` (through the mutation
registry's applicability contract — dimensions the new simulator cannot
price are reset to their defaults) as the backtracking search's **warm
start state**.  The failure/fallback ladder is total: a corrupt entry is a
miss, a plan that does not fit the new trace is skipped, and a warm state
that prices worse than the trivial (unfused) baseline is discarded — the
search then runs cold, exactly as without a cache.

Key derivation notes: the in-memory ``FusionGraph.fast_signature()`` is a
per-process salted hash (Python string hashing), so the on-disk key derives
from the *stable* content signature — prim payloads, the prim DAG's edges
and the full sorted strategy ``signature()`` — plus the canonical cluster
fingerprint of :func:`repro_torch.plan.artifact.cluster_fingerprint` and a
digest of the trajectory-determining search knobs (``workers`` is
excluded: the worker pool evaluates candidates concurrently but the RNG
stream, and thus the result, is identical).

Keys, digests and the on-disk layout are the reference's, so for an
oracle-priced graph one cache directory serves both packages.  Two
deviations: a non-oracle estimator with a ``fingerprint()`` (the port's
:class:`~repro_torch.core.gnn.GNNEstimator`) also keys on that digest of
its config and weights, where the reference keys on the class name alone.
Serving plans (:class:`~repro_torch.serving.plan.ServingPlan`) share the
store with training Plans, as in the reference.

CLI (``python -m repro_torch.plan.cache``): ``ls`` / ``stats`` / ``prune``
/ ``verify`` over a cache directory.  Loads no torch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Iterable, Sequence

from ..cluster import ClusterSpec
from ..core.graph import FusionGraph
from ..core.mutations import (METHOD_ALGO, METHOD_CHUNK, METHOD_COMM,
                              METHOD_FUSED, METHOD_PP_SPLIT, active_methods)
from .artifact import Plan, PlanError, cluster_fingerprint, estimator_name

INDEX_NAME = "index.json"
INDEX_VERSION = 1
PLAN_SUFFIX = ".plan.json"


# ----------------------------------------------------------------- digests
def _sha(obj) -> str:
    """Stable short digest of a JSON-able structure (tuples and lists
    collapse to the same JSON arrays on purpose — fingerprints round-trip
    through JSON as lists)."""
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=repr).encode()
    ).hexdigest()[:20]


def _trace_digest(g: FusionGraph) -> str:
    """Digest of the *immutable* traced half of a graph: prim payloads and
    DAG edges.  Mutations only move groups/buckets, never prims, so the
    value is memoized on the instance — repeated cache lookups over one
    traced graph (the sweep-benchmark pattern) pay it once."""
    d = getattr(g, "_cache_trace_digest", None)
    if d is None:
        h = hashlib.sha256()
        for p in g.prims:
            h.update(repr((p.pid, p.op_type, p.category, p.flops,
                           p.in_bytes, p.out_bytes, p.time, p.grad_param,
                           p.grad_bytes, p.grad_sig)).encode())
        for s, dsts in enumerate(g.psuccs):
            if dsts:
                h.update(repr((s, tuple(sorted(dsts)))).encode())
        d = h.hexdigest()
        g._cache_trace_digest = d
    return d


def graph_digest(g: FusionGraph) -> str:
    """Content address of a traced+profiled graph *and* its current
    strategy state: prim payloads (op types, flops/bytes/times, gradient
    metadata), the prim DAG's edges, and the sorted strategy signature.
    Process-stable, unlike ``fast_signature()`` (whose string components
    are salted per interpreter)."""
    h = hashlib.sha256()
    h.update(_trace_digest(g).encode())
    h.update(repr(g.signature()).encode())
    return h.hexdigest()[:20]


def knob_digest(*, alpha: float, beta: int, unchanged_limit: int,
                max_steps: int | None, methods: Sequence[str] | None,
                seed: int) -> str:
    """Digest of the trajectory-determining search hyper-parameters.
    ``workers`` is deliberately absent — candidate evaluation order does
    not change the RNG stream or the winner."""
    return _sha({
        "alpha": float(alpha), "beta": int(beta),
        "unchanged_limit": int(unchanged_limit),
        "max_steps": None if max_steps is None else int(max_steps),
        "methods": None if methods is None else list(methods),
        "seed": int(seed),
    })


def _context_parts(sim) -> dict:
    """The pricing context a Simulator bakes into candidate costs: cluster
    fingerprint, stream count, background classes, pipeline schedule,
    compute Hardware and estimator provenance."""
    hw = getattr(sim, "hw", None)
    pp = getattr(sim, "pipeline", None)
    est = getattr(sim, "estimator", None)
    parts = {
        "cluster": cluster_fingerprint(sim.cluster),
        "streams": int(getattr(sim, "streams", 1)),
        "background": [
            (b.traffic_class, float(b.nbytes), float(b.period), b.algo,
             b.kind, float(b.offset), b.count)
            for b in getattr(sim, "background", ())
        ],
        "pipeline": None if pp is None else list(pp.to_tuple()),
        "hw": None if hw is None else sorted(dataclasses.asdict(hw).items()),
        "estimator": estimator_name(est),
        # the in-kernel overlap discount changes every fused bucket's price,
        # so two sims differing only in calibration must not share entries
        "overlap_discount": float(getattr(sim, "overlap_discount", 0.0)),
    }
    # added only when present so every pre-v3 compile point keeps its
    # historical cache key (tp=None / level_chunks=False sims digest
    # exactly as before)
    tp = getattr(sim, "tp", None)
    if tp is not None:
        parts["tp"] = list(tp.to_tuple())
    if getattr(sim, "level_chunks", False):
        parts["level_chunks"] = True
    # a learned estimator's predictions depend on its weights: two
    # differently trained ones must not share entries (oracle keys keep
    # the reference's value)
    if hasattr(est, "fingerprint"):
        parts["estimator_fingerprint"] = est.fingerprint()
    return parts


def compile_key(graph: FusionGraph, sim, knobs: str, *,
                digest: str | None = None) -> str:
    """The cache key of one ``compile()`` point: graph content-signature x
    cluster/pricing fingerprint x search-knob digest.  ``digest`` lets a
    caller that already computed :func:`graph_digest` pass it in."""
    return _sha({
        "graph": digest or graph_digest(graph),
        "context": _context_parts(sim),
        "knobs": knobs,
    })


# ------------------------------------------------------- similarity ranking
def cache_features(graph: FusionGraph, sim, *, arch: str | None = None,
                   knobs: str | None = None,
                   digest: str | None = None) -> dict:
    """The similarity coordinates of one compile point (recorded per entry
    at ``put`` time, recomputed for the request on a miss)."""
    spec: ClusterSpec = sim.cluster
    if spec.is_flat_compat:
        levels, bws = ["flat"], [float(spec.compat_hw.ici_bw)]
    else:
        levels = [l.name for l in spec.levels]
        bws = [float(l.bandwidth) for l in spec.levels]
    return {
        "graph": digest or graph_digest(graph),
        "arch": arch,
        "grad_bytes": float(sum(graph.bucket_bytes(b) for b in graph.buckets)),
        "grad_tensors": len(graph.grad_prim),
        "cluster": _sha(cluster_fingerprint(spec)),
        "cluster_name": spec.name,
        "n_devices": int(spec.n_devices),
        "levels": levels,
        "level_bw": bws,
        "streams": int(getattr(sim, "streams", 1)),
        "pipeline": (None if getattr(sim, "pipeline", None) is None
                     else list(sim.pipeline.to_tuple())),
        "tp": (None if getattr(sim, "tp", None) is None
               else list(sim.tp.to_tuple())),
        "knobs": knobs,
    }


def _ratio_closeness(a: float, b: float) -> float:
    """1.0 when equal, decaying toward 0 as the ratio diverges."""
    if a <= 0 or b <= 0:
        return 1.0 if a == b else 0.0
    r = a / b if a < b else b / a
    return r


def similarity(req: dict, ent: dict) -> float:
    """Score a cached entry against a request.  Dominant terms first: the
    exact traced graph (same arch *and* shapes), then the arch family, then
    cluster identity/structure, then the pricing knobs.  A plan from a
    different trace family can still rank (its strategy may not re-apply —
    the warm-start ladder just falls through to the next candidate)."""
    s = 0.0
    if req["graph"] == ent.get("graph"):
        s += 8.0
    if req.get("arch") and req["arch"] == ent.get("arch"):
        s += 4.0
    elif req.get("grad_tensors") == ent.get("grad_tensors"):
        s += 1.0
    s += 2.0 * _ratio_closeness(req.get("grad_bytes", 0.0),
                                ent.get("grad_bytes", 0.0))
    if req["cluster"] == ent.get("cluster"):
        s += 4.0
    else:
        if req.get("levels") == ent.get("levels"):
            s += 1.0
        elif len(req.get("levels", ())) == len(ent.get("levels", ())):
            s += 0.5
        s += _ratio_closeness(req.get("n_devices", 0),
                              ent.get("n_devices", 0))
        bw_a, bw_b = req.get("level_bw") or [], ent.get("level_bw") or []
        if bw_a and bw_b:
            s += _ratio_closeness(min(bw_a), min(bw_b))
    if req.get("streams") == ent.get("streams"):
        s += 1.0
    if req.get("pipeline") == ent.get("pipeline"):
        s += 0.5
    if req.get("tp") == ent.get("tp"):
        s += 0.5
    if req.get("knobs") and req["knobs"] == ent.get("knobs"):
        s += 0.5
    return s


def rank_entries(req: dict, entries: Iterable[dict]) -> list[tuple[float, dict]]:
    """Cached entries most-similar-first.  Ties break on recency so a
    re-searched point shadows its stale ancestor."""
    scored = [(similarity(req, e), e) for e in entries]
    scored.sort(key=lambda t: (-t[0], -t[1].get("created", 0.0),
                               t[1].get("key", "")))
    return scored


# -------------------------------------------------- warm-start re-application
def warm_start_state(plan: Plan, base: FusionGraph, sim) -> FusionGraph | None:
    """Re-apply a cached plan's strategy onto a fresh traced graph as a
    search start state.  ``Plan.to_graph`` rebuilds the op/tensor-fusion
    state; the mutation registry's applicability contract then resets the
    per-bucket dimensions this ``sim`` cannot price (a serialized channel
    ignores comm-kind/chunk flips, a flat spec is algorithm-blind) through
    the same ``set_bucket_*`` mutations the search would use, so the state
    is journal/rolling-hash consistent.  Returns None when the plan does
    not fit the trace — the caller falls back down the ladder."""
    if not hasattr(plan, "to_graph"):
        # not a training plan (e.g. a ServingPlan sharing the cache): there
        # is no fusion state to re-apply, so no warm start
        return None
    try:
        g = plan.to_graph(base)
    except PlanError:
        return None
    active = set(active_methods(sim))
    for i in range(len(g.buckets)):
        if METHOD_ALGO not in active:
            g.set_bucket_algo(i, "ring")
        if METHOD_COMM not in active:
            g.set_bucket_comm(i, "ar")
        if METHOD_CHUNK not in active:
            g.set_bucket_chunks(i, 1)
        if METHOD_FUSED not in active:
            g.set_bucket_fused(i, False)
    if METHOD_PP_SPLIT not in active:
        # the target sim cannot price pipeline knobs (no pipeline
        # schedule): carrying a donor plan's overrides would be inert
        # state that pollutes signatures and re-saved plans
        g.reset_pp_knobs()
    return g


def _load_artifact(path: str):
    """Load a cached artifact by schema: training ``Plan`` (the default)
    or a serving plan (``repro.serving_plan``).  The schema peek keeps the
    two families in one store without either loader having to tolerate the
    other's JSON; any read/parse failure surfaces as ``PlanError`` so the
    cache's corruption-tolerance contract is unchanged."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise PlanError(f"unreadable plan artifact at {path}: {e}") from e
    if isinstance(doc, dict) and doc.get("schema") == "repro.serving_plan":
        from ..serving.plan import ServingPlan  # import-light, no torch
        return ServingPlan.from_dict(doc)
    return Plan.from_dict(doc, source=path)


# ---------------------------------------------------------------- the cache
def _atomic_write_json(path: str, obj) -> None:
    """Torn-write-proof JSON write: temp file in the same directory +
    ``os.replace`` (the same discipline as ``Plan.save``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


class PlanCache:
    """Content-addressed on-disk store of Plan artifacts.

    Layout: ``<root>/index.json`` (entry metadata: key, similarity
    features, predicted time, creation time) plus one
    ``<root>/<key>.plan.json`` per entry — the Plan JSON itself, loadable
    by ``Plan.load`` without the cache.

    Every load is corruption-tolerant: a truncated/foreign/mismatched
    entry counts as ``stale`` and behaves as a miss, never a crash.  An
    unreadable index is rebuilt from a directory scan.  Writers are
    crash/concurrency-safe by atomic replace — two processes putting the
    same key leave a readable index and a complete plan file (last writer
    wins).  ``capacity`` bounds the entry count: puts beyond it evict the
    oldest entries first.
    """

    def __init__(self, root: str, capacity: int | None = None):
        self.root = str(root)
        self.capacity = capacity
        os.makedirs(self.root, exist_ok=True)
        self.stats = {"hits": 0, "misses": 0, "stale": 0, "puts": 0,
                      "evictions": 0, "warm_starts": 0}

    # ------------------------------------------------------------- index IO
    def _index_path(self) -> str:
        return os.path.join(self.root, INDEX_NAME)

    def _read_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                d = json.load(f)
            if (isinstance(d, dict) and d.get("version") == INDEX_VERSION
                    and isinstance(d.get("entries"), dict)):
                return d
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            pass
        # missing or corrupt index: rebuild from the plan files on disk so
        # a torn index write never strands valid entries
        entries = {}
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(PLAN_SUFFIX):
                continue
            key = name[:-len(PLAN_SUFFIX)]
            try:
                plan = _load_artifact(os.path.join(self.root, name))
            except PlanError:
                continue
            entries[key] = {
                "key": key,
                "created": 0.0,
                "predicted_s": plan.predicted_iteration_time,
                "rebuilt": True,
                **{k: v for k, v in plan.provenance.get(
                    "cache_features", {}).items()},
            }
        return {"version": INDEX_VERSION, "entries": entries}

    def _write_index(self, index: dict) -> None:
        _atomic_write_json(self._index_path(), index)

    def _plan_path(self, key: str) -> str:
        return os.path.join(self.root, key + PLAN_SUFFIX)

    # ------------------------------------------------------------ get / put
    def get(self, key: str) -> Plan | None:
        """Exact-key lookup.  A present-but-unreadable entry (torn write,
        foreign schema, truncated vectors) is counted ``stale`` and
        reported as a miss."""
        path = self._plan_path(key)
        if not os.path.exists(path):
            self.stats["misses"] += 1
            return None
        try:
            plan = _load_artifact(path)
        except PlanError:
            self.stats["stale"] += 1
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return plan

    def put(self, key: str, plan: Plan, features: dict | None = None) -> None:
        """Store a plan under ``key``.  The plan file is written first
        (atomically), then the index — a crash between the two leaves a
        valid plan the index rebuild will recover."""
        feats = dict(features or {})
        # ride the features inside the artifact too, so index rebuilds
        # recover the similarity coordinates
        plan.provenance.setdefault("cache_features", feats)
        plan.save(self._plan_path(key))
        index = self._read_index()
        index["entries"][key] = {
            "key": key,
            "created": time.time(),
            "predicted_s": plan.predicted_iteration_time,
            **feats,
        }
        self.stats["puts"] += 1
        if self.capacity is not None and len(index["entries"]) > self.capacity:
            excess = sorted(index["entries"].values(),
                            key=lambda e: (e.get("created", 0.0),
                                           e.get("key", "")))
            for e in excess[:len(index["entries"]) - self.capacity]:
                self._drop(index, e["key"])
                self.stats["evictions"] += 1
        self._write_index(index)

    def _drop(self, index: dict, key: str) -> None:
        index["entries"].pop(key, None)
        try:
            os.remove(self._plan_path(key))
        except OSError:
            pass

    # --------------------------------------------------------------- queries
    def entries(self) -> list[dict]:
        """Index metadata, oldest first."""
        ents = list(self._read_index()["entries"].values())
        ents.sort(key=lambda e: (e.get("created", 0.0), e.get("key", "")))
        return ents

    def __len__(self) -> int:
        return len(self._read_index()["entries"])

    def nearest(self, features: dict, *, exclude: str | None = None,
                limit: int = 3) -> list[tuple[float, dict, Plan]]:
        """The ``limit`` most similar *loadable* entries to ``features``,
        most-similar-first, each with its loaded Plan.  Unloadable entries
        are skipped (counted ``stale``); ``exclude`` drops the request's
        own key so a near-miss never warm-starts from itself."""
        out: list[tuple[float, dict, Plan]] = []
        for score, ent in rank_entries(features, self.entries()):
            key = ent.get("key")
            if not key or key == exclude:
                continue
            try:
                plan = _load_artifact(self._plan_path(key))
            except PlanError:
                self.stats["stale"] += 1
                continue
            out.append((score, ent, plan))
            if len(out) >= limit:
                break
        return out

    # ----------------------------------------------------------- maintenance
    def verify(self) -> dict:
        """Re-load every indexed entry; report (and optionally let
        ``prune`` drop) the corrupt ones, plus plan files the index does
        not know about."""
        index = self._read_index()
        ok, corrupt = [], []
        for key in sorted(index["entries"]):
            try:
                _load_artifact(self._plan_path(key))
                ok.append(key)
            except PlanError as e:
                corrupt.append({"key": key, "error": str(e)})
        known = {k + PLAN_SUFFIX for k in index["entries"]}
        orphans = sorted(
            n for n in os.listdir(self.root)
            if n.endswith(PLAN_SUFFIX) and n not in known)
        return {"entries": len(index["entries"]), "ok": len(ok),
                "corrupt": corrupt, "orphans": orphans}

    def prune(self, *, max_entries: int | None = None,
              max_age_s: float | None = None,
              drop_corrupt: bool = True) -> dict:
        """Evict: corrupt entries (always a miss anyway), entries older
        than ``max_age_s``, then the oldest beyond ``max_entries``."""
        index = self._read_index()
        dropped: list[str] = []
        if drop_corrupt:
            for item in self.verify()["corrupt"]:
                self._drop(index, item["key"])
                dropped.append(item["key"])
        if max_age_s is not None:
            cutoff = time.time() - max_age_s
            for e in list(index["entries"].values()):
                if e.get("created", 0.0) < cutoff:
                    self._drop(index, e["key"])
                    dropped.append(e["key"])
        if max_entries is not None and len(index["entries"]) > max_entries:
            excess = sorted(index["entries"].values(),
                            key=lambda e: (e.get("created", 0.0),
                                           e.get("key", "")))
            for e in excess[:len(index["entries"]) - max_entries]:
                self._drop(index, e["key"])
                dropped.append(e["key"])
        self.stats["evictions"] += len(dropped)
        self._write_index(index)
        return {"dropped": dropped, "remaining": len(index["entries"])}

    def describe(self) -> dict:
        ents = self.entries()
        return {
            "root": self.root,
            "entries": len(ents),
            "archs": sorted({e.get("arch") for e in ents
                             if e.get("arch")}),
            "clusters": sorted({e.get("cluster_name") for e in ents
                                if e.get("cluster_name")}),
            "stats": dict(self.stats),
        }


def open_cache(cache) -> PlanCache | None:
    """Normalize ``compile(cache=...)``'s argument: a PlanCache, a
    directory path, or None."""
    if cache is None or isinstance(cache, PlanCache):
        return cache
    if isinstance(cache, (str, os.PathLike)):
        return PlanCache(os.fspath(cache))
    raise TypeError(f"cache must be a PlanCache or a directory path, "
                    f"got {type(cache).__name__}")


# --------------------------------------------------------------------- CLI
def _cmd_ls(cache: PlanCache) -> int:
    ents = cache.entries()
    if not ents:
        print(f"{cache.root}: empty cache")
        return 0
    for e in ents:
        created = (time.strftime("%Y-%m-%d %H:%M:%S",
                                 time.localtime(e["created"]))
                   if e.get("created") else "<rebuilt>")
        pred = e.get("predicted_s")
        pred_s = f"{pred*1e3:9.3f} ms" if pred is not None else "        ?"
        print(f"  {e['key']}  {created}  {pred_s}  "
              f"{e.get('arch') or '?':24s} {e.get('cluster_name') or '?'}")
    print(f"{len(ents)} entries in {cache.root}")
    return 0


def _cmd_stats(cache: PlanCache) -> int:
    print(json.dumps(cache.describe(), indent=1))
    return 0


def _cmd_verify(cache: PlanCache) -> int:
    rep = cache.verify()
    print(json.dumps(rep, indent=1))
    return 1 if rep["corrupt"] else 0


def _cmd_prune(cache: PlanCache, max_entries, max_age_s) -> int:
    rep = cache.prune(max_entries=max_entries, max_age_s=max_age_s)
    print(f"dropped {len(rep['dropped'])} entries, "
          f"{rep['remaining']} remaining")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan.cache",
        description="inspect / maintain a repro.plan cache directory")
    ap.add_argument("cmd", choices=("ls", "stats", "prune", "verify"))
    ap.add_argument("--dir", default=".plan-cache",
                    help="cache directory (default .plan-cache)")
    ap.add_argument("--max-entries", type=int, default=None,
                    help="prune: keep at most this many entries")
    ap.add_argument("--max-age-s", type=float, default=None,
                    help="prune: drop entries older than this many seconds")
    args = ap.parse_args(argv)
    cache = PlanCache(args.dir)
    if args.cmd == "ls":
        return _cmd_ls(cache)
    if args.cmd == "stats":
        return _cmd_stats(cache)
    if args.cmd == "verify":
        return _cmd_verify(cache)
    return _cmd_prune(cache, args.max_entries, args.max_age_s)


if __name__ == "__main__":
    raise SystemExit(main())
