"""Fusion IR — the joint op/tensor-fusion strategy state DisCo searches over
(port of ``repro/core/graph.py``).

One deliberate difference from the reference: ``_group_key`` is the
group's content, ``(min member pid, sorted members, sorted provided
pids)``, where the reference keeps the min member pid alone.  Duplicate
fusion lets two groups share a min pid; the reference then breaks the tie
by gid, which a Plan's round trip renumbers, so a rebuilt graph could price
differently.  Content breaks every such tie the same way in both graphs.
The key is computed once per group, when the group is made.

The IR has two levels:

* **Primitive level** (immutable): ``PrimOp`` nodes and dependency edges, as
  extracted from a traced step by :mod:`repro_torch.core.trace` (or built
  synthetically).  A prim that produces a parameter gradient carries
  ``grad_param >= 0`` and ``grad_bytes > 0`` — its tensor must be
  AllReduced in data-parallel training.

* **Fusion state** (mutable): a partition of prims into *groups* (fused ops).
  Duplicate fusion (paper Fig. 1(iii)) lets a prim be a member of several
  groups; exactly one group is its *provider* — the occurrence whose
  completion makes the prim's output available to external consumers.
  AllReduce instructions are partitioned into *buckets* (tensor fusion);
  each bucket additionally carries a *collective algorithm* choice
  (``bucket_algos``: ring / tree / hier, priced by :mod:`repro_torch.cluster`)
  and a *communication kind* (``bucket_comm``: one fused AllReduce, or
  ZeRO-3-style reduce-scatter + all-gather priced per link level by the
  event engine — DESIGN.md Sec. 8).

Mutations (`fuse_nondup`, `fuse_dup`, `merge_buckets`) are the paper's three
optimisation methods (Sec. 4.5); each validates DAG-ness of the quotient
graph and op fusibility before committing.  ``set_bucket_algo`` is the
cluster extension's fourth method, ``set_bucket_comm`` the event-engine
extension's fifth, and ``set_bucket_chunks`` (store-and-forward chunk
count, ``bucket_chunks``) the sixth: the search is joint over op fusion x
tensor fusion x collective algorithm x comm kind x chunking (DESIGN.md
Sec. 7-9).  Each dimension is registered as a declarative
:class:`repro_torch.core.mutations.Mutation` (name, random application,
per-simulator applicability) — the searched strategy state here plus that
registry is everything :class:`repro_torch.plan.Plan` serializes (DESIGN.md
Sec. 10).

Incremental invariants
----------------------

The quotient DAG (``_qsuccs``/``_qpreds``) is maintained *incrementally*
across mutations rather than rebuilt from the prim DAG per candidate:

* An op-fusion mutation merging groups ``c``/``p`` into a fresh gid ``G``
  patches only the neighbourhoods of ``c``, ``p`` and ``G``: out-edges are
  renamed ``c/p -> G``, and ``G``'s in-edges are recomputed by scanning the
  merged members' external predecessors (the only part whose edge set can
  *shrink* — a prim consumed from another group may become internal to ``G``
  under duplicate fusion).
* All updates are copy-on-write: modified adjacency sets are replaced, never
  mutated in place, so ``clone()`` can share the quotient structures between
  a graph and its descendants.
* Acyclicity is enforced with a targeted DFS: a mutation can only create a
  cycle through the new group ``G``, so we search ``G``'s successors for a
  path back to ``G`` instead of re-checking the whole DAG.
* ``_group_key`` (the content key, the simulator tie-break), ``_provided``
  (pids each group provides) and the rolling signature hash are updated in
  O(|merged group|) at commit time.

Every committed mutation appends a record to ``_journal`` (relative to
``_base_token``, the id of the last simulator state computed for an ancestor
of this graph).  :class:`repro_torch.core.simulator.Simulator` uses the journal to
re-simulate only the suffix of the schedule a mutation can affect; see the
module docstring there for the exact divergence-bound argument.

``signature()`` is the seed's full sorted fingerprint (kept for tests and
strategy serialization); ``fast_signature()`` is the rolling 64-bit hash
maintained by the mutations, used for search memoisation.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

# Op-type categories used for fusibility and the XLA-like baseline heuristic.
EW = "ew"            # elementwise / injective
REDUCE = "reduce"
DOT = "dot"
LAYOUT = "layout"    # reshape/transpose/broadcast/convert
OPAQUE = "opaque"    # scan/while/custom-call/sort/rng — never fused

FUSIBLE = {EW, REDUCE, DOT, LAYOUT}

_MASK64 = (1 << 64) - 1

# Distinguishes graph "families" (trace/profile lineages) so estimator caches
# keyed on group membership cannot alias across graphs whose prims carry
# different flops/bytes for the same pids.
_family_counter = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class PrimOp:
    pid: int
    op_type: str          # primitive name, e.g. "dot_general", "mul"
    category: str         # one of EW/REDUCE/DOT/LAYOUT/OPAQUE
    flops: float
    in_bytes: float       # bytes read from its inputs (standalone)
    out_bytes: float      # bytes written (standalone)
    time: float           # profiled standalone execution time (seconds)
    grad_param: int = -1  # index of the gradient leaf it produces, or -1
    grad_bytes: float = 0.0
    # partition signature of the gradient (tensor fusion may only merge
    # gradients reduced over the same axes / of the same dtype family).
    grad_sig: str = ""

    @property
    def fusible(self) -> bool:
        return self.category in FUSIBLE


def _group_hash(members: frozenset[int], provided: frozenset[int]) -> int:
    return hash((tuple(sorted(members)), tuple(sorted(provided)))) & _MASK64


def _content_key(members: frozenset[int], provided: frozenset[int]) -> tuple:
    """Ready-order key of a group: min member pid first (the reference's
    key), then its sorted members and provided pids, so that groups tied
    on the min pid are ordered by what they hold, never by gid."""
    ordered = tuple(sorted(members))
    return (ordered[0], ordered, tuple(sorted(provided)))


class FusionGraph:
    """Mutable joint fusion state over an immutable prim DAG."""

    def __init__(self, prims: list[PrimOp], edges: Iterable[tuple[int, int]]):
        self.prims = list(prims)
        n = len(self.prims)
        self.psuccs: list[set[int]] = [set() for _ in range(n)]
        self.ppreds: list[set[int]] = [set() for _ in range(n)]
        for s, d in edges:
            self.psuccs[s].add(d)
            self.ppreds[d].add(s)
        # fusion state: every prim starts as a singleton group (gid == pid)
        self.groups: dict[int, frozenset[int]] = {
            p.pid: frozenset([p.pid]) for p in self.prims
        }
        self.provider: dict[int, int] = {p.pid: p.pid for p in self.prims}
        self._next_gid = n
        # tensor-fusion state: list of buckets; each bucket is an ordered
        # tuple of param indices.  Initially one bucket per gradient, in
        # topological production order.
        grads = sorted(
            (p for p in self.prims if p.grad_param >= 0), key=lambda p: p.pid
        )
        self.grad_prim: dict[int, int] = {p.grad_param: p.pid for p in grads}
        self.buckets: list[tuple[int, ...]] = [(p.grad_param,) for p in grads]
        # per-bucket collective algorithm ("ring" reproduces the seed model)
        self.bucket_algos: list[str] = ["ring"] * len(self.buckets)
        # per-bucket communication kind: fused AllReduce ("ar", the seed
        # model) or ZeRO-3-style reduce-scatter + all-gather ("rs_ag")
        self.bucket_comm: list[str] = ["ar"] * len(self.buckets)
        # per-bucket chunk count: >1 splits the fused tensor into chunks
        # that store-and-forward through the event engine's phase pipeline
        # (1, the seed model, is one whole-bucket collective)
        self.bucket_chunks: list[int] = [1] * len(self.buckets)
        # per-bucket in-kernel fusion flag: True issues the bucket's
        # collective from inside the producing kernel, reaching back into
        # the producer's tail by the cluster's calibrated overlap discount
        # (DESIGN.md Sec. 13); False is scheduled overlap (the seed model)
        self.bucket_fused: list[bool] = [False] * len(self.buckets)
        # searched pipeline-knob overrides: None (use the simulator's base
        # PipelineSchedule verbatim) or a partial (n_stages, n_microbatches,
        # interleave) tuple where None slots inherit from the base schedule
        # (resolved by repro_torch.core.pipeline.resolve_schedule).  Only priced
        # on pipeline-enabled simulators — inert state everywhere else.
        self.pp_knobs: tuple | None = None
        self._rebuild_derived()

    @classmethod
    def _from_parts(cls, prims, psuccs, ppreds, groups, provider, next_gid,
                    grad_prim, buckets, family: int | None = None,
                    bucket_algos=None, bucket_comm=None,
                    bucket_chunks=None, bucket_fused=None,
                    pp_knobs=None) -> "FusionGraph":
        """Assemble a graph from explicit state (see ``profile_graph``);
        derived structures are rebuilt from scratch.  ``family`` pins the
        estimator-cache lineage when the prims are shared with an existing
        graph (search worker pools)."""
        g = object.__new__(cls)
        g.prims = prims
        g.psuccs = psuccs
        g.ppreds = ppreds
        g.groups = dict(groups)
        g.provider = dict(provider)
        g._next_gid = next_gid
        g.grad_prim = dict(grad_prim)
        g.buckets = list(buckets)
        g.bucket_algos = (list(bucket_algos) if bucket_algos is not None
                          else ["ring"] * len(g.buckets))
        g.bucket_comm = (list(bucket_comm) if bucket_comm is not None
                         else ["ar"] * len(g.buckets))
        g.bucket_chunks = (list(bucket_chunks) if bucket_chunks is not None
                           else [1] * len(g.buckets))
        g.bucket_fused = (list(bucket_fused) if bucket_fused is not None
                          else [False] * len(g.buckets))
        g.pp_knobs = None if pp_knobs is None else tuple(pp_knobs)
        g._rebuild_derived()
        if family is not None:
            g._family = family
        return g

    # -------------------------------------------------- derived structures
    def _rebuild_derived(self) -> None:
        """(Re)compute every derived structure from (prims, edges, groups,
        provider).  O(total membership x degree) — used only at construction;
        mutations keep the structures up to date incrementally."""
        self._qsuccs, self._qpreds = self._quotient_from_scratch()
        provided: dict[int, set[int]] = {gid: set() for gid in self.groups}
        for pid, gid in self.provider.items():
            provided[gid].add(pid)
        self._provided: dict[int, frozenset[int]] = {
            gid: frozenset(s) for gid, s in provided.items()
        }
        self._group_key: dict[int, tuple] = {
            gid: _content_key(m, self._provided[gid])
            for gid, m in self.groups.items()
        }
        self._group_hash: dict[int, int] = {
            gid: _group_hash(m, self._provided[gid])
            for gid, m in self.groups.items()
        }
        self._ghash: int = sum(self._group_hash.values()) & _MASK64
        self._bucket_bytes_cache: dict[tuple[int, ...], float] = {}
        self._family: int = next(_family_counter)
        self._journal: list[tuple] = []
        self._base_token: int | None = None

    def _quotient_from_scratch(
        self,
    ) -> tuple[dict[int, set[int]], dict[int, set[int]]]:
        """The seed's full O(membership x degree) quotient rebuild.  Kept as
        the reference implementation: construction uses it, and the golden
        equivalence tests cross-check the incrementally maintained quotient
        against it after every mutation."""
        succs: dict[int, set[int]] = {g: set() for g in self.groups}
        preds: dict[int, set[int]] = {g: set() for g in self.groups}
        for gid, members in self.groups.items():
            for pid in members:
                for q in self.ppreds[pid]:
                    if q not in members:
                        src = self.provider[q]
                        if src != gid:
                            succs[src].add(gid)
                            preds[gid].add(src)
        return succs, preds

    # ------------------------------------------------------------------ util
    def clone(self) -> "FusionGraph":
        g = object.__new__(FusionGraph)
        g.prims = self.prims                  # immutable, shared
        g.psuccs = self.psuccs
        g.ppreds = self.ppreds
        g.groups = dict(self.groups)
        g.provider = dict(self.provider)
        g._next_gid = self._next_gid
        g.grad_prim = self.grad_prim
        g.buckets = list(self.buckets)
        g.bucket_algos = list(self.bucket_algos)
        g.bucket_comm = list(self.bucket_comm)
        g.bucket_chunks = list(self.bucket_chunks)
        g.bucket_fused = list(self.bucket_fused)
        g.pp_knobs = self.pp_knobs            # immutable tuple or None
        # quotient structures are shared: mutations are copy-on-write (they
        # replace modified adjacency sets, never mutate them in place)
        g._qsuccs = self._qsuccs
        g._qpreds = self._qpreds
        g._group_key = dict(self._group_key)
        g._provided = dict(self._provided)
        g._group_hash = dict(self._group_hash)
        g._ghash = self._ghash
        g._bucket_bytes_cache = self._bucket_bytes_cache  # content-keyed
        g._family = self._family
        g._journal = list(self._journal)
        g._base_token = self._base_token
        return g

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_key(self, gid: int) -> frozenset[int]:
        return self.groups[gid]

    def family_token(self) -> int:
        """Identity of this graph's prim/edge lineage (shared by clones,
        fresh after re-profiling) — estimator cache-key component."""
        return self._family

    def provided_set(self, gid: int) -> frozenset[int]:
        """Members of ``gid`` whose outputs this group provides externally."""
        return self._provided[gid]

    # --------------------------------------------------------- quotient DAG
    def quotient(self) -> tuple[dict[int, set[int]], dict[int, set[int]]]:
        """Edges between groups: provider(q) -> G for q consumed by G from
        outside G.  Returns (succs, preds) keyed by gid.  Maintained
        incrementally by the mutations — this accessor is O(1)."""
        return self._qsuccs, self._qpreds

    @staticmethod
    def _cycle_through(succs: dict[int, set[int]], preds: dict[int, set[int]],
                       gs: set[int], gp: set[int], new_gid: int) -> bool:
        """Targeted cycle probe: after the merge, a cycle must pass through
        ``new_gid``, i.e. some successor in ``gs`` must reach some
        predecessor in ``gp``.  Bidirectional search with exhaustion stop —
        whichever of the downstream cone of ``gs`` / upstream cone of ``gp``
        is smaller bounds the work (a merge near either end of the DAG
        probes only the short side)."""
        seen_f = set(gs)
        seen_b = set(gp)
        if seen_f & seen_b:
            return True
        stack_f = list(gs)
        stack_b = list(gp)
        while stack_f and stack_b:
            if len(stack_f) <= len(stack_b):
                x = stack_f.pop()
                for d in succs[x]:
                    if d in seen_b:
                        return True
                    if d not in seen_f and d != new_gid:
                        seen_f.add(d)
                        stack_f.append(d)
            else:
                x = stack_b.pop()
                for d in preds[x]:
                    if d in seen_f:
                        return True
                    if d not in seen_b and d != new_gid:
                        seen_b.add(d)
                        stack_b.append(d)
        # one side exhausted without meeting the other: no gs ~> gp path
        return False

    def topo_groups(self) -> list[int]:
        succs, preds = self.quotient()
        indeg = {g: len(ps) for g, ps in preds.items()}
        # deterministic: prefer smaller min-member pid first
        import heapq

        key = self._group_key
        heap = [(key[g], g) for g, k in indeg.items() if k == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            _, g = heapq.heappop(heap)
            order.append(g)
            for d in succs[g]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    heapq.heappush(heap, (key[d], d))
        if len(order) != len(self.groups):
            raise RuntimeError("quotient graph is cyclic")
        return order

    # ----------------------------------------------------------- mutations
    def _fusible_group(self, gid: int) -> bool:
        return all(self.prims[p].fusible for p in self.groups[gid])

    def group_preds(self, gid: int) -> set[int]:
        return self._qpreds[gid]

    def group_succs(self, gid: int) -> set[int]:
        return self._qsuccs[gid]

    def _merged_quotient(
        self, removed: tuple[int, ...], merged: frozenset[int], new_gid: int
    ) -> tuple[dict, dict, set[int]] | None:
        """Copy-on-write quotient after replacing ``removed`` groups with the
        group ``new_gid`` = ``merged``.  Returns (succs, preds, preds_of_new)
        or None when the merge would create a cycle."""
        rm = set(removed)
        new_succs = dict(self._qsuccs)
        new_preds = dict(self._qpreds)
        # out-edges of the removed groups now originate from new_gid
        gs: set[int] = set()
        for r in removed:
            gs |= self._qsuccs[r]
        gs -= rm
        for d in gs:
            new_preds[d] = (new_preds[d] - rm) | {new_gid}
        # removed groups vanish from their predecessors' succ sets
        ps: set[int] = set()
        for r in removed:
            ps |= self._qpreds[r]
        ps -= rm
        for s in ps:
            new_succs[s] = new_succs[s] - rm
        # in-edges of the merged group: scan member externals — a prim that
        # used to be consumed across groups may now be internal to the merge
        gp: set[int] = set()
        provider = self.provider
        ppreds = self.ppreds
        for pid in merged:
            for q in ppreds[pid]:
                if q not in merged:
                    gp.add(provider[q])
        # no member of rm can appear in gp: provider[q] is a group containing
        # q, and q lies outside the merge while rm's members are all inside
        for s in gp:
            new_succs[s] = new_succs[s] | {new_gid}
        new_succs[new_gid] = gs
        new_preds[new_gid] = gp
        for r in removed:
            del new_succs[r], new_preds[r]
        # a new cycle must pass through new_gid: targeted reachability probe
        if self._cycle_through(new_succs, new_preds, gs, gp, new_gid):
            return None
        return new_succs, new_preds, gp

    def _commit_merge(self, removed: tuple[int, ...], merged: frozenset[int],
                      new_gid: int, new_succs: dict, new_preds: dict) -> None:
        self._qsuccs = new_succs
        self._qpreds = new_preds
        prov: set[int] = set()
        for r in removed:
            prov |= self._provided[r]
            del self.groups[r], self._provided[r], self._group_key[r]
            self._ghash = (self._ghash - self._group_hash.pop(r)) & _MASK64
        self.groups[new_gid] = merged
        provided = frozenset(prov)
        self._provided[new_gid] = provided
        for pid in provided:
            self.provider[pid] = new_gid
        self._group_key[new_gid] = _content_key(merged, provided)
        h = _group_hash(merged, provided)
        self._group_hash[new_gid] = h
        self._ghash = (self._ghash + h) & _MASK64
        self._next_gid = new_gid + 1
        self._journal.append(("fuse", removed, new_gid, frozenset(new_preds[new_gid])))

    def fuse_nondup(self, consumer: int, producer: int) -> bool:
        """Paper method (i): merge producer group into consumer group.
        Returns False (state unchanged) if invalid."""
        if consumer == producer:
            return False
        if consumer not in self.groups or producer not in self.groups:
            return False
        if not (self._fusible_group(consumer) and self._fusible_group(producer)):
            return False
        if producer not in self._qpreds[consumer]:
            return False
        merged = self.groups[consumer] | self.groups[producer]
        q = self._merged_quotient((consumer, producer), merged, self._next_gid)
        if q is None:
            return False
        new_succs, new_preds, _ = q
        self._commit_merge((consumer, producer), merged, self._next_gid,
                           new_succs, new_preds)
        return True

    def fuse_dup(self, consumer: int, producer: int) -> bool:
        """Paper method (ii): copy producer group's members into consumer
        group; the original producer group remains and keeps providing the
        outputs to its other successors (duplicate fusion, Fig. 1(iii))."""
        if consumer == producer:
            return False
        if consumer not in self.groups or producer not in self.groups:
            return False
        if not (self._fusible_group(consumer) and self._fusible_group(producer)):
            return False
        if producer not in self._qpreds[consumer]:
            return False
        merged = self.groups[consumer] | self.groups[producer]
        if merged == self.groups[consumer]:
            return False
        # Only the consumer group is replaced; the producer group remains and
        # its members keep their provider (duplicate copies are internal).
        q = self._merged_quotient((consumer,), merged, self._next_gid)
        if q is None:
            return False
        new_succs, new_preds, _ = q
        self._commit_merge((consumer,), merged, self._next_gid,
                           new_succs, new_preds)
        return True

    def merge_buckets(self, i: int, j: int) -> bool:
        """Paper method (iii): combine two *neighbouring* AllReduce buckets.
        Buckets are kept in gradient-production (topo) order; neighbours are
        adjacent buckets whose gradients share a compatible partition
        signature."""
        if i == j or not (0 <= i < len(self.buckets) and 0 <= j < len(self.buckets)):
            return False
        if abs(i - j) != 1:
            return False
        a, b = self.buckets[min(i, j)], self.buckets[max(i, j)]
        sig_a = self.prims[self.grad_prim[a[0]]].grad_sig
        sig_b = self.prims[self.grad_prim[b[0]]].grad_sig
        if sig_a != sig_b:
            return False
        lo = min(i, j)
        self.buckets[lo : lo + 2] = [a + b]
        # the merged bucket keeps the leading bucket's algorithm, comm kind,
        # chunk count and in-kernel fusion flag
        self.bucket_algos[lo : lo + 2] = [self.bucket_algos[lo]]
        self.bucket_comm[lo : lo + 2] = [self.bucket_comm[lo]]
        self.bucket_chunks[lo : lo + 2] = [self.bucket_chunks[lo]]
        self.bucket_fused[lo : lo + 2] = [self.bucket_fused[lo]]
        self._journal.append(("bucket", lo))
        return True

    def set_bucket_algo(self, i: int, algo: str) -> bool:
        """Cluster-extension method (iv): pick the collective algorithm for
        bucket ``i`` (see :mod:`repro_torch.cluster.collectives`).  A no-op choice
        returns False so the search does not re-enqueue identical states."""
        from ..cluster import COLLECTIVE_ALGOS

        if algo not in COLLECTIVE_ALGOS:
            # fail at the call site, not as a KeyError deep in a (possibly
            # remote worker-pool) simulation
            raise ValueError(f"unknown collective algorithm {algo!r}; "
                             f"expected one of {COLLECTIVE_ALGOS}")
        if not 0 <= i < len(self.buckets):
            return False
        if self.bucket_algos[i] == algo:
            return False
        self.bucket_algos[i] = algo
        self._journal.append(("algo", i))
        return True

    def set_bucket_comm(self, i: int, kind: str) -> bool:
        """Event-engine method (v): pick bucket ``i``'s communication kind —
        one fused AllReduce (``"ar"``) or ZeRO-3-style reduce-scatter +
        all-gather (``"rs_ag"``), priced per link level by the event engine
        (DESIGN.md Sec. 8).  A no-op choice returns False."""
        from ..cluster import BUCKET_COMM_KINDS

        if kind not in BUCKET_COMM_KINDS:
            raise ValueError(f"unknown bucket comm kind {kind!r}; "
                             f"expected one of {BUCKET_COMM_KINDS}")
        if not 0 <= i < len(self.buckets):
            return False
        if self.bucket_comm[i] == kind:
            return False
        self.bucket_comm[i] = kind
        self._journal.append(("comm", i))
        return True

    def set_bucket_chunks(self, i: int, chunks: int) -> bool:
        """Event-engine method (vi): split bucket ``i`` into ``chunks``
        store-and-forward chunks pipelined through the link-level phases
        (DESIGN.md Sec. 9).  ``chunks=1`` is the whole-bucket collective;
        per-chunk phase coefficients sum to the unchunked ones, so the
        choice is pure scheduling.  A no-op choice returns False."""
        chunks = int(chunks)
        if chunks < 1:
            raise ValueError(f"bucket chunk count must be >= 1, got {chunks}")
        if not 0 <= i < len(self.buckets):
            return False
        if self.bucket_chunks[i] == chunks:
            return False
        self.bucket_chunks[i] = chunks
        self._journal.append(("chunk", i))
        return True

    def set_bucket_fused(self, i: int, flag: bool) -> bool:
        """Kernel method (vii): toggle in-kernel compute+comm fusion for
        bucket ``i`` (DESIGN.md Sec. 13).  A fused bucket's collective is
        issued from inside the producing kernel, so it may start
        ``discount x producer_duration`` before the producer finishes; link
        work is conserved (never a volume discount).  A no-op choice
        returns False."""
        flag = bool(flag)
        if not 0 <= i < len(self.buckets):
            return False
        if self.bucket_fused[i] == flag:
            return False
        self.bucket_fused[i] = flag
        self._journal.append(("fused", i))
        return True

    def set_pp_knobs(self, *, n_stages: int | None = None,
                     n_microbatches: int | None = None,
                     interleave: int | None = None) -> bool:
        """Pipeline method (viii): override slots of the simulator's base
        :class:`~repro_torch.core.pipeline.PipelineSchedule`.  The override is a
        partial ``(n_stages, n_microbatches, interleave)`` tuple — passing
        a slot overwrites it, omitted slots keep their current override (or
        stay inherited from the base schedule).  Resolution against the
        base — clamping, interleave divisibility — happens at pricing time
        in :func:`repro_torch.core.pipeline.resolve_schedule`, so the mutation is
        total.  Only pipeline-enabled simulators price this state; on any
        other sim it is inert (and the mutation registry never offers it
        there).  A no-op choice returns False."""
        vals = (n_stages, n_microbatches, interleave)
        for v in vals:
            if v is not None and int(v) < 1:
                raise ValueError(
                    f"pipeline knobs must be >= 1, got {vals}")
        cur = self.pp_knobs if self.pp_knobs is not None else (None,) * 3
        new = tuple(cur[k] if vals[k] is None else int(vals[k])
                    for k in range(3))
        if new == (None,) * 3 or new == self.pp_knobs:
            return False
        self.pp_knobs = new
        self._journal.append(("pp",))
        return True

    def reset_pp_knobs(self) -> bool:
        """Drop every pipeline-knob override (back to the simulator's base
        schedule).  Used by cache warm-start when the target simulator
        cannot price the pipeline dimensions.  Returns False if already
        clear."""
        if self.pp_knobs is None:
            return False
        self.pp_knobs = None
        self._journal.append(("pp",))
        return True

    # ------------------------------------------------------------ accessors
    def group_external_io(self, gid: int) -> tuple[float, float]:
        """(external input bytes, external output bytes) of a fused group —
        intermediates that stay inside the group are elided (the fusion
        memory saving of paper Sec. 2.2)."""
        members = self.groups[gid]
        in_b = 0.0
        out_b = 0.0
        for pid in members:
            p = self.prims[pid]
            ext_preds = [q for q in self.ppreds[pid] if q not in members]
            if self.ppreds[pid]:
                frac = len(ext_preds) / len(self.ppreds[pid])
                # matmul operands must be (re)streamed even when produced
                # in-group: internal elision is only partial for DOT inputs.
                if p.category == "dot":
                    frac = frac + 0.5 * (1.0 - frac)
                in_b += p.in_bytes * frac
            else:
                in_b += p.in_bytes
            # Output leaves the group iff some consumer is external (or it is
            # a graph output / gradient) AND this group is the prim's
            # provider.  A duplicated copy's output stays in-group.
            needs_out = (
                p.grad_param >= 0
                or not self.psuccs[pid]
                or any(q not in members for q in self.psuccs[pid])
            )
            if needs_out and self.provider[pid] == gid:
                out_b += p.out_bytes
        return in_b, out_b

    def group_flops(self, gid: int) -> float:
        return sum(self.prims[p].flops for p in self.groups[gid])

    def bucket_bytes(self, bucket: tuple[int, ...]) -> float:
        # content-keyed memo shared across clones (same prim lineage);
        # summation order matches the seed's left-to-right element sum
        t = self._bucket_bytes_cache.get(bucket)
        if t is None:
            t = sum(self.prims[self.grad_prim[g]].grad_bytes for g in bucket)
            self._bucket_bytes_cache[bucket] = t
        return t

    def bucket_ready_groups(self, bucket: tuple[int, ...]) -> set[int]:
        return {self.provider[self.grad_prim[g]] for g in bucket}

    def bucket_deps(self) -> list[tuple[int, ...]]:
        """Per-bucket provider groups as sorted tuples — the dependency
        edges of each bucket's comm job in the unified event engine
        (bucket ``i`` may start once every group in ``bucket_deps()[i]``
        has finished).  Index-aligned with ``self.buckets``; sorted so the
        dep tuples are deterministic regardless of set iteration order."""
        gp = self.grad_prim
        prov = self.provider
        return [tuple(sorted({prov[gp[g]] for g in b})) for b in self.buckets]

    def signature(self) -> tuple:
        """Hashable fingerprint of the strategy (for serialization-grade
        identity; ``fast_signature`` is the O(1) search-memo variant)."""
        gs = tuple(sorted(tuple(sorted(m)) for m in self.groups.values()))
        pv = tuple(sorted(self.provider.items()))
        bk = tuple(self.buckets)
        return (gs, pv, bk, tuple(self.bucket_algos),
                tuple(self.bucket_comm), tuple(self.bucket_chunks),
                tuple(self.bucket_fused), self.pp_knobs)

    def fast_signature(self) -> tuple[int, int]:
        """Order-independent rolling hash of (groups, provider, buckets,
        bucket algos, comm kinds, chunk counts), maintained by the
        mutations — O(#buckets) instead of O(V log V)."""
        return (self._ghash,
                hash((tuple(self.buckets), tuple(self.bucket_algos),
                      tuple(self.bucket_comm), tuple(self.bucket_chunks),
                      tuple(self.bucket_fused), self.pp_knobs)))

    # --------------------------------------------------------------- stats
    def describe(self) -> dict:
        return {
            "prims": len(self.prims),
            "groups": len(self.groups),
            "fused_groups": sum(1 for m in self.groups.values() if len(m) > 1),
            "duplicated_prims": sum(
                1
                for pid in range(len(self.prims))
                for gid, m in self.groups.items()
                if pid in m and self.provider[pid] != gid
            ),
            "allreduce_buckets": len(self.buckets),
            "grad_tensors": len(self.grad_prim),
            "bucket_algos": {
                a: self.bucket_algos.count(a) for a in set(self.bucket_algos)
            },
            "bucket_comm": {
                k: self.bucket_comm.count(k) for k in set(self.bucket_comm)
            },
            "bucket_chunks": {
                k: self.bucket_chunks.count(k)
                for k in set(self.bucket_chunks)
            },
            "fused_comm_buckets": sum(1 for f in self.bucket_fused if f),
            "pp_knobs": self.pp_knobs,
        }
