"""Collective-algorithm cost models over a :class:`ClusterSpec`.

Three AllReduce algorithms, each a closed-form alpha-beta cost (the level of
detail DistIR shows a strategy-ranking simulator needs — per-topology, not
per-packet):

* ``ring`` — one flat ring over all N devices.  Bandwidth-optimal volume
  ``2 (N-1)/N x`` but every one of the ``2 (N-1)`` synchronous steps is
  gated by the slowest (bottleneck) level the ring crosses.  A ring
  confined to a *single* link level is neighbour-aligned by construction
  and pays no ``contention``; a ring spanning several levels fights the
  fabric at its bottleneck.  On the flat back-compat spec the coefficients
  come straight from ``repro_torch.core.hw.ring_allreduce_coeffs`` so the cost is
  bit-identical to the paper's ``T = C x + D`` seed model.

* ``tree`` — recursive-halving reduce-scatter + recursive-doubling
  all-gather (Rabenseifner), scheduled inner-first so the large early
  exchanges stay on fast links and only ``x / N_below`` crosses each outer
  level.  ``2 log2(N)`` steps total; its long-haul pairwise exchanges are
  *not* adjacency-aligned (distance-``2^k`` partners on a torus axis, wide
  routes on an oversubscribed fat tree), so every level charges its
  ``contention`` factor, and non-power-of-two degrees pay one extra
  preparation exchange (the classic 2^k restriction).

* ``hier`` — two-level-style hierarchical AllReduce generalised to L
  levels: ring reduce-scatter inward level by level (shrinking the live
  shard by ``degree`` each time), a ring AllReduce of ``x / N_inner`` at the
  outermost level, then ring all-gathers back out.  Structured, rail-aligned
  rings are exempt from ``contention``; inter-host volume drops by the
  product of the inner degrees — why it wins whenever the outer link is the
  bottleneck (provably never worse than ``ring`` when inner levels are
  uniformly faster; see tests/test_cluster.py).  On a spec with no inner
  fan-out it degenerates to — and is priced exactly as — the flat ring.

The flat back-compat spec is **algorithm-blind**: the seed's fixed-``D``
linear model cannot distinguish algorithms, so all three degenerate to the
legacy formula there (and the search drops the algo mutation method).

Every model is linear in message size for a fixed (spec, algo), so
``allreduce_coeffs`` derives the ``(C, D)`` pair once per pair and memoises
it — ``bucket_time`` in the simulator's hot comm pass is then one
multiply-add, not a topology walk.  All models return 0.0 for empty
(<= 0 byte) transfers: an AllReduce that moves nothing costs nothing
(zero-byte-bucket fix, DESIGN.md Sec. 7).

Phase decomposition (DESIGN.md Sec. 8)
--------------------------------------

``phases(spec, algo, kind)`` decomposes a collective into the sequence of
:class:`CommPhase` steps the event engine (:mod:`repro_torch.core.events`)
schedules on per-link-level resources: hierarchical AllReduce becomes
intra-host reduce-scatter -> inter-host allreduce -> intra-host all-gather,
each phase tagged with the ``LinkLevel`` index it occupies and carrying its
own linear ``(c, d)`` pair.  Phase coefficients sum to the opaque-interval
coefficients (same physics, finer granularity), so the serialized engine
and the phase engine agree on total channel work.

Besides AllReduce (``kind="ar"``) the same machinery prices the ZeRO-3
gradient path: ``kind="rs"`` (reduce-scatter of a gradient bucket across
all devices) and ``kind="ag"`` (all-gather of the updated shard), each
exactly one half of the matching AllReduce — ring RS + ring AG equals ring
AR term by term, so the ``rs_ag`` bucket kind never gets a fictitious
discount.  ``BUCKET_COMM_KINDS`` lists the per-bucket choices the search
mutates (``FusionGraph.set_bucket_comm``).  ``kind="p2p"`` prices a
point-to-point transfer (pipeline-parallel stage boundary) as one phase on
the bottleneck level, for the event engine's ``pp`` traffic class.

``chunk_phases(spec, algo, kind, chunks)`` is the chunked variant
(DESIGN.md Sec. 9): each chunk carries the same per-byte coefficients and
``1/chunks`` of each phase latency, so per-chunk costs over ``nbytes /
chunks`` sum *exactly* to the unchunked collective — store-and-forward
chunk pipelining in the event engine is pure scheduling, never a cost-model
discount, and ``chunks=1`` returns the :func:`phases` tuple itself.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from .topology import ClusterSpec

ALGO_RING = "ring"
ALGO_TREE = "tree"
ALGO_HIER = "hier"
# order matters: best_algo ties resolve to the earliest entry (ring, the
# legacy default, wins exact ties so flat specs keep seed behaviour)
COLLECTIVE_ALGOS = (ALGO_RING, ALGO_TREE, ALGO_HIER)

DEFAULT_ALGO = ALGO_RING

# communication-op kinds a gradient bucket can use: one fused AllReduce
# (the paper's DDP path) or ZeRO-3-style reduce-scatter + all-gather
KIND_AR = "ar"
KIND_RS = "rs"
KIND_AG = "ag"
KIND_RS_AG = "rs_ag"
# point-to-point transfer (pipeline-parallel stage boundary / HLO
# collective-permute): not a bucket kind, but priced by the same phase
# machinery so PP background traffic can contend in the event engine
KIND_P2P = "p2p"
BUCKET_COMM_KINDS = (KIND_AR, KIND_RS_AG)
DEFAULT_COMM_KIND = KIND_AR
# In-kernel fused compute+comm (CoCoNet-style, DESIGN.md Sec. 13).  NOT a
# BUCKET_COMM_KINDS member: the searched flag lives in
# ``FusionGraph.bucket_fused`` so the base kind (ar / rs_ag) keeps pricing
# the wire traffic — "fused" tags phases/timeline records of buckets whose
# collective is issued from inside the producing kernel.
KIND_FUSED = "fused"


# ------------------------------------------------------------- coefficients
def _ring_coeffs(spec: ClusterSpec) -> tuple[float, float]:
    n = spec.n_devices
    spans = [l for l in spec.levels if l.degree > 1]
    if n <= 1 or not spans:
        return 0.0, 0.0
    b = spec.bottleneck()
    # a single-axis ring is neighbour traffic (dilation 1): no contention
    beta = b.beta_contended() if len(spans) > 1 else b.beta
    return (2.0 * (n - 1) / n) * beta, 2.0 * (n - 1) * b.alpha


def _tree_coeffs(spec: ClusterSpec) -> tuple[float, float]:
    if spec.n_devices <= 1:
        return 0.0, 0.0
    c = 0.0
    d_lat = 0.0
    below = 1
    for l in spec.levels:
        d = l.degree
        if d <= 1:
            continue
        beta = l.beta_contended()
        steps = math.ceil(math.log2(d))
        # volume crossing this level per device (reduce-scatter half; the
        # all-gather mirror doubles it)
        c += 2.0 * (1.0 / below - 1.0 / (below * d)) * beta
        d_lat += 2.0 * steps * l.alpha
        if d & (d - 1):  # non-power-of-two: one extra preparation exchange
            c += 2.0 * (1.0 / below) * beta
            d_lat += 2.0 * l.alpha
        below *= d
    return c, d_lat


def _hier_coeffs(spec: ClusterSpec) -> tuple[float, float]:
    if spec.n_devices <= 1:
        return 0.0, 0.0
    inner_fanout = 1
    for l in spec.levels[:-1]:
        inner_fanout *= l.degree
    if inner_fanout <= 1:
        # no inner hierarchy to exploit: "hierarchical" IS the flat ring
        # (same physical schedule, same contention) — never price it cheaper
        return _ring_coeffs(spec)
    c = 0.0
    d_lat = 0.0
    scale = 1.0  # live shard fraction after the inner reduce-scatters
    for l in spec.levels[:-1]:
        d = l.degree
        if d > 1:
            # ring reduce-scatter + all-gather at this level, (d-1) steps
            # and (d-1)/d of the live shard each way, rail-aligned
            c += 2.0 * ((d - 1) / d) * scale * l.beta
            d_lat += 2.0 * (d - 1) * l.alpha
        scale /= d
    outer = spec.levels[-1]
    h = outer.degree
    if h > 1:
        c += (2.0 * (h - 1) / h) * scale * outer.beta
        d_lat += 2.0 * (h - 1) * outer.alpha
    return c, d_lat


_COEFF_FNS = {
    ALGO_RING: _ring_coeffs,
    ALGO_TREE: _tree_coeffs,
    ALGO_HIER: _hier_coeffs,
}


@functools.lru_cache(maxsize=None)
def allreduce_coeffs(spec: ClusterSpec,
                     algo: str = DEFAULT_ALGO) -> tuple[float, float]:
    """``(C, D)`` of the linear cost ``T = C x + D`` for ``x > 0``.

    On the flat back-compat spec every algorithm returns the seed's
    ``ring_allreduce_coeffs`` pair — the legacy model is algorithm-blind,
    and ring cost stays bit-identical to ``hw.allreduce_time``."""
    if spec.compat_hw is not None:
        from ..core.hw import ring_allreduce_coeffs

        return ring_allreduce_coeffs(spec.compat_hw, spec.n_devices)
    return _COEFF_FNS[algo](spec)


def bucket_time(nbytes: float, spec: ClusterSpec,
                algo: str = DEFAULT_ALGO) -> float:
    """Cost of AllReducing one fused gradient bucket of ``nbytes`` under
    ``algo``.  Empty buckets are free."""
    if nbytes <= 0.0:
        return 0.0
    c, d = allreduce_coeffs(spec, algo)
    return c * nbytes + d


def ring_allreduce(nbytes: float, spec: ClusterSpec) -> float:
    return bucket_time(nbytes, spec, ALGO_RING)


def tree_allreduce(nbytes: float, spec: ClusterSpec) -> float:
    return bucket_time(nbytes, spec, ALGO_TREE)


def hier_allreduce(nbytes: float, spec: ClusterSpec) -> float:
    return bucket_time(nbytes, spec, ALGO_HIER)


ALGORITHMS = {
    ALGO_RING: ring_allreduce,
    ALGO_TREE: tree_allreduce,
    ALGO_HIER: hier_allreduce,
}


def best_algo(nbytes: float, spec: ClusterSpec) -> tuple[str, float]:
    """Cheapest algorithm for this message size on this topology."""
    best_name, best_t = DEFAULT_ALGO, bucket_time(nbytes, spec, DEFAULT_ALGO)
    for name in COLLECTIVE_ALGOS:
        if name == DEFAULT_ALGO:
            continue
        t = bucket_time(nbytes, spec, name)
        if t < best_t:
            best_name, best_t = name, t
    return best_name, best_t


# ------------------------------------------------------ phase decomposition
PHASE_RS = "reduce_scatter"
PHASE_AR = "allreduce"
PHASE_AG = "all_gather"
PHASE_P2P = "permute"


@dataclasses.dataclass(frozen=True)
class CommPhase:
    """One step of a collective: a linear-cost transfer occupying exactly one
    link level.  ``seconds(x)`` is the phase's duration at full level
    bandwidth; under fair-share contention the event engine stretches it."""
    kind: str     # PHASE_RS / PHASE_AR / PHASE_AG
    level: int    # index into spec.levels
    c: float      # seconds/byte at full bandwidth
    d: float      # fixed latency seconds
    # overlap discount of an in-kernel fused collective (DESIGN.md Sec. 13):
    # fraction of the *producing compute job* the transfer reaches back
    # into.  Link work (c, d) stays FULL — fusion never shrinks wire
    # traffic, it only starts it earlier — so coefficient conservation and
    # ``full_overlap_bound`` hold unchanged.  0.0 for ordinary phases.
    overlap: float = 0.0

    def seconds(self, nbytes: float) -> float:
        return self.c * nbytes + self.d


def _ring_phases(spec: ClusterSpec, kind: str) -> tuple[CommPhase, ...]:
    c, d = _ring_coeffs(spec)
    if c == 0.0 and d == 0.0:
        return ()
    b = spec.bottleneck_index()
    if kind == KIND_AR:
        return (CommPhase(PHASE_AR, b, c, d),)
    # ring reduce-scatter / all-gather: (N-1)/N volume and (N-1) steps —
    # exactly one half of the AllReduce, term by term
    pk = PHASE_RS if kind == KIND_RS else PHASE_AG
    return (CommPhase(pk, b, 0.5 * c, 0.5 * d),)


def _tree_phases(spec: ClusterSpec, kind: str) -> tuple[CommPhase, ...]:
    """Recursive-halving reduce-scatter inward / recursive-doubling
    all-gather outward; each level's contribution of ``_tree_coeffs`` splits
    half to the RS leg and half to the AG mirror."""
    if spec.n_devices <= 1:
        return ()
    rs: list[CommPhase] = []
    ag: list[CommPhase] = []
    below = 1
    for i, l in enumerate(spec.levels):
        deg = l.degree
        if deg <= 1:
            continue
        beta = l.beta_contended()
        steps = math.ceil(math.log2(deg))
        c_l = (1.0 / below - 1.0 / (below * deg)) * beta
        d_l = steps * l.alpha
        if deg & (deg - 1):
            c_l += (1.0 / below) * beta
            d_l += l.alpha
        rs.append(CommPhase(PHASE_RS, i, c_l, d_l))
        ag.append(CommPhase(PHASE_AG, i, c_l, d_l))
        below *= deg
    ag.reverse()
    if kind == KIND_RS:
        return tuple(rs)
    if kind == KIND_AG:
        return tuple(ag)
    return tuple(rs + ag)


def _hier_phases(spec: ClusterSpec, kind: str) -> tuple[CommPhase, ...]:
    """Per-level rings: reduce-scatter inward, the outermost level's
    collective on the residual shard, all-gather back outward (the phase
    sequence of ``_hier_coeffs``)."""
    if spec.n_devices <= 1:
        return ()
    inner_fanout = 1
    for l in spec.levels[:-1]:
        inner_fanout *= l.degree
    if inner_fanout <= 1:
        return _ring_phases(spec, kind)  # no inner hierarchy: IS the flat ring
    rs: list[CommPhase] = []
    ag: list[CommPhase] = []
    scale = 1.0
    for i, l in enumerate(spec.levels[:-1]):
        deg = l.degree
        if deg > 1:
            c_l = ((deg - 1) / deg) * scale * l.beta
            d_l = (deg - 1) * l.alpha
            rs.append(CommPhase(PHASE_RS, i, c_l, d_l))
            ag.append(CommPhase(PHASE_AG, i, c_l, d_l))
        scale /= deg
    ag.reverse()
    outer = spec.levels[-1]
    oi = len(spec.levels) - 1
    h = outer.degree
    mid: list[CommPhase] = []
    if h > 1:
        c_o = ((h - 1) / h) * scale * outer.beta
        d_o = (h - 1) * outer.alpha
        if kind == KIND_AR:
            mid = [CommPhase(PHASE_AR, oi, 2.0 * c_o, 2.0 * d_o)]
        elif kind == KIND_RS:
            mid = [CommPhase(PHASE_RS, oi, c_o, d_o)]
        else:
            mid = [CommPhase(PHASE_AG, oi, c_o, d_o)]
    if kind == KIND_RS:
        return tuple(rs + mid)
    if kind == KIND_AG:
        return tuple(mid + ag)
    return tuple(rs + mid + ag)


_PHASE_FNS = {
    ALGO_RING: _ring_phases,
    ALGO_TREE: _tree_phases,
    ALGO_HIER: _hier_phases,
}


def _p2p_phases(spec: ClusterSpec) -> tuple[CommPhase, ...]:
    """One point-to-point transfer (pipeline stage boundary): the full
    message crosses the bottleneck level once — ``c`` is that level's
    per-byte cost, ``d`` one hop latency.  Algorithm-independent."""
    if spec.n_devices <= 1:
        return ()
    b = spec.bottleneck_index()
    lvl = spec.levels[b]
    return (CommPhase(PHASE_P2P, b, lvl.beta, lvl.alpha),)


def _phases_uncached(spec: ClusterSpec, algo: str,
                     kind: str) -> tuple[CommPhase, ...]:
    if kind == KIND_RS_AG:
        return (_phases_uncached(spec, algo, KIND_RS)
                + _phases_uncached(spec, algo, KIND_AG))
    if kind == KIND_P2P:
        return _p2p_phases(spec)
    if spec.compat_hw is not None:
        # the legacy model is one opaque channel: a single phase carrying the
        # seed's exact (C, D); RS/AG are each half of it
        c, d = allreduce_coeffs(spec, algo)
        if kind == KIND_AR:
            return (CommPhase(PHASE_AR, 0, c, d),)
        pk = PHASE_RS if kind == KIND_RS else PHASE_AG
        return (CommPhase(pk, 0, 0.5 * c, 0.5 * d),)
    return _PHASE_FNS[algo](spec, kind)


@functools.lru_cache(maxsize=None)
def phases(spec: ClusterSpec, algo: str = DEFAULT_ALGO,
           kind: str = KIND_AR) -> tuple[CommPhase, ...]:
    """Phase decomposition of one collective of ``kind`` under ``algo`` —
    the schedule unit of the event engine (DESIGN.md Sec. 8)."""
    if kind not in (KIND_AR, KIND_RS, KIND_AG, KIND_RS_AG, KIND_P2P):
        raise ValueError(f"unknown comm kind {kind!r}")
    return _phases_uncached(spec, algo, kind)


@functools.lru_cache(maxsize=None)
def chunk_phases(spec: ClusterSpec, algo: str = DEFAULT_ALGO,
                 kind: str = KIND_AR, chunks: int = 1) -> tuple[CommPhase, ...]:
    """Phase decomposition of **one chunk** of a collective split ``chunks``
    ways (DESIGN.md Sec. 9).

    Each chunk moves ``nbytes / chunks`` of the payload through the same
    phase sequence; the per-phase latency is split evenly across chunks, so
    the per-chunk coefficients sum *exactly* to the unchunked ones —
    chunking conserves total channel work (no fictitious discount) and wins
    only by store-and-forward pipelining chunks through the link levels.
    ``chunks=1`` returns the :func:`phases` tuple unchanged (bit-identical
    schedules)."""
    if chunks <= 1:
        return phases(spec, algo, kind)
    return tuple(
        dataclasses.replace(p, d=p.d / chunks)
        for p in phases(spec, algo, kind)
    )


def _cohort_size(level_bw: float, bottleneck_bw: float, chunks: int) -> int:
    """Chunks coalesced into one transfer on a fat level: the largest power
    of two <= min(chunks, level_bw / bottleneck_bw) that divides
    ``chunks`` evenly (partial cohorts would break exact conservation).
    A level no faster than the bottleneck gets cohort 1 (no coalescing)."""
    if bottleneck_bw <= 0.0 or level_bw <= 0.0:
        return 1
    cap = min(float(chunks), level_bw / bottleneck_bw)
    m = 1
    while m * 2 <= cap:
        m *= 2
    while m > 1 and chunks % m:
        m //= 2
    return m


@functools.lru_cache(maxsize=None)
def level_chunk_phases(spec: ClusterSpec, algo: str = DEFAULT_ALGO,
                       kind: str = KIND_AR, chunks: int = 1,
                       chunk_index: int = 0) -> tuple[CommPhase, ...]:
    """Per-level chunk sizing (DESIGN.md Sec. 14): the phase decomposition
    of chunk ``chunk_index`` when fat link levels coalesce chunks into
    bigger transfers.

    Uniform chunking (:func:`chunk_phases`) sizes every phase's transfer
    for the bottleneck level, so a fat intra-host level pays its per-chunk
    latency ``chunks`` times for no pipelining benefit — real collectives
    (NCCL's proxy path) keep fine chunks only where the wire is slow.
    Here the **leading** phase coalesces each cohort of ``m`` consecutive
    chunks into the cohort's *first* chunk (every chunk's payload is
    resident at the source before the collective starts, so the carrier
    can ship the whole cohort causally-exactly) and the **trailing** phase
    coalesces into the cohort's *last* chunk (the delivery can only
    complete once the cohort's last chunk has arrived); ``m`` is
    :func:`_cohort_size` of that phase's level.  Non-carrier chunks get a
    zero-work phase — the event engine's positional after-gating and
    zero-phase skipping handle them untouched.

    Conservation is exact: per phase, ``chunks/m`` carriers each carry
    ``m x`` the per-chunk ``(c, d/chunks)``, summing to the unchunked
    ``(c, d)`` — coalescing is pure scheduling, never a cost discount.
    Interior phases, single-phase decompositions (nothing to pipeline
    through), flat compat specs and ``chunks <= 1`` are unchanged from
    :func:`chunk_phases`."""
    base = chunk_phases(spec, algo, kind, chunks)
    if chunks <= 1 or len(base) < 2 or spec.compat_hw is not None:
        return base
    bw_bottleneck = spec.bottleneck().bandwidth
    out = list(base)
    for pos, last in ((0, False), (len(base) - 1, True)):
        p = base[pos]
        m = _cohort_size(spec.levels[p.level].bandwidth, bw_bottleneck,
                         chunks)
        if m <= 1:
            continue
        carrier = (chunk_index % m) == (m - 1 if last else 0)
        out[pos] = (dataclasses.replace(p, c=p.c * m, d=p.d * m)
                    if carrier else dataclasses.replace(p, c=0.0, d=0.0))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def fused_phases(spec: ClusterSpec, algo: str = DEFAULT_ALGO,
                 kind: str = KIND_AR, chunks: int = 1,
                 discount: float = 0.0) -> tuple[CommPhase, ...]:
    """Phase decomposition of one chunk of an **in-kernel fused** collective
    (DESIGN.md Sec. 13).

    ``discount`` is the calibrated overlap factor delta in ``[0, 1)``: the
    fused kernel issues the collective from inside the producing compute
    job, so the transfer's ready time reaches ``delta x producer_duration``
    back into that job's tail.  The per-chunk ``(c, d)`` coefficients are
    the :func:`chunk_phases` ones **unchanged** — fusion conserves link work
    exactly (the bytes still cross the wire; they just start earlier), so
    the coefficient-conservation property and the engine's
    ``full_overlap_bound`` floor hold with no special cases.  Phase kinds
    are tagged ``fused_*`` so event-engine timelines can tell in-kernel
    overlap apart from scheduled overlap.

    ``discount <= 0`` returns the :func:`chunk_phases` tuple itself
    (bit-identical schedules: an undiscounted fused bucket prices exactly
    as its base kind)."""
    if discount <= 0.0:
        return chunk_phases(spec, algo, kind, chunks)
    if not discount < 1.0:
        raise ValueError(f"overlap discount must be in [0, 1), "
                         f"got {discount!r}")
    return tuple(
        dataclasses.replace(p, kind=f"{KIND_FUSED}_{p.kind}",
                            overlap=discount)
        for p in chunk_phases(spec, algo, kind, chunks)
    )


def _comm_coeffs_uncached(spec: ClusterSpec, algo: str,
                          kind: str) -> tuple[float, float]:
    if kind == KIND_AR:
        # delegate so the AllReduce path stays bit-identical to the
        # memoised legacy coefficients
        if spec.compat_hw is not None:
            return allreduce_coeffs(spec, algo)
        return _COEFF_FNS[algo](spec)
    c = 0.0
    d = 0.0
    for p in _phases_uncached(spec, algo, kind):
        c += p.c
        d += p.d
    return c, d


@functools.lru_cache(maxsize=None)
def comm_coeffs(spec: ClusterSpec, algo: str = DEFAULT_ALGO,
                kind: str = KIND_AR) -> tuple[float, float]:
    """``(C, D)`` of the opaque-interval cost of one collective of ``kind``
    (``ar`` / ``rs`` / ``ag`` / ``rs_ag``) — ``kind="ar"`` is exactly
    :func:`allreduce_coeffs`."""
    if kind == KIND_AR:
        return allreduce_coeffs(spec, algo)
    if kind not in (KIND_RS, KIND_AG, KIND_RS_AG, KIND_P2P):
        raise ValueError(f"unknown comm kind {kind!r}")
    return _comm_coeffs_uncached(spec, algo, kind)


def comm_time(nbytes: float, spec: ClusterSpec, algo: str = DEFAULT_ALGO,
              kind: str = KIND_AR) -> float:
    """Serialized (single-channel) cost of one collective of ``kind``;
    empty transfers are free."""
    if nbytes <= 0.0:
        return 0.0
    c, d = comm_coeffs(spec, algo, kind)
    return c * nbytes + d
