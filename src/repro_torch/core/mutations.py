"""Declarative mutation registry for the backtracking search.

The paper's three optimisation methods and the three extension dimensions
used to live as scattered ``METHOD_*`` string constants in
:mod:`repro_torch.core.search` plus per-simulator drop rules hard-coded inside
``backtracking_search``.  This module makes each searched dimension a
first-class :class:`Mutation` — a name, a single random application, and an
``applicable(sim)`` predicate saying on which simulator configurations the
dimension can matter — registered in one place (``MUTATIONS``).  New
searched dimensions register here and the search, the Plan artifact and the
docs all pick them up (DESIGN.md Sec. 10).

Applicability encodes the pricing-model facts that used to be drop rules:

* ``algo`` — the flat back-compat spec is algorithm-blind (every collective
  model degenerates to the legacy formula), so algorithm flips can never
  improve on it; sims exposing no cluster at all are treated the same so
  their trajectories match the flat default.
* ``comm`` / ``chunk`` — on a serialized channel the ZeRO-3 RS+AG split
  prices identically to the fused AllReduce (RS + AG == AR term by term)
  and chunking conserves total channel work exactly, so both only matter
  once the event engine can pipeline phases (``streams > 1``).

The per-application bodies reproduce the seed ``random_apply`` draws
verbatim, so search trajectories (which are RNG-stream-identical by
construction) are unchanged by the refactor.

Import-light on purpose (no torch): the search worker pool and the Plan
artifact load this from bare interpreters.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

from ..cluster import BUCKET_COMM_KINDS, COLLECTIVE_ALGOS
from .graph import FusionGraph

METHOD_NONDUP = "nondup"
METHOD_DUP = "dup"
METHOD_TENSOR = "tensor"
METHOD_ALGO = "algo"
METHOD_COMM = "comm"
METHOD_CHUNK = "chunk"
METHOD_FUSED = "fused"
METHOD_PP_SPLIT = "pp_split"
METHOD_PP_MICROBATCH = "pp_microbatch"
METHOD_PP_INTERLEAVE = "pp_interleave"

# store-and-forward chunk counts METHOD_CHUNK draws from (1 restores the
# whole-bucket collective; powers of two mirror NCCL's chunk granularity)
CHUNK_CHOICES = (1, 2, 4, 8)

# pipeline-knob draws (DESIGN.md Sec. 14).  Overrides are resolved against
# the simulator's base PipelineSchedule at pricing time
# (repro_torch.core.pipeline.resolve_schedule), which clamps n_stages to the
# graph's group count and collapses interleave where the Megatron
# divisibility constraint fails — so every draw is a valid candidate.
PP_SPLIT_CHOICES = (1, 2, 4, 8)
PP_MICROBATCH_CHOICES = (4, 8, 16, 32)
PP_INTERLEAVE_CHOICES = (1, 2)

# serving-plan knob draws (DESIGN.md Sec. 15).  These mutate a
# ``repro.serving.plan.ServingState`` (duck-typed through the same
# clone()/fast_signature() protocol as FusionGraph) and are applicable
# only on ``is_serving`` simulators — training sims never see them, so
# every training trajectory and cache key stays bit-identical.
METHOD_SERVE_SLOTS = "serve_slots"
METHOD_SERVE_BATCH = "serve_batch"
METHOD_SERVE_KV = "serve_kv"
METHOD_SERVE_ALGO = "serve_algo"
METHOD_SERVE_STREAMS = "serve_streams"

SERVE_SLOT_CHOICES = (4, 8, 16, 32, 64)
SERVE_BATCH_CHOICES = (1, 2, 4, 8, 16, 32, 64)
SERVE_KV_LAYOUTS = ("replicated", "head", "sequence")
SERVE_STREAM_CHOICES = (1, 2)

# the explicit method tuple compile_serving() passes: the training
# mutations' applies would crash on a ServingState (their applicability
# defaults to True), so serving searches never use methods=None
SERVING_METHODS = (METHOD_SERVE_SLOTS, METHOD_SERVE_BATCH, METHOD_SERVE_KV,
                   METHOD_SERVE_ALGO, METHOD_SERVE_STREAMS)


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One searched dimension: ``apply(g, rng)`` performs a single random
    application (mutating ``g``, returning True iff the graph changed);
    ``applicable(sim)`` says whether the dimension can improve candidates
    priced by ``sim`` (inapplicable mutations are dropped by the search
    instead of burning candidate evaluations)."""
    name: str
    apply: Callable[[FusionGraph, random.Random], bool]
    applicable: Callable[[object], bool] = lambda sim: True
    doc: str = ""


# ------------------------------------------------------------ applicability
def _cluster_of(sim) -> object | None:
    return getattr(sim, "cluster", None)


def _algo_applicable(sim) -> bool:
    cluster = _cluster_of(sim)
    return cluster is not None and not cluster.is_flat_compat


def _engine_applicable(sim) -> bool:
    return _algo_applicable(sim) and getattr(sim, "streams", 1) > 1


def _fused_applicable(sim) -> bool:
    # in-kernel fusion only matters where the engine can price the early
    # comm start (multi-stream) AND the cluster has a calibrated overlap
    # discount — an undiscounted fused bucket prices exactly as its base
    # kind, so searching the flag would burn candidate evaluations
    return (_engine_applicable(sim)
            and getattr(sim, "overlap_discount", 0.0) > 0.0)


def _pp_applicable(sim) -> bool:
    # pipeline knobs only price on a pipeline-enabled sim: everywhere else
    # pp_knobs is inert graph state, so offering the mutations would burn
    # candidate evaluations — and, worse, change legacy RNG streams.  The
    # registry gate is what keeps earlier trajectories bit-identical.
    return getattr(sim, "pipeline", None) is not None


# ------------------------------------------------------------- applications
def _apply_fuse(method: str):
    def apply(g: FusionGraph, rng: random.Random) -> bool:
        gids = list(g.groups)
        # a handful of attempts to find a valid (consumer, producer) pair
        for _attempt in range(4):
            c = rng.choice(gids)
            preds = list(g.group_preds(c))
            if not preds:
                continue
            p = rng.choice(preds)
            ok = g.fuse_nondup(c, p) if method == METHOD_NONDUP \
                else g.fuse_dup(c, p)
            if ok:
                return True
        return False

    return apply


def _apply_tensor(g: FusionGraph, rng: random.Random) -> bool:
    if len(g.buckets) < 2:
        return False
    i = rng.randrange(len(g.buckets) - 1)
    return g.merge_buckets(i, i + 1)


def _apply_algo(g: FusionGraph, rng: random.Random) -> bool:
    if not g.buckets:
        return False
    i = rng.randrange(len(g.buckets))
    return g.set_bucket_algo(i, rng.choice(COLLECTIVE_ALGOS))


def _apply_comm(g: FusionGraph, rng: random.Random) -> bool:
    if not g.buckets:
        return False
    i = rng.randrange(len(g.buckets))
    return g.set_bucket_comm(i, rng.choice(BUCKET_COMM_KINDS))


def _apply_chunk(g: FusionGraph, rng: random.Random) -> bool:
    if not g.buckets:
        return False
    i = rng.randrange(len(g.buckets))
    return g.set_bucket_chunks(i, rng.choice(CHUNK_CHOICES))


def _apply_fused(g: FusionGraph, rng: random.Random) -> bool:
    if not g.buckets:
        return False
    i = rng.randrange(len(g.buckets))
    return g.set_bucket_fused(i, rng.choice((False, True)))


def _apply_pp_split(g: FusionGraph, rng: random.Random) -> bool:
    return g.set_pp_knobs(n_stages=rng.choice(PP_SPLIT_CHOICES))


def _apply_pp_microbatch(g: FusionGraph, rng: random.Random) -> bool:
    return g.set_pp_knobs(n_microbatches=rng.choice(PP_MICROBATCH_CHOICES))


def _apply_pp_interleave(g: FusionGraph, rng: random.Random) -> bool:
    return g.set_pp_knobs(interleave=rng.choice(PP_INTERLEAVE_CHOICES))


def _serving_applicable(sim) -> bool:
    # serving knobs only exist on a ServingState priced by a
    # ServingSimulator; everywhere else offering them would crash the
    # apply (FusionGraph has no set_slots) and change legacy RNG streams
    return bool(getattr(sim, "is_serving", False))


def _apply_serve_slots(g, rng: random.Random) -> bool:
    return g.set_slots(rng.choice(SERVE_SLOT_CHOICES))


def _apply_serve_batch(g, rng: random.Random) -> bool:
    return g.set_decode_batch(rng.choice(SERVE_BATCH_CHOICES))


def _apply_serve_kv(g, rng: random.Random) -> bool:
    return g.set_kv_layout(rng.choice(SERVE_KV_LAYOUTS))


def _apply_serve_algo(g, rng: random.Random) -> bool:
    return g.set_algo(rng.choice(COLLECTIVE_ALGOS))


def _apply_serve_streams(g, rng: random.Random) -> bool:
    return g.set_streams(rng.choice(SERVE_STREAM_CHOICES))


# ------------------------------------------------------------------ registry
MUTATIONS: dict[str, Mutation] = {}


def register_mutation(m: Mutation, *, replace: bool = False) -> Mutation:
    """Register a searched dimension.  ``replace=True`` overrides an
    existing registration (tests / experimental estimator-specific drop
    rules); otherwise duplicate names are an error."""
    if not replace and m.name in MUTATIONS:
        raise ValueError(f"mutation {m.name!r} is already registered")
    MUTATIONS[m.name] = m
    return m


register_mutation(Mutation(
    METHOD_NONDUP, _apply_fuse(METHOD_NONDUP),
    doc="paper method (i): merge a producer group into a consumer group"))
register_mutation(Mutation(
    METHOD_DUP, _apply_fuse(METHOD_DUP),
    doc="paper method (ii): duplicate a producer group into a consumer"))
register_mutation(Mutation(
    METHOD_TENSOR, _apply_tensor,
    doc="paper method (iii): merge two neighbouring AllReduce buckets"))
register_mutation(Mutation(
    METHOD_ALGO, _apply_algo, _algo_applicable,
    doc="cluster method (iv): per-bucket collective algorithm "
        "(ring/tree/hier; flat specs are algorithm-blind)"))
register_mutation(Mutation(
    METHOD_COMM, _apply_comm, _engine_applicable,
    doc="event-engine method (v): fused AllReduce vs ZeRO-3 RS+AG "
        "(identical pricing on a serialized channel)"))
register_mutation(Mutation(
    METHOD_CHUNK, _apply_chunk, _engine_applicable,
    doc="event-engine method (vi): store-and-forward chunk count "
        "(pure scheduling; needs a multi-stream engine to matter)"))
register_mutation(Mutation(
    METHOD_FUSED, _apply_fused, _fused_applicable,
    doc="kernel method (vii): in-kernel fused compute+comm per bucket "
        "(CoCoNet-style; needs a multi-stream engine and a calibrated "
        "overlap discount)"))
register_mutation(Mutation(
    METHOD_PP_SPLIT, _apply_pp_split, _pp_applicable,
    doc="pipeline method (viii): searched stage count override "
        "(needs a pipeline-enabled sim; clamped to the group count)"))
register_mutation(Mutation(
    METHOD_PP_MICROBATCH, _apply_pp_microbatch, _pp_applicable,
    doc="pipeline method (ix): searched microbatch count override "
        "(needs a pipeline-enabled sim)"))
register_mutation(Mutation(
    METHOD_PP_INTERLEAVE, _apply_pp_interleave, _pp_applicable,
    doc="pipeline method (x): searched interleaved-1F1B chunk depth "
        "(needs a pipeline-enabled sim; collapses to 1 where Megatron's "
        "divisibility constraint fails)"))
register_mutation(Mutation(
    METHOD_SERVE_SLOTS, _apply_serve_slots, _serving_applicable,
    doc="serving method (xi): decode slot count (KV memory vs occupancy)"))
register_mutation(Mutation(
    METHOD_SERVE_BATCH, _apply_serve_batch, _serving_applicable,
    doc="serving method (xii): decode dispatch batch (weight-stream "
        "amortization vs padding waste and per-token TP payload)"))
register_mutation(Mutation(
    METHOD_SERVE_KV, _apply_serve_kv, _serving_applicable,
    doc="serving method (xiii): KV-shard layout "
        "(replicated / head / sequence)"))
register_mutation(Mutation(
    METHOD_SERVE_ALGO, _apply_serve_algo, _serving_applicable,
    doc="serving method (xiv): decode-collective algorithm "
        "(ring/tree/hier)"))
register_mutation(Mutation(
    METHOD_SERVE_STREAMS, _apply_serve_streams, _serving_applicable,
    doc="serving method (xv): prefill lane allocation (threaded into the "
        "decode chain vs a dedicated stream bought with HBM)"))

# METHOD_FUSED (and the pp_* methods after it) are deliberately NOT in
# ALL_METHODS: this tuple keys the
# RNG streams of seed-era benchmarks/tests (perf_search.py throughput,
# trajectory-identity assertions), so it is frozen — ``active_methods``
# appends registered extras after it, which is how default searches pick
# the fused dimension up.
ALL_METHODS = (METHOD_NONDUP, METHOD_DUP, METHOD_TENSOR, METHOD_ALGO,
               METHOD_COMM, METHOD_CHUNK)


def get_mutation(name: str) -> Mutation:
    try:
        return MUTATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown search method {name!r}; registered: "
            f"{', '.join(sorted(MUTATIONS))}") from None


def active_methods(sim, methods: Sequence[str] | None = None) -> tuple[str, ...]:
    """The subset of ``methods`` (default: every registered mutation, in
    ``ALL_METHODS``-first order) whose ``applicable(sim)`` holds — the
    single source of the search's per-simulator drop rules."""
    if methods is None:
        extra = tuple(n for n in MUTATIONS if n not in ALL_METHODS)
        methods = ALL_METHODS + extra
    return tuple(m for m in methods if get_mutation(m).applicable(sim))


def random_apply(g: FusionGraph, method: str, n: int,
                 rng: random.Random) -> bool:
    """Apply ``method`` up to n times with random operands (the paper's
    ``RandomApply``).  Mutates ``g``; returns True if at least one
    application changed the graph.  Draw-for-draw identical to the seed's
    inline dispatch."""
    apply = get_mutation(method).apply
    changed = False
    for _ in range(n):
        changed |= apply(g, rng)
    return changed
