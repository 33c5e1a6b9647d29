"""Backtracking search over the joint op/tensor-fusion space (paper Alg. 1).

Faithful reproduction: a priority queue of candidate HLO modules ordered by
Cost(.); each step dequeues the cheapest candidate and applies each of the
optimisation methods ``RandomApply``-style n ~ U[0, beta] times — the
paper's three (non-duplicate fusion, duplicate fusion, tensor fusion) plus
the cluster extension's per-bucket collective-algorithm choice
(``METHOD_ALGO``, DESIGN.md Sec. 7) and the event-engine extension's
per-bucket comm-kind choice (``METHOD_COMM``: fused AllReduce vs ZeRO-3
reduce-scatter + all-gather) and per-bucket chunk-count choice
(``METHOD_CHUNK``: store-and-forward chunks pipelined through the link
levels; both active on multi-stream sims — DESIGN.md Sec. 8-9), making
the search joint over op fusion x tensor fusion x algorithm x comm kind
x chunking;
candidates within ``alpha x Cost(H_opt)`` are re-enqueued for backtracking;
the search stops when the queue empties or H_opt is unchanged for
``unchanged_limit`` steps (paper: 1000; default reduced for CPU budget —
see DESIGN.md Sec. 6).

Per Alg. 1, "unchanged" is counted **once per dequeued step** that fails to
improve H_opt — not once per method draw, which would make the effective
patience depend on ``len(methods)``.

The methods themselves live in the declarative registry
:mod:`repro_torch.core.mutations`: each searched dimension is a
``Mutation(name, apply, applicable)`` and the per-simulator drop rules
(flat specs are algorithm-blind; comm-kind and chunk flips only matter on a
multi-stream engine) are its ``applicable(sim)`` predicate —
``active_methods(sim, methods)`` below replaces the hard-coded filters.
New dimensions register there once and the search picks them up.

Candidate evaluation can optionally be spread over a process pool
(``workers=N``): candidates are still *generated* sequentially (the RNG
stream, and therefore the search trajectory, is identical to the serial
path), but their simulations run concurrently, each worker holding its own
estimator cache.  Cost memoisation uses the graph's O(1) rolling
``fast_signature`` instead of the full O(V log V) sorted fingerprint.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import pickle
import random
import time as _time
from typing import Callable, Sequence

from .costs import OracleEstimator
from .graph import FusionGraph
from .mutations import (ALL_METHODS, CHUNK_CHOICES, METHOD_ALGO,
                        METHOD_CHUNK, METHOD_COMM, METHOD_DUP,
                        METHOD_FUSED, METHOD_NONDUP, METHOD_TENSOR,
                        MUTATIONS, Mutation, active_methods, random_apply)
from .simulator import Simulator

__all__ = [
    "ALL_METHODS", "CHUNK_CHOICES", "METHOD_ALGO", "METHOD_CHUNK",
    "METHOD_COMM", "METHOD_DUP", "METHOD_FUSED", "METHOD_NONDUP",
    "METHOD_TENSOR", "MUTATIONS", "Mutation", "SearchResult",
    "active_methods", "backtracking_search", "random_apply",
]


@dataclasses.dataclass
class SearchResult:
    best: FusionGraph
    best_cost: float
    initial_cost: float
    steps: int
    simulations: int
    wall_time: float
    history: list  # (step, best_cost)
    # (simulations-so-far, best_cost) at every improvement — the
    # simulations-to-quality curve the plan-cache warm-start benchmark
    # gates on (DESIGN.md Sec. 12)
    quality_history: list = dataclasses.field(default_factory=list)


# --------------------------------------------------------- worker-pool eval
_WORKER_CTX = None


def _pool_init(payload: bytes) -> None:
    global _WORKER_CTX
    (prims, psuccs, ppreds, grad_prim, family, hw, n_devices,
     cluster, streams, background, overlap_discount,
     pipeline, tp) = pickle.loads(payload)
    sim = Simulator(hw=hw, n_devices=n_devices, incremental=False,
                    cluster=cluster, streams=streams, background=background,
                    overlap_discount=overlap_discount,
                    pipeline=pipeline, tp=tp)
    _WORKER_CTX = (prims, psuccs, ppreds, grad_prim, family, sim)


def _pool_cost(state: tuple) -> float:
    (groups, provider, next_gid, buckets, bucket_algos, bucket_comm,
     bucket_chunks, bucket_fused, pp_knobs) = state
    prims, psuccs, ppreds, grad_prim, family, sim = _WORKER_CTX
    g = FusionGraph._from_parts(prims, psuccs, ppreds, groups, provider,
                                next_gid, grad_prim, buckets, family=family,
                                bucket_algos=bucket_algos,
                                bucket_comm=bucket_comm,
                                bucket_chunks=bucket_chunks,
                                bucket_fused=bucket_fused,
                                pp_knobs=pp_knobs)
    return sim.cost(g)


class _CandidatePool:
    """Process pool evaluating candidate costs; each worker keeps its own
    estimator cache keyed to the shared prim family."""

    def __init__(self, sim: Simulator, base: FusionGraph, workers: int):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        payload = pickle.dumps(
            (base.prims, base.psuccs, base.ppreds, base.grad_prim,
             base.family_token(), sim.hw, sim.n_devices,
             getattr(sim, "cluster", None), getattr(sim, "streams", 1),
             getattr(sim, "background", ()),
             getattr(sim, "overlap_discount", 0.0),
             getattr(sim, "pipeline", None), getattr(sim, "tp", None))
        )
        # spawn: workers only import repro_torch.core (pure python, no
        # torch), and forking a process that already holds torch's thread
        # pools can hang
        self._ex = ProcessPoolExecutor(
            max_workers=workers, initializer=_pool_init, initargs=(payload,),
            mp_context=multiprocessing.get_context("spawn"),
        )

    def evaluate(self, graphs: Sequence[FusionGraph]) -> list[float]:
        futs = [
            self._ex.submit(
                _pool_cost, (g.groups, g.provider, g._next_gid, g.buckets,
                             g.bucket_algos, g.bucket_comm, g.bucket_chunks,
                             g.bucket_fused, g.pp_knobs)
            )
            for g in graphs
        ]
        return [f.result() for f in futs]

    def close(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)


def _make_pool(sim, g0, workers) -> _CandidatePool | None:
    if not workers or workers < 2:
        return None
    if not isinstance(getattr(sim, "estimator", None), OracleEstimator):
        return None  # GNN/custom estimators are not shippable to workers
    try:
        return _CandidatePool(sim, g0, workers)
    except Exception:
        return None


def backtracking_search(
    g0: FusionGraph,
    sim: Simulator,
    *,
    alpha: float = 1.05,
    beta: int = 10,
    unchanged_limit: int = 200,
    methods: Sequence[str] | None = None,
    seed: int = 0,
    max_queue: int = 512,
    max_steps: int | None = None,
    on_step: Callable | None = None,
    workers: int | None = None,
    initial: FusionGraph | None = None,
) -> SearchResult:
    """``initial`` injects a warm start state (e.g. a cached plan's
    strategy re-applied onto ``g0`` — see :mod:`repro_torch.plan.cache`): it is
    costed and enqueued alongside ``g0``, and since the incumbent starts
    at the cheaper of the two, the search can never return a plan worse
    than its own start state.  ``initial_cost`` still reports ``g0``'s
    cost (the trivial baseline), so speedup-vs-initial stays comparable
    between warm and cold runs.  ``initial=None`` draws the identical RNG
    stream as before — cold trajectories are unchanged."""
    rng = random.Random(seed)
    tick = itertools.count()
    cost_cache: dict = {}
    sims = 0
    # methods=None searches every *registered* mutation (new dimensions
    # register once in repro_torch.core.mutations and are picked up here); either
    # way, dimensions that cannot improve candidates priced by this sim
    # (flat specs are algorithm-blind, comm/chunk flips need a multi-stream
    # engine) are dropped instead of burning candidate evaluations — the
    # rules are the mutations' applicable(sim) predicates.
    methods = active_methods(sim, methods)
    pool = _make_pool(sim, g0, workers)

    def cost(g: FusionGraph) -> float:
        nonlocal sims
        key = g.fast_signature()
        c = cost_cache.get(key)
        if c is None:
            c = sim.cost(g)
            cost_cache[key] = c
            sims += 1
        return c

    t0 = _time.perf_counter()
    c0 = cost(g0)
    best, best_cost = g0, c0
    q: list = [(c0, next(tick), g0)]
    unchanged = 0
    steps = 0
    history = [(0, c0)]
    quality_history = [(sims, c0)]
    if initial is not None and initial.fast_signature() != g0.fast_signature():
        ci = cost(initial)
        if ci < best_cost:
            best, best_cost = initial, ci
            history.append((0, ci))
        quality_history.append((sims, best_cost))
        heapq.heappush(q, (ci, next(tick), initial))

    try:
        while q and unchanged < unchanged_limit:
            if max_steps is not None and steps >= max_steps:
                break
            c_h, _, h = heapq.heappop(q)
            steps += 1
            # generate all of this step's candidates first — the RNG stream
            # (and thus the trajectory) is independent of how they are costed
            cands: list[FusionGraph] = []
            for s in methods:
                n = rng.randint(0, beta)
                if n == 0:
                    continue
                h2 = h.clone()
                if random_apply(h2, s, n, rng):
                    cands.append(h2)
            if pool is not None and len(cands) > 1:
                fresh = {}
                for h2 in cands:
                    kk = h2.fast_signature()
                    if kk not in cost_cache and kk not in fresh:
                        fresh[kk] = h2
                if fresh:
                    try:
                        costs = pool.evaluate(list(fresh.values()))
                    except Exception:
                        pool.close()
                        pool = None
                    else:
                        for kk, c2 in zip(fresh, costs):
                            cost_cache[kk] = c2
                            sims += 1
            improved = False
            for h2 in cands:
                c2 = cost(h2)  # validity is enforced inside the mutations
                if c2 < best_cost:
                    best, best_cost = h2, c2
                    improved = True
                    history.append((steps, best_cost))
                    quality_history.append((sims, best_cost))
                if c2 <= alpha * best_cost and len(q) < max_queue:
                    heapq.heappush(q, (c2, next(tick), h2))
            # Alg. 1: H_opt "unchanged" is per dequeued step, not per method
            if not improved:
                unchanged += 1
            else:
                unchanged = 0
            if on_step is not None:
                on_step(steps, best_cost)
    finally:
        if pool is not None:
            pool.close()
    return SearchResult(
        best=best,
        best_cost=best_cost,
        initial_cost=c0,
        steps=steps,
        simulations=sims,
        wall_time=_time.perf_counter() - t0,
        history=history,
        quality_history=quality_history,
    )
