"""``repro_torch.plan.compile`` — the one entry point for search -> Plan
(port of ``repro/plan/facade.py``).

Owns the trace -> profile -> search pipeline: build (or accept) a profiled
:class:`FusionGraph`, construct the pricing
:class:`~repro_torch.core.simulator.Simulator` from ``(cluster, streams,
background, workers)``, run the backtracking search, and freeze the winner
into a :class:`~repro_torch.plan.artifact.Plan`.

Two modes:

* ``compile("tinyllama-1.1b", cluster="h100_superpod")`` — trace a
  config's training step (on meta tensors, see :func:`trace_model_graph`;
  ``model="layers"`` the per-layer model) and search it.
* ``compile(graph=g0, cluster=spec, ...)`` — search a pre-traced graph.

Every default ``hw=`` is the H100 (``H100_SXM``).  ``cache=`` replays or
warm-starts from a :class:`~repro_torch.plan.cache.PlanCache`.  The search
provenance (steps, simulations, wall times, initial cost) rides along in
``plan.provenance``.
"""
from __future__ import annotations

import time as _time

from ..cluster import ClusterSpec, get_preset
from ..core.hw import H100_SXM, Hardware
from ..core.search import backtracking_search
from ..core.simulator import Simulator
from .artifact import Plan


def trace_model_graph(cfg, *, batch: int = 8, seq: int = 64,
                      model: str = "stacked", reduced: bool = True,
                      n_layers: int | None = None, hw: Hardware = H100_SXM):
    """Trace + profile one training step of a model config (the Search
    Phase's input): the model's loss and gradients, without remat, on meta
    parameters and ``materialize_batch``'s batch as meta tensors (the
    ``(batch, seq)`` int64 tokens and the stub frontends' f32 embeddings
    where the arch has them), so it spends no memory and no device time at
    any width.  ``model="stacked"`` is the
    stacked-layer model, whose layer loops and chunked cross-entropy the
    tracer collapses into one prim each; ``model="layers"`` the per-layer
    model, whose trace shows every layer's forward and backward.
    ``n_layers`` sets the per-layer model's depth (a config without
    ``recurrent`` only), as in the reference.  Imports torch lazily:
    plan/artifact consumers stay light."""
    import dataclasses as _dc

    import torch

    from ..configs import get_config
    from ..core.costs import profile_graph
    from ..core.trace import trace_grad_graph
    from ..data.pipeline import materialize_batch

    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if reduced:
        cfg = cfg.reduced()
    if model == "stacked":
        from ..models import stacked as MM
    elif model == "layers":
        from ..models import model as MM

        if n_layers is not None and cfg.recurrent is None:
            cfg = _dc.replace(cfg, n_layers=n_layers)
    else:
        raise ValueError(f"unknown model variant {model!r} "
                         f"(expected 'stacked' or 'layers')")
    with torch.device("meta"):
        params = MM.init_params(cfg, device="meta")
    data = materialize_batch(cfg, batch, seq, device="meta")
    g = trace_grad_graph(lambda p, bt: MM.loss_fn(p, cfg, bt), params, data)
    return profile_graph(g, hw)


def compile_plan(cfg=None, *, cluster=None, streams: int = 1,
                 background=(), pipeline=None, tp=None,
                 level_chunks: bool = False, workers: int | None = None,
                 overlap_discount: float | None = None,
                 graph=None, estimator=None, hw: Hardware = H100_SXM,
                 n_devices: int = 256,
                 batch: int = 8, seq: int = 64, model: str = "stacked",
                 reduced: bool = True, n_layers: int | None = None,
                 alpha: float = 1.05, beta: int = 10,
                 unchanged_limit: int = 200, max_steps: int | None = None,
                 methods=None, seed: int = 0,
                 cache=None, warm_start: bool = True) -> Plan:
    """Search once, return the strategy as a first-class artifact.

    ``cfg`` is a config name / ModelConfig (traced via
    :func:`trace_model_graph`) — or pass ``graph=`` to search a pre-traced
    profiled FusionGraph directly.  ``cluster`` is a preset name or
    :class:`ClusterSpec` (default: the legacy flat ``(hw, n_devices)``
    model).  ``streams`` / ``background`` / ``pipeline`` pick the
    event-engine pricing (``pipeline`` is a
    :class:`~repro_torch.core.pipeline.PipelineSchedule` that prices the run
    under a 1F1B stage schedule instead of pure data parallelism; ``tp``
    a :class:`~repro_torch.core.tp_traffic.TPTraffic` that dep-couples
    per-layer tensor-parallel activation collectives into the schedule;
    ``level_chunks`` coalesces store-and-forward chunks on the fat link
    levels — DESIGN.md Sec. 14), ``workers`` the candidate-evaluation
    pool; ``overlap_discount``
    overrides the preset's calibrated in-kernel fusion discount (pass
    ``0.0`` to exclude the fused dimension from the search); the
    remaining knobs are the search hyper-parameters of
    ``backtracking_search``.

    ``cache`` (a :class:`repro_torch.plan.cache.PlanCache` or a directory
    path) short-circuits the search (DESIGN.md Sec. 12): an exact key hit —
    same graph content-signature, cluster/pricing fingerprint and search
    knobs — *replays* the stored Plan bit-identically (no simulator
    evaluations); a near miss re-applies the most similar cached plan's
    strategy onto this graph as the backtracking search's warm start
    state (``warm_start=False`` disables that half), and the result is
    stored back.  ``plan.provenance['cache']`` records the outcome
    (``hit`` / ``warm`` / ``cold``) and the warm-start lineage.
    """
    t_start = _time.perf_counter()
    if isinstance(cluster, str):
        cluster = get_preset(cluster)
    if cluster is not None and not isinstance(cluster, ClusterSpec):
        raise TypeError(f"cluster must be a preset name or ClusterSpec, "
                        f"got {type(cluster).__name__}")
    arch = cfg if isinstance(cfg, str) else getattr(cfg, "name", None)
    if graph is None:
        if cfg is None:
            raise ValueError("compile() needs a config (cfg=) or a "
                             "pre-traced graph (graph=)")
        graph = trace_model_graph(cfg, batch=batch, seq=seq, model=model,
                                  reduced=reduced, n_layers=n_layers, hw=hw)
    sim = Simulator(estimator=estimator, hw=hw, n_devices=n_devices,
                    cluster=cluster, streams=streams,
                    background=tuple(background), pipeline=pipeline,
                    tp=tp, level_chunks=level_chunks,
                    overlap_discount=overlap_discount)

    # ---------------------------------------------------------- plan cache
    store = key = features = None
    initial = None
    cache_prov: dict = {}
    if cache is not None:
        from .cache import (cache_features, compile_key, graph_digest,
                            knob_digest, open_cache, warm_start_state)

        store = open_cache(cache)
        knobs = knob_digest(alpha=alpha, beta=beta,
                            unchanged_limit=unchanged_limit,
                            max_steps=max_steps, methods=methods, seed=seed)
        gd = graph_digest(graph)
        key = compile_key(graph, sim, knobs, digest=gd)
        features = cache_features(graph, sim, arch=arch, knobs=knobs,
                                  digest=gd)
        hit = store.get(key)
        if hit is not None:
            # exact-key replay: the stored artifact IS the answer — same
            # strategy, same fingerprints, same predicted price, zero
            # simulator evaluations
            hit.provenance["cache"] = {"outcome": "hit", "key": key}
            hit.provenance["facade_wall_time"] = \
                _time.perf_counter() - t_start
            return hit
        cache_prov = {"outcome": "cold", "key": key}
        if warm_start:
            for score, ent, near in store.nearest(features, exclude=key):
                g_warm = warm_start_state(near, graph, sim)
                if g_warm is None:
                    continue  # wrong trace family — next candidate
                warm_cost = sim.cost(g_warm)
                if warm_cost >= sim.cost(graph):
                    # prices worse than the trivial start: a misleading
                    # seed state buys nothing — fall through to cold
                    continue
                initial = g_warm
                store.stats["warm_starts"] += 1
                cache_prov = {
                    "outcome": "warm", "key": key,
                    "warm_from": ent.get("key"),
                    "warm_similarity": score,
                    "warm_from_cluster": ent.get("cluster_name"),
                    "warm_start_cost": warm_cost,
                }
                break

    kw = {} if methods is None else {"methods": tuple(methods)}
    res = backtracking_search(
        graph, sim, alpha=alpha, beta=beta,
        unchanged_limit=unchanged_limit, max_steps=max_steps, seed=seed,
        workers=workers, initial=initial, **kw)
    plan = Plan.from_graph(
        res.best, sim=sim, predicted=res.best_cost,
        provenance={
            "arch": arch,
            "grad_tensors": len(graph.grad_prim),
            "initial_cost": res.initial_cost,
            "best_cost": res.best_cost,
            "steps": res.steps,
            "simulations": res.simulations,
            "search_wall_time": res.wall_time,
            "quality_history": [list(t) for t in res.quality_history],
            "seed": seed,
        })
    if store is not None:
        plan.provenance["cache"] = cache_prov
        store.put(key, plan, features)
    plan.provenance["facade_wall_time"] = _time.perf_counter() - t_start
    return plan


# ``repro_torch.plan.compile(...)`` is the public spelling; the module-level
# name only shadows the builtin at the attribute level, never in this file.
compile = compile_plan
