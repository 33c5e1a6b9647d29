"""``repro_torch.plan`` — search once, carry the result (port of
``repro/plan``).

:class:`Plan` is the frozen, versioned, serializable record of one searched
strategy; its JSON schema and version are the reference's, so a Plan
written by either package loads in the other.  :func:`compile` is the
facade that produces one (trace -> profile -> search).  From a plan:

* ``plan.grad_sync(params)`` lowers to the port's enactable
  ``GradSyncStrategy`` (buckets, comm kinds, chunk counts, fused flags);
* ``plan.simulator()`` reconstructs the exact pricing configuration;
* ``plan.to_graph(base)`` re-applies the strategy onto a traced graph;
* ``plan.save(path)`` / ``Plan.load(path)`` round-trip JSON;
* :class:`PlanCache` (:mod:`.cache`) stores compiled plans
  content-addressed on disk — ``compile(cache=...)`` replays exact-key
  hits bit-identically and warm-starts the search from the nearest cached
  strategy on a near miss (``python -m repro_torch.plan.cache
  ls|stats|prune|verify`` to inspect a cache directory).
"""
from .artifact import (ClusterMismatchError, PLAN_VERSION, Plan, PlanError,
                       PlanVersionError, SCHEMA, cluster_fingerprint,
                       cluster_fingerprint_diff, estimator_name)
from .cache import (PlanCache, ServingPlanNotPorted, cache_features,
                    compile_key, graph_digest, knob_digest, open_cache,
                    similarity, warm_start_state)
from .facade import compile, compile_plan, trace_model_graph

__all__ = [
    "ClusterMismatchError", "PLAN_VERSION", "Plan", "PlanCache",
    "PlanError", "PlanVersionError", "SCHEMA", "ServingPlanNotPorted",
    "cache_features", "cluster_fingerprint", "cluster_fingerprint_diff",
    "compile", "compile_key", "compile_plan", "estimator_name",
    "graph_digest", "knob_digest", "open_cache", "similarity",
    "trace_model_graph", "warm_start_state",
]
