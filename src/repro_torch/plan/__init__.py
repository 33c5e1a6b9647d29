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
* ``plan.save(path)`` / ``Plan.load(path)`` round-trip JSON.

Not ported yet: the plan cache (``repro/plan/cache.py``), so
:func:`compile` takes no ``cache=``.
"""
from .artifact import (ClusterMismatchError, PLAN_VERSION, Plan, PlanError,
                       PlanVersionError, SCHEMA, cluster_fingerprint,
                       cluster_fingerprint_diff, estimator_name)
from .facade import compile, compile_plan, trace_model_graph

__all__ = [
    "ClusterMismatchError", "PLAN_VERSION", "Plan", "PlanError",
    "PlanVersionError", "SCHEMA", "cluster_fingerprint",
    "cluster_fingerprint_diff", "compile", "compile_plan", "estimator_name",
    "trace_model_graph",
]
