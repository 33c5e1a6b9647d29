"""Serving: the batched decode engine, seeded request traces and searched
serving plans (port of ``repro/serving``).

``repro_torch.serving.plan`` and ``repro_torch.serving.workload`` are
import-light (no torch) so the plan cache and the search's worker pool can
load serving artifacts from bare interpreters; the engine pulls in torch,
so it and the plan are exposed lazily.
"""
from .workload import TraceRequest, VirtualClock, Workload, replay

__all__ = ["Request", "ServeEngine", "TraceRequest", "VirtualClock",
           "Workload", "replay", "ServingPlan", "compile_serving"]

_ENGINE = {"Request", "ServeEngine"}
_PLAN = {"ServingPlan", "compile_serving"}


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    if name in _PLAN:
        from . import plan
        return getattr(plan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
