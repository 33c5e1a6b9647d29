"""Serving: the batched decode engine and seeded request traces (port of
``repro/serving``; the serving-plan search is not ported yet).

``repro_torch.serving.workload`` is import-light (no torch, no numpy at
load); the engine pulls in torch, so it is exposed lazily.
"""
from .workload import TraceRequest, VirtualClock, Workload, replay

__all__ = ["Request", "ServeEngine", "TraceRequest", "VirtualClock",
           "Workload", "replay"]

_ENGINE = {"Request", "ServeEngine"}


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
