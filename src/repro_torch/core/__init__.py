"""``repro_torch.core`` — the fusion IR, its cost substrate, the event
simulator, the search, the paper's baselines, the tracer, the profiler
(:mod:`.profile`, which times fused ops on the card), the GNN estimator
(:mod:`.gnn`) and the analytic FLOP and byte model (:mod:`.analytic`)
(port of ``repro/core``).  Importing this package loads no torch:
:mod:`.trace` is loaded on first use and :mod:`.gnn`, :mod:`.profile` and
:mod:`.analytic` are imported by name, so the search's worker processes
stay light."""
from .graph import DOT, EW, FusionGraph, LAYOUT, OPAQUE, PrimOp, REDUCE
from .hw import (H100_SXM, Hardware, TPU_V5E, allreduce_time,
                 ring_allreduce_coeffs)
from .costs import (OracleEstimator, group_time_oracle, prim_time,
                    profile_graph, total_comm_time, total_compute_time)
from .simulator import SimResult, Simulator
from .events import (BackgroundTraffic, CommEngine, CommJob, ComputeJob,
                     DISC_FAIR, DISC_FIFO, EventEngine, TC_COMPUTE, TC_DP,
                     TC_PP, TC_TP, TRAFFIC_CLASSES, UnifiedResult)
from .pipeline import (PipelineSchedule, SCHED_1F1B, SCHED_INTERLEAVED,
                       SCHEDULES, resolve_schedule)
from .tp_traffic import (TPTraffic, balanced_spans, couple_tp,
                         couple_tp_pipeline)
from .mutations import (ALL_METHODS, CHUNK_CHOICES, METHOD_ALGO,
                        METHOD_CHUNK, METHOD_COMM, METHOD_DUP,
                        METHOD_NONDUP, METHOD_PP_INTERLEAVE,
                        METHOD_PP_MICROBATCH, METHOD_PP_SPLIT,
                        METHOD_TENSOR, MUTATIONS, Mutation,
                        active_methods, random_apply, register_mutation)
from .search import SearchResult, backtracking_search
from .baselines import (BASELINES, assign_bucket_algos,
                        assign_bucket_chunks, assign_bucket_comm,
                        evaluate_baselines)

__all__ = [
    "DOT", "EW", "FusionGraph", "LAYOUT", "OPAQUE", "PrimOp", "REDUCE",
    "H100_SXM", "Hardware", "TPU_V5E", "allreduce_time",
    "ring_allreduce_coeffs",
    "OracleEstimator", "group_time_oracle", "prim_time", "profile_graph",
    "total_comm_time", "total_compute_time",
    "SimResult", "Simulator", "BackgroundTraffic", "CommEngine", "CommJob",
    "ComputeJob", "EventEngine", "UnifiedResult",
    "DISC_FAIR", "DISC_FIFO", "TC_COMPUTE", "TC_DP", "TC_PP", "TC_TP",
    "TRAFFIC_CLASSES",
    "PipelineSchedule", "SCHED_1F1B", "SCHED_INTERLEAVED", "SCHEDULES",
    "resolve_schedule",
    "TPTraffic", "balanced_spans", "couple_tp", "couple_tp_pipeline",
    "ALL_METHODS", "CHUNK_CHOICES", "METHOD_ALGO", "METHOD_CHUNK",
    "METHOD_COMM", "METHOD_DUP", "METHOD_NONDUP", "METHOD_PP_INTERLEAVE",
    "METHOD_PP_MICROBATCH", "METHOD_PP_SPLIT", "METHOD_TENSOR",
    "MUTATIONS", "Mutation", "active_methods", "register_mutation",
    "SearchResult", "backtracking_search", "random_apply",
    "BASELINES", "assign_bucket_algos", "assign_bucket_chunks",
    "assign_bucket_comm", "evaluate_baselines",
    "graph_from_fx", "trace_grad_graph",
]

_TRACE_EXPORTS = ("graph_from_fx", "trace_grad_graph")


def __getattr__(name):
    # .trace is the one submodule that imports torch; loading it lazily
    # keeps `import repro_torch.core.<x>` light for the search's worker
    # processes (spawned with a bare interpreter) and for pure-IR consumers.
    if name in _TRACE_EXPORTS:
        from . import trace

        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
