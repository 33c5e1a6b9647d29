"""Scan regions: the model's marks for the tracer.

Where the reference runs a ``lax.scan`` (a stacked model's layer group, the
chunked cross-entropy), the port runs a Python loop.  The model wraps each
such loop in :func:`scan_region`, so that :mod:`repro_torch.core.trace` can
collapse it into one prim as the reference's tracer does a scan.  Outside a
trace the mark costs one context-variable read; this module imports nothing
of the search, so the model's users do not load it.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools

import torch

# The regions of the trace in progress: a list while the tracer traces.
RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "scan_regions", default=None)
REGION_KEY = "scan_region"


@contextlib.contextmanager
def scan_region():
    """Mark code that the reference runs as one ``lax.scan`` (a layer
    group's loop, the chunked cross-entropy).  Outside a trace it does
    nothing; while tracing it records the fx nodes and autograd sequence
    numbers the code makes."""
    rec = RECORDER.get()
    if rec is None:
        yield
        return
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    graph = get_proxy_mode().tracer.graph
    n0, s0 = len(graph.nodes), torch.autograd._get_sequence_nr()
    yield
    tag_since(graph, n0, ("fwd", len(rec)))
    rec.append((s0, torch.autograd._get_sequence_nr()))


def tag_since(graph, n0: int, unit: tuple) -> None:
    """Tag the fx nodes made since the graph held ``n0`` with ``unit``."""
    for node in itertools.islice(reversed(graph.nodes),
                                 len(graph.nodes) - n0):
        node.meta[REGION_KEY] = unit
