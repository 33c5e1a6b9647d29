"""torch program -> FusionGraph tracer (port of ``repro/core/trace.py``).

Traces the per-device forward and backward of a training step with
``make_fx`` into an aten-level fx graph, on meta tensors, so a trace of a
full-width model spends no memory and no device time.  Each aten op becomes
one :class:`PrimOp` with the reference's categories and cost rules:

* DOT (``mm``, ``bmm``, ``addmm``, ...): 2 * out * K FLOPs;
* EW (ops tagged ``torch.Tag.pointwise``): one FLOP per output element;
* REDUCE (sums, maxes, means, softmaxes): in_bytes / 4 FLOPs;
* LAYOUT (views, permutes, casts, cat, slices, index, gather, scatter,
  embedding, factories): no FLOPs, and reads at most what it writes;
* OPAQUE: everything else, one FLOP per output element.

Nodes that launch nothing and have no jaxpr counterpart (``detach``,
``alias``, ``lift_fresh_copy``, ``getitem``) pass their producer through.

Where the reference runs a ``lax.scan`` (a stacked model's layer group, the
chunked cross-entropy), the port runs a Python loop, which ``make_fx``
unrolls.  The model marks each such loop with
:func:`repro_torch.models.regions.scan_region`; the tracer collapses the
region's forward ops, and separately the backward ops that differentiate
them (the ops made while an autograd node of the region runs, found by
hooks on those nodes), into one OPAQUE prim each, whose FLOPs and bytes
are its members' sums, as the reference prices a scan as its body times
its trips.  Any node on a path that leaves a region and comes back is
absorbed into it, so the collapsed graph stays acyclic.

One gradient marker per parameter leaf, in leaf order, with the
reference's collision rule: a ``grad_identity`` prim when two leaves share
a producer or a gradient is a graph input.
"""
from __future__ import annotations

import bisect
import heapq
import math
import operator
from typing import Callable

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

from .. import tree as T
from ..models.regions import RECORDER, REGION_KEY, tag_since
from .graph import DOT, EW, FusionGraph, LAYOUT, OPAQUE, PrimOp, REDUCE

_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot"}
_REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "var", "std", "var_mean", "norm",
    "any", "all", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
_LAYOUT_OPS = {
    # views and copies that change layout or dtype
    "view", "_unsafe_view", "reshape", "permute", "t", "transpose",
    "unsqueeze", "squeeze", "expand", "slice", "select", "unbind", "split",
    "split_with_sizes", "narrow", "as_strided", "diagonal", "flip", "roll",
    "repeat", "cat", "stack", "_to_copy", "constant_pad_nd",
    # index, gather, scatter and embedding, with their backwards
    "index", "index_select", "gather", "scatter", "scatter_add",
    "index_put", "index_add", "embedding", "embedding_dense_backward",
    "slice_backward", "select_backward",
    # factories (the reference's iota and broadcast literals)
    "zeros", "ones", "full", "empty", "arange", "scalar_tensor",
    "zeros_like", "ones_like", "full_like", "empty_like", "new_zeros",
    "new_ones", "new_full", "new_empty",
}
# Launch nothing and have no counterpart in a jaxpr: pass the producer on.
_PASS_OPS = {"detach", "alias", "lift_fresh_copy"}

def _hook_backward(loss: torch.Tensor, regions: list) -> None:
    """Hook every autograd node that a region's forward made, so that the
    fx nodes its backward makes are tagged ``("bwd", region)``."""
    graph = get_proxy_mode().tracer.graph
    starts = [r[0] for r in regions]

    def region_of(fn) -> int | None:
        seq = fn._sequence_nr()
        ri = bisect.bisect_right(starts, seq) - 1
        return ri if ri >= 0 and seq < regions[ri][1] else None

    def hooks(ri):
        opened: list = []

        def pre(grad_outputs):
            opened.append(len(graph.nodes))

        def post(grad_inputs, grad_outputs):
            tag_since(graph, opened.pop(), ("bwd", ri))
        return pre, post

    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        ri = region_of(fn)
        if ri is not None:
            pre, post = hooks(ri)
            fn.register_prehook(pre)
            fn.register_hook(post)
        stack += [f for f, _ in fn.next_functions]


# ------------------------------------------------------------------- costs
def _tensors(val) -> list:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(val) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(val)))


def _op_name(node) -> str:
    if node.target is operator.getitem:
        return "getitem"
    packet = getattr(node.target, "_overloadpacket", None)
    return packet.__name__ if packet is not None else str(node.target)


def _classify(node) -> str:
    name = _op_name(node)
    if name in _DOT_OPS:
        return DOT
    if name in _LAYOUT_OPS:
        return LAYOUT
    if name in _REDUCE_OPS:
        return REDUCE
    if torch.Tag.pointwise in getattr(node.target, "tags", ()):
        return EW
    if name in ("clone", "copy"):   # the reference's EW ``copy``
        return EW
    return OPAQUE


def _arg_nodes(node) -> list:
    out = []
    for a in node.args + tuple(node.kwargs.values()):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [x for x in a if isinstance(x, torch.fx.Node)]
    return out


def _dot_flops(node) -> float:
    """2 * out * K, K the contracted length of the left operand."""
    name = _op_name(node)
    lhs = node.args[1] if name in ("addmm", "baddbmm", "addbmm") \
        else node.args[0]
    k = float(lhs.meta["val"].shape[-1])
    out = node.meta["val"]
    return 2.0 * float(out.numel()) * k


def _node_cost(node) -> tuple[str, float, float, float]:
    """(category, flops, in_bytes, out_bytes) of one aten node."""
    cat = _classify(node)
    in_b = sum(_nbytes(a.meta.get("val")) for a in _arg_nodes(node))
    out_b = _nbytes(node.meta.get("val"))
    out_elems = float(sum(t.numel() for t in _tensors(node.meta.get("val"))))
    if cat == DOT:
        flops = _dot_flops(node)
    elif cat == EW:
        flops = out_elems
    elif cat == REDUCE:
        flops = in_b / 4.0
    elif cat == LAYOUT:
        flops = 0.0
        in_b = min(in_b, out_b * 2 + 64)
    else:
        flops = out_elems
    return cat, flops, in_b, out_b


# -------------------------------------------------------------- the graph
def _close_regions(kept: list, preds: dict, unit: dict) -> None:
    """Absorb into each region every node on a path that leaves the region
    and re-enters it, so that collapsing it makes no cycle."""
    succs: dict = {n: [] for n in kept}
    for n in kept:
        for p in preds[n]:
            succs[p].append(n)

    def reach(start, step):
        seen, stack = set(), list(start)
        while stack:
            n = stack.pop()
            for m in step[n]:
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        return seen

    changed = True
    while changed:
        changed = False
        for u in sorted(set(unit.values())):
            members = [n for n in kept if unit.get(n) == u]
            between = reach(members, succs) & reach(members, preds)
            for n in between:
                if unit.get(n) != u:
                    unit[n] = u
                    changed = True


def graph_from_fx(gm: torch.fx.GraphModule, regions: list,
                  grad_bytes: list, grad_sigs: list) -> FusionGraph:
    """Build a FusionGraph from ``gm``, a traced ``(params, batch) ->
    (loss, grads)`` program whose output holds the loss and then one
    gradient per leaf; ``regions`` as ``scan_region`` records them
    (empty: no collapse)."""
    nodes = list(gm.graph.nodes)
    out_node = nodes[-1]
    loss, grads = out_node.args[0][0], out_node.args[0][1:]

    # pass-through: dropped nodes resolve to their producer
    source: dict = {}
    kept = []
    for node in nodes:
        if node.op != "call_function":
            source[node] = None
            continue
        if _op_name(node) in _PASS_OPS or node.target is operator.getitem:
            src = node.args[0]
            source[node] = source.get(src)
            continue
        source[node] = node
        kept.append(node)
    preds = {n: {source[a] for a in _arg_nodes(n)} - {None} for n in kept}

    unit = ({n: n.meta[REGION_KEY] for n in nodes if REGION_KEY in n.meta}
            if regions else {})
    _close_regions(kept, preds, unit)
    key = {n: unit.get(n, ("node", i)) for i, n in enumerate(kept)}

    # collapsed units: members, cost, edges
    members: dict = {}
    first: dict = {}
    for i, n in enumerate(kept):
        members.setdefault(key[n], []).append(n)
        first.setdefault(key[n], i)
    uedges, leaving = set(), set()
    for n in kept:
        for p in preds[n]:
            if key[p] != key[n]:
                uedges.add((key[p], key[n]))
                leaving.add(p)
    upreds: dict = {u: set() for u in members}
    usuccs: dict = {u: set() for u in members}
    for a, b in uedges:
        usuccs[a].add(b)
        upreds[b].add(a)

    # pids in a topological order, ties broken by position in the trace
    indeg = {u: len(upreds[u]) for u in members}
    heap = [(first[u], u) for u in members if indeg[u] == 0]
    heapq.heapify(heap)
    pid_of: dict = {}
    while heap:
        _, u = heapq.heappop(heap)
        pid_of[u] = len(pid_of)
        for v in usuccs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(heap, (first[v], v))
    if len(pid_of) != len(members):
        raise RuntimeError("collapsed trace graph is cyclic")

    graph_out = {source.get(g) for g in grads} | {source.get(loss)}
    prims: list = [None] * len(pid_of)
    for u, pid in pid_of.items():
        ms = members[u]
        costs = [_node_cost(n) for n in ms]
        if u[0] == "node":
            cat, flops, in_b, out_b = costs[0]
            op_type = _op_name(ms[0])
        else:
            inside = set(ms)
            ext_in = sum(_nbytes(a.meta.get("val")) for a in
                         {a for n in ms for a in _arg_nodes(n)}
                         if source.get(a) not in inside)
            ext_out = sum(_nbytes(n.meta.get("val")) for n in ms
                          if n in leaving or n in graph_out)
            cat, op_type = OPAQUE, "scan"
            flops = math.fsum(c[1] for c in costs)
            in_b = max(ext_in, math.fsum(c[2] for c in costs))
            out_b = max(ext_out, math.fsum(c[3] for c in costs))
        prims[pid] = PrimOp(pid=pid, op_type=op_type, category=cat,
                            flops=flops, in_bytes=in_b, out_bytes=out_b,
                            time=0.0)
    edges = {(pid_of[a], pid_of[b]) for a, b in uedges}

    # gradient markers; identity prims on collision
    marked: set = set()
    for gi, (g, gb) in enumerate(zip(grads, grad_bytes)):
        src = source.get(g)
        pid = pid_of[key[src]] if src is not None else None
        if pid is None or pid in marked:
            new = len(prims)
            prims.append(PrimOp(pid=new, op_type="grad_identity",
                                category=EW, flops=0.0, in_bytes=gb,
                                out_bytes=gb, time=0.0))
            if pid is not None:
                edges.add((pid, new))
            pid = new
        marked.add(pid)
        p = prims[pid]
        prims[pid] = PrimOp(
            pid=p.pid, op_type=p.op_type, category=p.category,
            flops=p.flops, in_bytes=p.in_bytes, out_bytes=p.out_bytes,
            time=p.time, grad_param=gi, grad_bytes=float(gb),
            grad_sig=grad_sigs[gi])
    return FusionGraph(prims, edges)


def trace_fx(loss_fn: Callable, params, batch
             ) -> tuple[torch.fx.GraphModule, list]:
    """``make_fx`` of ``(loss, *torch.autograd.grad(loss, leaves))``, and
    the regions ``scan_region`` recorded: ``(first autograd sequence
    number, one past the last)`` each."""
    leaves = [l.detach().requires_grad_(True) for l in T.leaves(params)]

    def step(leaves, batch):
        loss = loss_fn(T.unflatten(params, leaves), batch)
        _hook_backward(loss, regions)
        return (loss, *torch.autograd.grad(loss, leaves))

    regions: list = []
    token = RECORDER.set(regions)
    try:
        gm = make_fx(step)(leaves, batch)
    finally:
        RECORDER.reset(token)
    return gm, regions


def trace_grad_graph(
    loss_fn: Callable,
    params,
    batch,
    grad_sig_fn: Callable[[int, object], str] | None = None,
) -> FusionGraph:
    """Trace ``torch.autograd.grad(loss_fn(params, batch), leaves)`` into a
    FusionGraph with one AllReduce per parameter-gradient leaf — the
    per-device data-parallel training graph DisCo optimises.  Give it meta
    tensors to trace at any width."""
    gm, regions = trace_fx(loss_fn, params, batch)
    return graph_from_fx(gm, regions, *grad_markers(params, grad_sig_fn))


def grad_markers(params, grad_sig_fn=None) -> tuple[list, list]:
    """Each leaf's gradient bytes and partition signature (its dtype by
    default), in leaf order."""
    leaves = T.leaves(params)
    gbytes = [float(l.numel() * l.element_size()) for l in leaves]
    if grad_sig_fn is not None:
        sigs = [grad_sig_fn(i, l) for i, l in enumerate(leaves)]
    else:   # numpy's dtype names, as the reference's str(leaf.dtype)
        sigs = [str(l.dtype).replace("torch.", "") for l in leaves]
    return gbytes, sigs
