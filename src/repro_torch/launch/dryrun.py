"""Dry run: one rank's training, prefill or decode step on the production
mesh, on fake tensors, and the pricing of its collectives and of saved
Plans (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch tinyllama-1.1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch deepseek-coder-33b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-plan serve.json

With ``--plan <file>`` a saved :class:`repro_torch.plan.Plan` is priced
directly (serialized channel + event engine on its recorded bucket volumes
and cluster fingerprint), and ``--serve-plan <file>`` a saved
:class:`repro_torch.serving.plan.ServingPlan`: no trace, no search, no
step.  A ``--cluster`` override whose fingerprint differs from the
artifact's prints every differing field and exits 1.

Otherwise each (arch, shape, mesh) runs one whole step of one rank of the
256- or 512-rank world in this process -- a training step, a prefill of
the shape's prompts or one decode step over its caches: torch's
``fake`` process-group backend stands in for the other ranks, and the
step runs under ``FakeTensorMode``, so no tensor holds memory.  The
reference compiles the step and reads the compiled HLO; the port counts
what the step issues:

* ``collectives``: every collective the step issues, per op (count,
  result bytes, ring traffic) and by group size, as the reference's
  ``parse_collectives`` reads them from the HLO;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s formulas over
  the step (GEMMs and attention only, where XLA's cost analysis counts
  every op);
* ``bytes_accessed``: each aten op's input and output bytes, views
  excluded (an unfused upper bound); ``transcendentals``: the elements of
  each exp, log, tanh, sigmoid, sqrt and rsqrt output;
* ``memory``: ``argument_bytes`` and ``alias_bytes`` exact (this rank's
  parameters, moments and batch rows, the donated parameters and moments;
  serving: its parameter shard and rows, and for decode its cache shard
  and token, the cache donated), ``output_bytes`` what the step returns,
  ``temp_bytes`` the peak live bytes of the storages the step creates,
  with the softmax kernels' own temporaries (:func:`kernel_temp_bytes`).

The serving steps follow the reference's choices: prefill's parameters
are sharded over ``model`` only and each data rank routes its own
prompts; decode shards them ZeRO-3 style where ``fsdp`` (an MoE arch of
``FSDP_ARCHS``); the rows are split by ``batch_pspec``, so ``long_500k``'s
single row is served by every data rank; prefill takes the kernel-free
path (query-chunked attention for long prompts).

One JSON per combination goes under ``--out`` with a ``cluster`` block
pricing the collectives on ``cluster_from_mesh(mesh)`` or ``--cluster``.
Every chip the pricing assumes defaults to ``H100_SXM``; ``hw=TPU_V5E``
gives the reference's numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..cluster import (COLLECTIVE_ALGOS, best_algo, bucket_time, comm_time,
                       get_preset, list_presets)
from ..core.hw import H100_SXM
from ..core.pipeline import PipelineSchedule, SCHED_1F1B, SCHEDULES
from .shapes import (FSDP_ARCHS, GRAD_ACCUM, SHAPES, ZERO1_ARCHS,
                     applicability, cache_capacity, input_specs)


# ------------------------------------------------------------ collectives
def _ring_factor(op: str, g: int) -> float:
    """Per-device traffic over a ring of ``g``: all-reduce 2(g-1)/g;
    all-gather, reduce-scatter and all-to-all (g-1)/g; a permute 1."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return (g - 1) / g


def empty_collectives() -> dict:
    return {"per_op": {}, "ici_traffic_bytes": 0.0}


def add_collective(coll: dict, op: str, nbytes: float, g: int) -> None:
    """Count one collective of ``nbytes`` (its result) over a group of
    ``g`` into ``coll``, the reference's ``parse_collectives`` schema."""
    factor = _ring_factor(op, g)
    d = coll["per_op"].setdefault(op, {"count": 0, "bytes": 0.0,
                                       "traffic": 0.0, "by_group": {}})
    d["count"] += 1
    d["bytes"] += nbytes
    d["traffic"] += nbytes * factor
    bg = d["by_group"].setdefault(g, {"count": 0, "bytes": 0.0})
    bg["count"] += 1
    bg["bytes"] += nbytes
    coll["ici_traffic_bytes"] += nbytes * factor


# the c10d ops a collective of torch.distributed dispatches to; their first
# argument holds the result (in place for an all-reduce)
_C10D_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "sqrt", "rsqrt", "sin", "cos", "erf"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def kernel_temp_bytes(func, args) -> int:
    """The bytes the card's kernel of ``func`` allocates beyond its result,
    where they are known, for a counter that sees only the results.
    PyTorch's CUDA softmax kernels copy a non-contiguous input to a
    contiguous one, and softmax's backward first forms ``grad * output``,
    laid out as ``grad`` (``aten/src/ATen/native/cuda/SoftMax.cu``); on
    the port's attention the gradient reaching the backward is not
    contiguous, so it allocates twice the scores' bytes (measured on an
    H100).  Other ops count none."""
    name = func._opname
    if name not in ("_softmax", "_log_softmax", "_softmax_backward_data",
                    "_log_softmax_backward_data"):
        return 0
    first, second = args[0], args[1]
    copies = sum(_nbytes(t) for t in (first, second)
                 if isinstance(t, torch.Tensor) and not t.is_contiguous())
    if name == "_softmax_backward_data":
        return _nbytes(first) + copies
    return copies


def _tensors(*groups):
    """The tensors among the given sequences, one list deep."""
    out = []
    for xs in groups:
        for x in xs:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out += [y for y in x if isinstance(y, torch.Tensor)]
    return out


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments, which
    the dispatcher passes boxed."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if (isinstance(a, torch.ScriptObject)
                and a._type().qualified_name().endswith(".ProcessGroup")):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op with no process group")


class StepCounter(TorchDispatchMode):
    """Counts what runs under it: every collective issued (``coll``, the
    reference's ``parse_collectives`` schema, bytes of each result); the
    flops of each op by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: GEMMs, convolutions and
    attention); the bytes each aten op reads and writes, views excluded
    (``bytes_accessed``); the elements of transcendental outputs; and the
    live bytes of the storages created under it, with their ``peak``,
    which also counts each op's :func:`kernel_temp_bytes`.  Works on
    real, meta and fake tensors."""

    def __init__(self):
        super().__init__()
        self.coll = empty_collectives()
        self.flops = 0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.live = self.peak = 0
        self._owned: set = set()

    def _free(self, key, n):
        self._owned.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            op = _C10D_OPS.get(func._opname)
            if op is not None:
                add_collective(self.coll, op, float(sum(
                    _nbytes(t) for t in tree_leaves(args[0])
                    if isinstance(t, torch.Tensor))), _group_size(args))
            return out
        if func.namespace != "aten" or func.is_view:
            return out
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        ins = _tensors(args, kwargs.values())
        outs = _tensors((out,))
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        if func._opname.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._owned:
                continue
            n = st.nbytes()
            self._owned.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live + kernel_temp_bytes(func, args))
        return out


# ----------------------------------------------------------- fake world
@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of an ``n``-rank world whose other ranks do not exist: the
    ``fake`` process-group backend, whose collectives return at once.
    The default process group is destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: dict) -> str:
    """The reference's mesh tag: ``pod16x16``, ``pod2x16x16``."""
    return "pod" + "x".join(str(v) for v in shape.values())


def build_dryrun_train(cfg, mesh, arch: str, *, specs=None,
                       grad_accum=None, strategy=None):
    """One rank's step for ``cfg`` on ``mesh`` with its arguments, built
    on fake tensors (call it under ``FakeTensorMode``): ``mode="fsdp_tp"``
    for ``FSDP_ARCHS``, else ``ddp_tp`` with ``layout="tp"``, its
    gradients synced by ``strategy`` (a ``GradSyncStrategy``; default
    per tensor, the step's own); remat; the
    global batch of ``specs`` (default ``input_specs(cfg, "train_4k")``),
    of which the step takes this rank's rows; ``grad_accum`` defaulting to
    ``GRAD_ACCUM[arch]`` clamped to the local batch; this rank's shards of
    the parameters and f32 AdamW moments.  Returns ``(step, (params,
    opt_state, batch), info)``, ``info`` holding the mode, the grad-accum
    factor and the argument bytes."""
    from .. import tree as T
    from ..distributed import tensor_parallel as TP
    from ..distributed.train_step import build_train_step
    from ..models import stacked as ST
    from ..optim import OptState

    fsdp = arch in FSDP_ARCHS
    mode = "fsdp_tp" if fsdp else "ddp_tp"
    specs = specs if specs is not None else input_specs(cfg, "train_4k")
    dp = math.prod(v for k, v in mesh.shape.items() if k != "model")
    B = specs["tokens"].shape[0]
    accum = grad_accum or min(GRAD_ACCUM.get(arch, 1), B // dp)
    step = build_train_step(cfg, mode=mode, layout="tp", mesh=mesh,
                            strategy=strategy, grad_accum=accum, remat=True,
                            zero1=arch in ZERO1_ARCHS)
    params = TP.shard_params(ST.init_params(cfg, device="cpu"), step.tp)
    leaves = T.leaves(params)
    # the count from a Python constant, so the update can read it
    opt_state = OptState(
        [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        torch.tensor(0, dtype=torch.int32))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}
    p_bytes = sum(_nbytes(p) for p in leaves)
    m_bytes = 2 * sum(_nbytes(m) for m in opt_state.mu) + 4
    b_bytes = sum(_nbytes(v) for v in batch.values()) // dp
    info = {"mode": mode, "grad_accum": accum, "params_bytes": p_bytes,
            "opt_bytes": m_bytes, "batch_bytes": b_bytes}
    return step, (params, opt_state, batch), info


def dryrun_train(cfg, mesh, arch: str, *, specs=None,
                 grad_accum=None, strategy=None) -> dict:
    """One whole training step of this rank on fake tensors, on an open
    (fake or real) world holding ``mesh``, its gradients synced by
    ``strategy`` (:func:`build_dryrun_train`): its flops, bytes, memory
    and collectives, in the reference's keys, and ``fake_step_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, info = build_dryrun_train(cfg, mesh, arch, specs=specs,
                                              grad_accum=grad_accum,
                                              strategy=strategy)
        with StepCounter() as count:
            step(*args)
    wall = time.perf_counter() - t0
    donated = info["params_bytes"] + info["opt_bytes"]
    return {
        "kind": "train",
        "fake_step_s": round(wall, 2),
        "flops": float(count.flops),
        "bytes_accessed": float(count.bytes_accessed),
        "transcendentals": float(count.transcendentals),
        "memory": {
            "argument_bytes": donated + info["batch_bytes"],
            "output_bytes": donated + 8,
            "temp_bytes": count.peak,
            "alias_bytes": donated,
        },
        "collectives": count.coll,
        "grad_accum": info["grad_accum"],
        "mode": info["mode"],
    }


def _local_rows(n: int, mesh) -> int:
    """This data rank's rows of a global batch of ``n``: split over the
    data dims by ``batch_pspec`` where they divide it, else all of
    them."""
    from ..distributed import sharding as SH

    if SH.batch_pspec(n, mesh.shape, 1)[0] is None:
        return n
    return n // SH.dp_size_of(mesh.shape)


def _local_batch(specs: dict, mesh, device) -> dict:
    """Zero tensors of this data rank's rows of each spec in ``specs``."""
    return {k: torch.zeros((_local_rows(v.shape[0], mesh), *v.shape[1:]),
                           dtype=v.dtype, device=device)
            for k, v in specs.items()}


def _serving_params(cfg, tp, device):
    """This rank's shards of ``cfg``'s parameters: drawn on a card there,
    on the host (or, under ``FakeTensorMode``, nowhere) otherwise."""
    from ..distributed import tensor_parallel as TP
    from ..models import stacked as ST

    on_card = torch.device(device).type == "cuda"
    return TP.shard_params(ST.init_params(cfg, device=device,
                                          draw_on_device=on_card), tp)


def build_dryrun_prefill(cfg, mesh, shape: str, *, specs=None,
                         device="cpu"):
    """One rank's prefill of ``shape`` for ``cfg`` on ``mesh``, built on
    fake tensors (call it under ``FakeTensorMode``; ``device`` builds it
    on real ones there instead): the parameters sharded over ``model``
    only (a ``TPContext`` on the model group), this data rank's rows of
    the prompts (``specs``, default ``input_specs(cfg, shape)``), caches
    of ``cache_capacity`` for the prompt length, the kernel-free path.
    Returns ``(step, (params, batch), info)``, ``info`` holding the
    argument bytes."""
    from .. import tree as T
    from ..distributed import tensor_parallel as TP
    from ..models import stacked as ST

    specs = specs if specs is not None else input_specs(cfg, shape)
    cap = cache_capacity(cfg, specs["tokens"].shape[1])
    tp = TP.TPContext(cfg, mesh.model)
    params = _serving_params(cfg, tp, device)
    batch = _local_batch(specs, mesh, device)

    @torch.no_grad()
    def step(params, batch):
        return ST.prefill(params, cfg, batch["tokens"], cap,
                          prefix_emb=batch.get("prefix_emb"),
                          enc_frames=batch.get("enc_frames"), tp=tp)

    p_bytes = sum(_nbytes(p) for p in T.leaves(params))
    b_bytes = sum(_nbytes(v) for v in batch.values())
    return step, (params, batch), {"argument_bytes": p_bytes + b_bytes,
                                   "alias_bytes": 0}


def build_dryrun_decode(cfg, mesh, shape: str, *, fsdp: bool = False,
                        specs=None, device="cpu"):
    """One rank's decode step of ``shape`` for ``cfg`` on ``mesh``, built
    on fake tensors (call it under ``FakeTensorMode``; ``device`` as in
    :func:`build_dryrun_prefill`): the parameters
    sharded over ``model``, and with ``fsdp`` also over the data ranks
    (ZeRO-3's layout, each layer gathered where it runs); this data
    rank's rows of the caches (``specs``, default ``input_specs(cfg,
    shape)``), each leaf this rank's shard by the rules' ``cache_specs``,
    of the token and of the encoder's ``memory``; the position a scalar.
    Returns ``(step, args, info)``, ``info`` holding the argument bytes
    and the cache's, which the step writes in place (donated)."""
    from .. import tree as T
    from ..distributed import tensor_parallel as TP
    from ..models import stacked as ST

    specs = specs if specs is not None else input_specs(cfg, shape)
    tp = (TP.TPContext(cfg, mesh.model, data=mesh.data,
                       mesh_shape=mesh.shape) if fsdp
          else TP.TPContext(cfg, mesh.model))
    params = _serving_params(cfg, tp, device)
    rows = _local_rows(specs["token"].shape[0], mesh)
    local = []
    for leaf, d in zip(T.leaves(specs["caches"]), tp.cache_dims):
        shape_of = [leaf.shape[0], rows, *leaf.shape[2:]]
        if d is not None:
            shape_of[d] //= tp.size
        local.append(torch.zeros(shape_of, dtype=leaf.dtype, device=device))
    caches = T.unflatten(specs["caches"], local)
    rest = _local_batch({k: v for k, v in specs.items()
                         if k in ("token", "memory")}, mesh, device)
    pos = torch.zeros((), dtype=specs["pos"].dtype, device=device)

    @torch.no_grad()
    def step(params, caches, token, pos, memory=None):
        return ST.decode_step(params, cfg, caches, token, pos,
                              memory=memory, tp=tp)

    args = (params, caches, rest["token"], pos)
    if "memory" in rest:
        args += (rest["memory"],)
    c_bytes = sum(_nbytes(c) for c in local)
    a_bytes = (sum(_nbytes(p) for p in T.leaves(params)) + c_bytes
               + sum(_nbytes(v) for v in rest.values()) + _nbytes(pos))
    return step, args, {"argument_bytes": a_bytes, "alias_bytes": c_bytes}


def build_dryrun_serve(cfg, mesh, arch: str, shape: str, *, specs=None,
                       device="cpu"):
    """:func:`build_dryrun_prefill` or :func:`build_dryrun_decode` by the
    kind of ``shape``; decode is ZeRO-3 for an MoE arch of
    ``FSDP_ARCHS``, as the reference's."""
    if SHAPES[shape]["kind"] == "prefill":
        return build_dryrun_prefill(cfg, mesh, shape, specs=specs,
                                    device=device)
    return build_dryrun_decode(
        cfg, mesh, shape, specs=specs, device=device,
        fsdp=arch in FSDP_ARCHS and cfg.moe is not None)


def dryrun_serve(cfg, mesh, arch: str, shape: str, *, specs=None) -> dict:
    """One prefill or decode step of this rank (:func:`build_dryrun_serve`)
    on fake tensors, on an open (fake or real) world holding ``mesh``: its
    flops, bytes, memory and collectives, in the reference's keys
    (``mode`` "auto", no grad accumulation), and ``fake_step_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kind = SHAPES[shape]["kind"]
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, info = build_dryrun_serve(cfg, mesh, arch, shape,
                                              specs=specs)
        with StepCounter() as count:
            out = step(*args)
        out_bytes = sum(_nbytes(t) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
    wall = time.perf_counter() - t0
    return {
        "kind": kind,
        "fake_step_s": round(wall, 2),
        "flops": float(count.flops),
        "bytes_accessed": float(count.bytes_accessed),
        "transcendentals": float(count.transcendentals),
        "memory": {
            "argument_bytes": info["argument_bytes"],
            "output_bytes": out_bytes,
            "temp_bytes": count.peak,
            "alias_bytes": info["alias_bytes"],
        },
        "collectives": count.coll,
        "grad_accum": None,
        "mode": "auto",
    }


# --------------------------------------------------------------- pricing
def dryrun_grads(cfg, mesh, arch: str, *, specs=None,
                 grad_accum=None) -> dict:
    """The part of :func:`dryrun_train`'s step before the sync, clip and
    update (``step.loss_and_grads``: this rank's forward and backward) on
    fake tensors: ``argument_bytes`` (this rank's parameters and batch
    rows) and ``temp_bytes``, the peak live bytes of the storages it
    creates (the gradients and activations)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        step, (params, _, batch), info = build_dryrun_train(
            cfg, mesh, arch, specs=specs, grad_accum=grad_accum)
        with StepCounter() as count:
            step.loss_and_grads(params, batch)
    return {"argument_bytes": info["params_bytes"] + info["batch_bytes"],
            "temp_bytes": count.peak}


def background_from_collectives(coll: dict, tp_degree: int) -> list:
    """Classify the step's collectives into recurring background traffic
    for the event engine: collectives whose group size equals the TP
    degree are tensor-parallel activation traffic; collective-permutes are
    pipeline-parallel stage-boundary transfers.  Returns
    ``(traffic_class, comm_kind, mean_bytes, count)`` tuples.  Heuristic by
    construction: when the DP and TP degrees coincide the split is
    ambiguous and everything counts as TP."""
    kind_map = {"all-reduce": "ar", "all-gather": "ag",
                "reduce-scatter": "rs", "all-to-all": "ag"}
    out = []
    for op, d in coll.get("per_op", {}).items():
        if op == "collective-permute":
            if d.get("count"):
                out.append(("pp", "p2p", d["bytes"] / d["count"],
                            int(d["count"])))
            continue
        kind = kind_map.get(op)
        if kind is None or tp_degree <= 1:
            continue
        bg = d.get("by_group", {}).get(tp_degree)
        if bg and bg["count"]:
            out.append(("tp", kind, bg["bytes"] / bg["count"],
                        int(bg["count"])))
    return out


def collective_cost_model(coll: dict, spec, streams: int = 1,
                          tp_degree: int = 1,
                          keep_timeline: bool = False) -> dict:
    """Price the step's collective traffic on a ClusterSpec: the
    all-reduce traffic under each algorithm, and the cheapest choice,
    priced as ``count`` collectives of the mean size.  The ``rs_ag`` block
    prices the reduce-scatters and all-gathers (ZeRO-3's).  With
    ``streams`` > 1 the ``streams`` block reports the event-engine finish
    of the data-parallel all-reduce set under that many streams next to
    the serialized channel, and, when the step carries TP/PP collectives,
    a ``contention`` block prices the gradient set against them as
    recurring background jobs; ``keep_timeline`` embeds the contended
    schedule's 8-tuple records."""
    ar = coll["per_op"].get("all-reduce", {})
    ar_bytes = ar.get("bytes", 0.0)
    count = max(int(ar.get("count", 0)), 1)
    mean_bytes = ar_bytes / count
    name, t = best_algo(mean_bytes, spec)
    out = {
        "spec": spec.describe(),
        "allreduce_bytes": ar_bytes,
        "allreduce_count": ar.get("count", 0),
        "allreduce_time_s": {
            algo: count * bucket_time(mean_bytes, spec, algo)
            for algo in COLLECTIVE_ALGOS
        },
        "best_algo": name,
        "best_time_s": count * t,
    }
    rs_ag = {}
    for op, kind in (("reduce-scatter", "rs"), ("all-gather", "ag")):
        d = coll["per_op"].get(op)
        if not d or not d.get("count"):
            continue
        mean = d["bytes"] / d["count"]
        times = {algo: d["count"] * comm_time(mean, spec, algo, kind)
                 for algo in COLLECTIVE_ALGOS}
        rs_ag[op] = {
            "bytes": d["bytes"],
            "count": d["count"],
            "time_s": times,
            "best_algo": min(times, key=times.get),
        }
    if rs_ag:
        out["rs_ag"] = rs_ag
    # the DP gradient set: all-reduces minus the TP-group ones; when every
    # all-reduce has the TP group's size the split is ambiguous, and the
    # all-reduces count as the DP set
    ar_groups = set(ar.get("by_group", {}))
    dp_tp_ambiguous = tp_degree > 1 and ar_groups == {tp_degree}
    tp_ar = (ar.get("by_group", {}).get(tp_degree, {"count": 0, "bytes": 0.0})
             if tp_degree > 1 and not dp_tp_ambiguous
             else {"count": 0, "bytes": 0.0})
    dp_count = int(ar.get("count", 0)) - int(tp_ar["count"])
    dp_bytes = ar_bytes - tp_ar["bytes"]
    if streams > 1 and dp_count > 0:
        from ..core.events import BackgroundTraffic, CommEngine, CommJob

        mean_bytes = dp_bytes / dp_count
        name, _ = best_algo(mean_bytes, spec)
        n_jobs = min(dp_count, 128)  # cap the event-loop size
        # readiness staggered at a rate that backlogs the serialized
        # channel: arrivals every t_one/streams keep `streams` jobs in
        # flight
        t_one = comm_time(mean_bytes, spec, name)
        jobs = [CommJob(bucket=i, ready=i * t_one / streams,
                        nbytes=mean_bytes, algo=name) for i in range(n_jobs)]
        ser = CommEngine(spec, streams=1).run(list(jobs))[1]
        pip = CommEngine(spec, streams=streams).run(list(jobs))[1]
        out["streams"] = {
            "streams": streams,
            "jobs": n_jobs,
            "dp_allreduce_count": dp_count,
            "dp_allreduce_bytes": dp_bytes,
            "dp_tp_ambiguous": dp_tp_ambiguous,
            "algo": name,
            "serialized_finish_s": ser,
            "pipelined_finish_s": pip,
            "speedup": ser / pip if pip > 0 else 1.0,
        }
        classified = background_from_collectives(coll, tp_degree)
        if dp_tp_ambiguous:
            classified = [t for t in classified
                          if not (t[0] == "tp" and t[1] == "ar")]
        bg_jobs = []
        base_id = n_jobs + 1
        for tclass, kind, mean, cnt in classified:
            n = min(cnt, 64)  # cap the event-loop size per class
            traffic = BackgroundTraffic(
                tclass, mean, period=pip / n if n else 0.0, kind=kind,
                count=n)
            made = traffic.materialize(pip, base_id)
            base_id += len(made)
            bg_jobs.extend(made)
        if bg_jobs:
            eng = CommEngine(spec, streams=streams)
            tl: list | None = [] if keep_timeline else None
            eng.run(list(jobs) + bg_jobs, tl)
            dp_fin = eng.class_finish.get("dp", 0.0)
            out["contention"] = {
                "classes": [
                    {"traffic_class": tclass, "kind": kind,
                     "mean_bytes": mean, "count": cnt}
                    for tclass, kind, mean, cnt in classified
                ],
                "background_jobs": len(bg_jobs),
                "grad_finish_alone_s": pip,
                "grad_finish_contended_s": dp_fin,
                "slowdown": dp_fin / pip if pip > 0 else 1.0,
                "class_busy_s": dict(eng.class_busy),
            }
            if tl is not None:
                out["contention"]["timeline"] = [list(e) for e in tl]
    return out


def pipeline_cost_model(coll: dict, spec, sched, flops: float,
                        streams: int = 1, keep_timeline: bool = False,
                        hw=None) -> dict:
    """Price the step under a 1F1B pipeline schedule on the unified
    engine: the step's flops on ``hw`` (default ``H100_SXM``) split
    uniformly over the stages and microbatches into fwd/bwd compute units,
    lowered to the schedule's compute+p2p job graph and run with the DP
    gradient all-reduce set, so the block reports the PP bubble and the
    gradient slowdown from sharing link levels with stage-boundary
    transfers.  The p2p volume defaults to the collective-permute mean."""
    from ..core.events import CommJob, EventEngine, TC_PP
    from ..core.pipeline import bubble_stats, lower_schedule

    hw = hw or H100_SXM
    S, M = sched.n_stages, sched.n_microbatches
    r = sched.fwd_bwd_ratio
    step_s = flops / (hw.peak_flops * hw.efficiency)
    stage_busy = [step_s / S] * S
    stage_fwd = [b / M * (r / (1.0 + r)) for b in stage_busy]
    stage_bwd = [b / M - f for b, f in zip(stage_busy, stage_fwd)]
    if sched.p2p_bytes is not None:
        p2p_bytes = sched.p2p_bytes
    else:
        perm = coll.get("per_op", {}).get("collective-permute", {})
        p2p_bytes = (perm["bytes"] / perm["count"]
                     if perm.get("count") else 0.0)
    # the DP gradient set as `count` collectives of the mean size; bucket
    # i deps on stage i % S's last backward
    ar = coll["per_op"].get("all-reduce", {})
    count = int(ar.get("count", 0))
    n_grads, mean, algo = 0, 0.0, "ring"
    if count and ar.get("bytes", 0.0) > 0.0:
        mean = ar["bytes"] / count
        algo, _ = best_algo(mean, spec)
        n_grads = min(count, 128)
    cjobs, p2p, last_bwd, _ = lower_schedule(
        sched, stage_fwd, stage_bwd, p2p_bytes, next_id=n_grads)
    grads = [CommJob(bucket=i, ready=0.0, nbytes=mean, algo=algo,
                     deps=(last_bwd[i % S],))
             for i in range(n_grads)]
    eng = EventEngine(spec, streams=max(int(streams or 1), 1))
    tl: list | None = [] if keep_timeline else None
    u = eng.run_unified(cjobs, grads + p2p, tl)
    grad_fin = eng.class_finish.get("dp", 0.0)
    out = {
        "schedule": sched.schedule,
        "n_stages": S,
        "n_microbatches": M,
        "interleave": sched.chunks_per_stage,
        "ref_chip": hw.name,
        "step_compute_s": step_s,
        "p2p_bytes": p2p_bytes,
        "p2p_jobs": len(p2p),
        "grad_jobs": n_grads,
        "compute_finish_s": u.compute_finish,
        "grad_finish_s": grad_fin,
        "iteration_s": u.finish,
        "p2p_busy_s": eng.class_busy.get(TC_PP, 0.0),
        "bubble": bubble_stats(sched, stage_busy, u.compute_finish),
    }
    if tl is not None:
        out["timeline"] = [list(e) for e in tl]
    return out


def tp_cost_model(coll: dict, spec, tp_degree: int, flops: float,
                  streams: int = 1, keep_timeline: bool = False,
                  hw=None) -> dict | None:
    """Price the step's tensor-parallel activation traffic as dep-coupled
    first-class jobs next to the ``background`` average the contention
    block uses: the step's flops on ``hw`` (default ``H100_SXM``) become a
    chained per-layer compute schedule, each layer's TP collective deps on
    the compute that produced it, and the DP gradient set runs against
    that schedule on the unified engine.  Reports the gradient finish
    alone, under the coupled TP jobs and under the periodic-background
    model of the same volume.  None when the step carries no
    TP-classified collectives."""
    from ..core.events import CommJob, ComputeJob, EventEngine, TC_TP
    from ..core.tp_traffic import TPTraffic, couple_tp

    hw = hw or H100_SXM
    classified = [t for t in background_from_collectives(coll, tp_degree)
                  if t[0] == "tp"]
    if not classified:
        return None
    total_tp = sum(mean * cnt for _, _, mean, cnt in classified)
    count = sum(cnt for _, _, _, cnt in classified)
    if total_tp <= 0.0:
        return None
    # dominant comm kind by volume; half the collectives are the backward
    # mirrors, so the layer count is count/2 (capped for the event loop)
    kind = max(classified, key=lambda t: t[2] * t[3])[1]
    L = max(1, min(count // 2, 32))
    tp = TPTraffic(n_layers=L, fwd_bytes=total_tp / (2.0 * L), kind=kind)
    step_s = flops / (hw.peak_flops * hw.efficiency)
    ar = coll["per_op"].get("all-reduce", {})
    ar_groups = set(ar.get("by_group", {}))
    ambiguous = tp_degree > 1 and ar_groups == {tp_degree}
    tp_ar = (ar.get("by_group", {}).get(tp_degree, {"count": 0, "bytes": 0.0})
             if tp_degree > 1 and not ambiguous
             else {"count": 0, "bytes": 0.0})
    dp_count = int(ar.get("count", 0)) - int(tp_ar["count"])
    dp_bytes = ar.get("bytes", 0.0) - tp_ar["bytes"]
    n_grads, mean, algo = 0, 0.0, "ring"
    if dp_count > 0 and dp_bytes > 0.0:
        mean = dp_bytes / dp_count
        algo, _ = best_algo(mean, spec)
        n_grads = min(dp_count, 128)
    # chained per-layer compute; span s ends at unit s (one unit per layer)
    compute = []
    prev = None
    for i in range(L):
        j = ComputeJob(ref=i, duration=step_s / L, job_id=-(i + 1),
                       key=(i,), deps=() if prev is None else (prev,))
        prev = j.job_id
        compute.append(j)
    coupled, fwd_jobs, bwd_jobs, next_id = couple_tp(
        compute, list(range(1, L + 1)), tp, n_grads)

    def grads(gate_of):
        # bucket i is gated by layer (i % L)'s backward
        return [CommJob(bucket=i, ready=0.0, nbytes=mean, algo=algo,
                        deps=(gate_of(i),)) for i in range(n_grads)]

    last_compute = compute[-1].job_id
    eng = EventEngine(spec, streams=max(int(streams or 1), 1))
    u_alone = eng.run_unified(list(compute), grads(lambda i: last_compute))
    alone = eng.class_finish.get("dp", 0.0)
    gate = ((lambda i: bwd_jobs[i % L].job_id) if bwd_jobs
            else (lambda i: last_compute))
    eng_c = EventEngine(spec, streams=max(int(streams or 1), 1))
    tl: list | None = [] if keep_timeline else None
    u = eng_c.run_unified(list(coupled), grads(gate) + fwd_jobs + bwd_jobs,
                          tl)
    coupled_fin = eng_c.class_finish.get("dp", 0.0)
    bg_jobs = []
    base_id = next_id
    for b in tp.to_background(u_alone.compute_finish):
        made = b.materialize(u_alone.compute_finish, base_id)
        base_id += len(made)
        bg_jobs.extend(made)
    eng_b = EventEngine(spec, streams=max(int(streams or 1), 1))
    eng_b.run_unified(list(compute), grads(lambda i: last_compute) + bg_jobs)
    background_fin = eng_b.class_finish.get("dp", 0.0)
    out = {
        "tp_degree": tp_degree,
        "n_layers": L,
        "fwd_bytes": tp.fwd_bytes,
        "bwd_bytes": tp.bwd,
        "kind": kind,
        "total_tp_bytes": tp.total_bytes,
        "ref_chip": hw.name,
        "step_compute_s": step_s,
        "grad_jobs": n_grads,
        "tp_jobs": len(fwd_jobs) + len(bwd_jobs),
        "compute_finish_s": u.compute_finish,
        "iteration_s": u.finish,
        "tp_busy_s": eng_c.class_busy.get(TC_TP, 0.0),
        "grad_finish_alone_s": alone,
        "grad_finish_coupled_s": coupled_fin,
        "grad_finish_background_s": background_fin,
        "slowdown": coupled_fin / alone if alone > 0 else 1.0,
    }
    if tl is not None:
        out["timeline"] = [list(e) for e in tl]
    return out


# -------------------------------------------------------------- plan pricing
def _write(out_dir, prefix: str, path: str, result: dict, verbose: bool,
           **kw) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = os.path.splitext(os.path.basename(path))[0]
    out_path = os.path.join(out_dir, f"{prefix}__{tag}.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, **kw)
    if verbose:
        print(f"    wrote {out_path}")


def price_plan(path: str, cluster: str | None = None,
               streams: int | None = None,
               out_dir: str | None = None, verbose: bool = True) -> dict:
    """Price a saved :class:`repro_torch.plan.Plan` without re-tracing or
    re-searching (``--plan <file>``): the serialized-channel sum and the
    event-engine finish of its recorded bucket volumes, on the plan's own
    cluster fingerprint or an explicit ``cluster`` override.  An override
    that differs from what the plan was searched against is reported field
    by field (``cluster_fingerprint_diff``)."""
    from ..plan import Plan, cluster_fingerprint, cluster_fingerprint_diff

    plan = Plan.load(path)
    spec = get_preset(cluster) if cluster else None
    result = {
        "plan": path,
        "fingerprint": plan.fingerprint(),
        "describe": plan.describe(),
        "provenance": plan.provenance,
        "pricing": plan.price(cluster=spec, streams=streams),
    }
    if (spec is not None and plan.cluster is not None
            and not result["pricing"]["cluster_fingerprint_match"]):
        result["pricing"]["cluster_fingerprint_diff"] = \
            cluster_fingerprint_diff(plan.cluster, cluster_fingerprint(spec))
    if verbose:
        p = result["pricing"]
        print(f"  plan {path} [{result['fingerprint']}]: "
              f"{p['buckets']} buckets, "
              f"{p['total_grad_bytes']:.3e} B on {p['cluster']['name']} "
              f"(fingerprint match: {p['cluster_fingerprint_match']})")
        for line in p.get("cluster_fingerprint_diff", ()):
            print(f"    fingerprint diff: {line}")
        print(f"    serialized comm {p['serialized_comm_s']*1e3:.3f} ms, "
              f"{p['streams']}-stream engine finish "
              f"{p['engine_finish_s']*1e3:.3f} ms, searched prediction "
              f"{(plan.predicted_iteration_time or 0.0)*1e3:.3f} ms")
    if out_dir:
        _write(out_dir, "plan", path, result, verbose)
    return result


def price_serving_plan(path: str, cluster: str | None = None,
                       out_dir: str | None = None,
                       verbose: bool = True) -> dict:
    """Price a saved :class:`repro_torch.serving.plan.ServingPlan`
    (``--serve-plan <file>``): the decode-step lowering re-run with the
    plan's searched knobs on its recorded cluster fingerprint or an
    explicit ``cluster`` override, a mismatch diagnosed field by field as
    :func:`price_plan` does."""
    from ..plan import cluster_fingerprint, cluster_fingerprint_diff
    from ..serving.plan import ServingPlan

    plan = ServingPlan.load(path)
    spec = get_preset(cluster) if cluster else None
    result = {
        "serve_plan": path,
        "fingerprint": plan.fingerprint(),
        "describe": plan.describe(),
        "provenance": plan.provenance,
        "pricing": plan.price(cluster=spec),
    }
    if spec is not None and not result["pricing"]["cluster_fingerprint_match"]:
        result["pricing"]["cluster_fingerprint_diff"] = \
            cluster_fingerprint_diff(plan.cluster, cluster_fingerprint(spec))
    if verbose:
        p = result["pricing"]
        d = result["describe"]
        print(f"  serve-plan {path} [{result['fingerprint']}]: "
              f"{d['arch']} slots={d['slots']} batch={d['decode_batch']} "
              f"kv={d['kv_layout']} algo={d['algo']} "
              f"streams={d['streams']} on {p['cluster']['name']} "
              f"(fingerprint match: {p['cluster_fingerprint_match']})")
        for line in p.get("cluster_fingerprint_diff", ()):
            print(f"    fingerprint diff: {line}")
        print(f"    {p['tokens_per_s']:.0f} tok/s "
              f"({p['seconds_per_token']*1e6:.2f} us/token), "
              f"ttft p99 {p['ttft_p99_s']*1e3:.3f} ms, "
              f"decode TP traffic {p['tp_bytes_decode']:.3e} B, "
              f"HBM {p['mem_bytes']/1e9:.2f}/{p['hbm_bytes']/1e9:.0f} GB; "
              f"searched prediction "
              f"{plan.predicted_tokens_per_s:.0f} tok/s")
    if out_dir:
        _write(out_dir, "serve_plan", path, result, verbose, default=repr)
    return result


# -------------------------------------------------------------------- main
def dryrun_one(arch: str, shape: str = "train_4k", multi_pod: bool = False,
               verbose: bool = True, cluster: str | None = None,
               streams: int = 1, keep_timeline: bool = False,
               pp=None, mesh_shape: dict | None = None, cfg=None,
               specs=None, grad_accum=None) -> dict:
    """Dry-run ``arch`` at ``shape`` as rank 0 of the production mesh
    (``multi_pod``: 2x16x16) in a fake world opened and closed here.
    ``mesh_shape`` (dim name -> size), ``cfg``, ``specs`` and
    ``grad_accum`` replace the production mesh, the registry's config,
    the shape's batch (prompts, or the decode step's inputs) and the
    grad-accum factor, for small worlds and reduced models.  Returns the
    reference's result keys."""
    from ..configs import get_config
    from .mesh import (PRODUCTION_SHAPES, cluster_from_mesh, make_mesh,
                       make_production_mesh)

    cfg0 = cfg or get_config(arch)
    ok, reason, cfg = applicability(cfg0, shape)
    shape_of = mesh_shape or PRODUCTION_SHAPES[multi_pod]
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name(shape_of),
        "applicable": ok, "reason": reason,
    }
    if not ok:
        return result
    with fake_world(math.prod(shape_of.values())):
        mesh = (make_mesh(shape_of, device="cpu") if mesh_shape else
                make_production_mesh(multi_pod, device="cpu"))
        if SHAPES[shape]["kind"] == "train":
            result.update(dryrun_train(cfg, mesh, arch, specs=specs,
                                       grad_accum=grad_accum))
        else:
            result.update(dryrun_serve(cfg, mesh, arch, shape, specs=specs))
    coll, flops = result["collectives"], result["flops"]
    spec = get_preset(cluster) if cluster else cluster_from_mesh(mesh)
    tp_degree = int(shape_of.get("model", 1))
    result["cluster"] = collective_cost_model(
        coll, spec, streams=streams, tp_degree=tp_degree,
        keep_timeline=keep_timeline)
    tpb = tp_cost_model(coll, spec, tp_degree, flops, streams=streams,
                        keep_timeline=keep_timeline)
    if tpb is not None:
        result["cluster"]["tp"] = tpb
    if pp is not None:
        result["cluster"]["pp"] = pipeline_cost_model(
            coll, spec, pp, flops, streams=streams,
            keep_timeline=keep_timeline)
    if verbose:
        m = result["memory"]
        peak = (m["argument_bytes"] + m["temp_bytes"]) / 2**30
        print(f"  {arch} x {shape} x {result['mesh']}: fake step OK "
              f"({result['fake_step_s']:.1f} s, args+temp {peak:.2f} "
              f"GiB/dev, flops {flops:.3e}, "
              f"ici {coll['ici_traffic_bytes']:.3e} B)")
    return result


def _print_timelines(tag: str, res: dict) -> None:
    rec = res.get("cluster", {}).get("contention", {}).get("timeline")
    if rec:
        print(f"  {tag} comm timeline (kind, bucket, chunk, class, algo, "
              f"level, start, end):")
        for e in rec:
            print(f"    {tuple(e)}")
    tpb = res.get("cluster", {}).get("tp", {})
    if tpb.get("timeline"):
        print(f"  {tag} dep-coupled tp timeline (kind, ref/bucket, *, "
              f"class, resource, start, end):")
        for e in tpb["timeline"]:
            print(f"    {tuple(e)}")
    if tpb:
        print(f"  {tag} tp coupling: {tpb['n_layers']} layers x "
              f"{tpb['total_tp_bytes']:.3e} B total, grad finish alone "
              f"{tpb['grad_finish_alone_s']*1e3:.3f} ms, coupled "
              f"{tpb['grad_finish_coupled_s']*1e3:.3f} ms, background model "
              f"{tpb['grad_finish_background_s']*1e3:.3f} ms")
    ppb = res.get("cluster", {}).get("pp", {})
    if ppb.get("timeline"):
        print(f"  {tag} unified pp timeline (kind, ref, *, class, resource, "
              f"start, end):")
        for e in ppb["timeline"]:
            print(f"    {tuple(e)}")
    if ppb:
        bub = ppb["bubble"]
        print(f"  {tag} pp bubble: fraction {bub['fraction']:.3f} over "
              f"{ppb['n_stages']} stages x {ppb['n_microbatches']} "
              f"microbatches (compute finish "
              f"{ppb['compute_finish_s']*1e3:.3f} ms, iteration "
              f"{ppb['iteration_s']*1e3:.3f} ms)")


def _mismatch(kind: str, path: str, cluster, result: dict) -> None:
    diff = result["pricing"].get("cluster_fingerprint_diff")
    if diff:
        print(f"CLUSTER MISMATCH: {kind} {path} was searched against a "
              f"different topology than --cluster {cluster} ({len(diff)} "
              f"field(s) differ; first: {diff[0]})")
        raise SystemExit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="train_4k",
                    help="an input shape of launch/shapes.py, or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cluster", default=None, choices=list_presets(),
                    help="cluster preset to price collectives on; default: "
                         "derived from the mesh by cluster_from_mesh")
    ap.add_argument("--streams", type=int, default=None,
                    help="price the AllReduce set under N concurrent "
                         "event-engine streams next to the serialized "
                         "channel (with --plan: overrides the artifact's "
                         "recorded width; default: the recorded width)")
    ap.add_argument("--timeline", action="store_true",
                    help="print (and embed) the contended comm schedule as "
                         "8-tuple records (kind, bucket, chunk, "
                         "traffic_class, algo, level, start, end; needs "
                         "--streams > 1), the cluster.tp block's "
                         "dep-coupled schedule and, with --pp-stages, the "
                         "unified compute+p2p+grad records and the PP "
                         "bubble")
    ap.add_argument("--pp-stages", type=int, default=None,
                    help="price the step under a 1F1B pipeline schedule "
                         "with this many stages (adds a cluster.pp block)")
    ap.add_argument("--pp-microbatches", type=int, default=8,
                    help="microbatches per iteration for --pp-stages")
    ap.add_argument("--pp-schedule", default=SCHED_1F1B,
                    choices=list(SCHEDULES),
                    help="pipeline schedule family (default 1f1b)")
    ap.add_argument("--pp-interleave", type=int, default=1,
                    help="virtual-stage chunks per device for "
                         "interleaved_1f1b (default 1)")
    ap.add_argument("--plan", default=None, metavar="FILE",
                    help="price a saved repro.plan artifact (no trace, no "
                         "search, no step); --cluster overrides the "
                         "recorded topology, --streams the engine width")
    ap.add_argument("--serve-plan", default=None, metavar="FILE",
                    help="price a saved serving-plan artifact; --cluster "
                         "overrides the recorded topology")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.serve_plan:
        result = price_serving_plan(args.serve_plan, cluster=args.cluster,
                                    out_dir=args.out)
        _mismatch("serve-plan", args.serve_plan, args.cluster, result)
        return
    if args.plan:
        result = price_plan(args.plan, cluster=args.cluster,
                            streams=args.streams, out_dir=args.out)
        _mismatch("plan", args.plan, args.cluster, result)
        return

    from ..configs import ARCHS

    pp = None
    if args.pp_stages:
        pp = PipelineSchedule(n_stages=args.pp_stages,
                              n_microbatches=args.pp_microbatches,
                              schedule=args.pp_schedule,
                              interleave=args.pp_interleave)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2x16x16' if mp else 'pod16x16'}"
                try:
                    res = dryrun_one(arch, shape, mp, cluster=args.cluster,
                                     streams=args.streams or 1,
                                     keep_timeline=args.timeline, pp=pp)
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    failures.append(tag)
                    res = {"arch": arch, "shape": shape, "error": str(e)}
                if args.timeline:
                    _print_timelines(tag, res)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print(f"FAILURES ({len(failures)}): {failures}")
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
