"""Profiling substrate: GNN training samples, fused ops measured on the
device, and a ``Hardware`` fitted to the device (port of
``repro/core/profile_cpu.py``, renamed because it profiles the card).

Tier A: fused-op samples are drawn from traced model graphs by replaying
the paper's sample generator — "randomly select an op and fuse it with one
of its predecessors, repeat" (Sec. 5.2) — labelled by the analytic oracle.

Tier B: synthetic fused ops are built as torch functions, compiled into
one graph each by ``torch.compile`` (where the reference jit-compiles with
XLA) and *timed on the device* (CUDA events on the card, the host clock on
the CPU); the paper's Fig. 9 validates the estimator on such measured
times.

:func:`calibrate_hw` fits the compute fields of a ``Hardware`` from a
matmul's FLOP/s, one read-and-write pass's bandwidth and one launch's host
cost, so the simulator can be held against a measured step (Table 2).
"""
from __future__ import annotations

import random
import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .costs import group_time_oracle, prim_time
from .gnn import group_features
from .graph import DOT, EW, FusionGraph, PrimOp
from .hw import H100_SXM, Hardware


# ----------------------------------------------------------- tier A samples
def sample_fused_groups(
    g: FusionGraph,
    n_samples: int,
    rng: random.Random,
    max_members: int = 32,
    hw: Hardware | None = None,
):
    """Yield (feat, adj, mask, oracle_time) samples of random fused groups."""
    out = []
    for _ in range(n_samples):
        trial = g.clone()
        n_fuse = rng.randint(1, max_members - 1)
        target = None
        for _ in range(n_fuse):
            ok = False
            for _attempt in range(6):
                c = target if target is not None and target in trial.groups \
                    else rng.choice(list(trial.groups))
                preds = list(trial.group_preds(c))
                if not preds:
                    target = None
                    continue
                p = rng.choice(preds)
                before = set(trial.groups)
                if trial.fuse_nondup(c, p):
                    new = (set(trial.groups) - before).pop()
                    target = new
                    ok = True
                    break
                target = None
            if not ok:
                break
        if target is None or target not in trial.groups:
            continue
        if len(trial.groups[target]) < 2:
            continue
        t = group_time_oracle(trial, target, hw) if hw else group_time_oracle(trial, target)
        feat, adj, mask = group_features(trial, target, max_nodes=48)
        out.append((feat, adj, mask, t))
    return out


# ------------------------------------------------- tier B (device-measured)
_UNARY = [torch.tanh, torch.exp, torch.relu, torch.sigmoid, torch.sqrt]
_UNARY_NAMES = ["tanh", "exp", "max", "logistic", "sqrt"]
_BINARY = [torch.add, torch.mul, torch.sub, torch.maximum]
_BINARY_NAMES = ["add", "mul", "sub", "max"]


def synth_fused_op(rng: random.Random, max_nodes: int = 20, dim: int = 256,
                   device="cuda"):
    """Build a random executable fused-op DAG, drawing the reference's
    recipe from the same ``rng`` calls.

    Returns (fn, example_inputs, prims, edges) where prims/edges describe the
    node-level graph for GNN features; the inputs are f32 ``(dim, dim)`` on
    ``device``.
    """
    n_ops = rng.randint(2, max_nodes)
    n_inputs = rng.randint(1, 3)
    shapes = [(dim, dim)] * n_inputs
    recipe = []  # (kind, idx_args, name)
    avail = list(range(n_inputs))  # value slots (inputs first)
    slot_shape = {i: shapes[i] for i in range(n_inputs)}
    next_slot = n_inputs
    for _ in range(n_ops):
        kind = rng.random()
        if kind < 0.15 and len(avail) >= 2:
            a, b = rng.sample(avail, 2)
            if slot_shape[a][-1] == slot_shape[b][0]:
                recipe.append(("dot", (a, b), "dot_general"))
                slot_shape[next_slot] = (slot_shape[a][0], slot_shape[b][-1])
            else:
                op = rng.randrange(len(_BINARY))
                recipe.append(("bin", (a, b, op), _BINARY_NAMES[op]))
                slot_shape[next_slot] = slot_shape[a]
        elif kind < 0.5 and len(avail) >= 2:
            a, b = rng.sample(avail, 2)
            if slot_shape[a] != slot_shape[b]:
                a, b = a, a
            op = rng.randrange(len(_BINARY))
            recipe.append(("bin", (a, b, op), _BINARY_NAMES[op]))
            slot_shape[next_slot] = slot_shape[a]
        else:
            a = rng.choice(avail)
            op = rng.randrange(len(_UNARY))
            recipe.append(("un", (a, op), _UNARY_NAMES[op]))
            slot_shape[next_slot] = slot_shape[a]
        avail.append(next_slot)
        next_slot += 1

    def fn(*inputs):
        slots = list(inputs)
        for kind, args, _ in recipe:
            if kind == "dot":
                v = slots[args[0]] @ slots[args[1]]
            elif kind == "bin":
                v = _BINARY[args[2]](slots[args[0]], slots[args[1]])
            else:
                v = _UNARY[args[1]](torch.abs(slots[args[0]]) + 1e-3)
            slots.append(v)
        return slots[-1]

    # node-level graph (inputs are not nodes; edges between ops only)
    prims, edges = [], []
    for i, (kind, args, name) in enumerate(recipe):
        shape = slot_shape[n_inputs + i]
        nel = float(np.prod(shape))
        if kind == "dot":
            flops = 2.0 * shape[0] * shape[1] * slot_shape[args[0]][1]
            cat = DOT
        else:
            flops = nel
            cat = EW
        in_b = sum(
            float(np.prod(slot_shape[a])) * 4
            for a in args[: 2 if kind != "un" else 1]
        )
        prims.append(PrimOp(pid=i, op_type=name, category=cat, flops=flops,
                            in_bytes=in_b, out_bytes=nel * 4, time=0.0))
        for a in args[: 2 if kind != "un" else 1]:
            if a >= n_inputs:
                edges.append((a - n_inputs, i))
    dev = resolve_device(device)
    example = [torch.from_numpy(np.random.default_rng(0).standard_normal(s)
                                .astype(np.float32)).to(dev) for s in shapes]
    return fn, example, prims, edges


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_time(fn: Callable, dev: torch.device, repeats: int) -> float:
    """Best of ``repeats`` timed calls of ``fn()`` in seconds: CUDA events
    on the card, the host clock around a synchronous call on the CPU."""
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def time_callable(fn: Callable, args, repeats: int = 5,
                  record: dict | None = None) -> float:
    """Compile ``fn`` into one graph with ``torch.compile`` (fresh: dynamo
    is reset first, so closures that share a code object never hit its
    recompile limit), run it once warm, and return the best of
    ``repeats`` timed calls in seconds.  Raises when the compile fails or
    dynamo made anything but exactly one graph (a graph break or a
    recompile); never falls back to eager timing.  ``record``, when given,
    gains ``compile_s`` and ``time_s`` (host seconds) and ``graphs``."""
    from torch._dynamo.utils import counters

    dev = args[0].device
    torch._dynamo.reset()
    graphs0 = counters["stats"]["unique_graphs"]
    breaks0 = sum(counters["graph_break"].values())
    t0 = time.perf_counter()
    # compile in this process: no worker pool outlives the call
    with torch._inductor.config.patch(compile_threads=1):
        cfn = torch.compile(fn, fullgraph=True, dynamic=False)
        cfn(*args)
        _sync(dev)
    t1 = time.perf_counter()
    best = _best_time(lambda: cfn(*args), dev, repeats)
    graphs = counters["stats"]["unique_graphs"] - graphs0
    breaks = sum(counters["graph_break"].values()) - breaks0
    if graphs != 1 or breaks:
        raise RuntimeError(f"torch.compile made {graphs} graphs and "
                           f"{breaks} graph breaks; a fused op must compile "
                           f"into exactly one graph")
    if record is not None:
        record["compile_s"] = record.get("compile_s", 0.0) + t1 - t0
        record["time_s"] = (record.get("time_s", 0.0)
                            + time.perf_counter() - t1)
        record["graphs"] = record.get("graphs", 0) + graphs
    return best


def measured_fused_samples(n_samples: int, seed: int = 0, max_nodes: int = 16,
                           dim: int = 192, device="cuda",
                           record: dict | None = None):
    """Tier-B corpus: (feat, adj, mask, measured_seconds) samples, each
    fused op compiled and timed on ``device``.  ``record`` is passed to
    :func:`time_callable` for every sample."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_samples):
        fn, example, prims, edges = synth_fused_op(rng, max_nodes, dim,
                                                   device)
        t = time_callable(fn, example, record=record)
        # profiled standalone times for node features: the reference's
        # nominal CPU roofline, so features equal the reference's
        hw = CPU_HW
        prims = [
            PrimOp(pid=p.pid, op_type=p.op_type, category=p.category,
                   flops=p.flops, in_bytes=p.in_bytes, out_bytes=p.out_bytes,
                   time=prim_time(p, hw))
            for p in prims
        ]
        fg = FusionGraph(prims, edges)
        # single group containing everything
        while len(fg.groups) > 1:
            gids = list(fg.groups)
            done = False
            for c in gids:
                for p in fg.group_preds(c):
                    if fg.fuse_nondup(c, p):
                        done = True
                        break
                if done:
                    break
            if not done:  # disconnected components: merge artificially
                break
        gid = max(fg.groups, key=lambda g_: len(fg.groups[g_]))
        feat, adj, mask = group_features(fg, gid, max_nodes=48)
        out.append((feat, adj, mask, t))
    return out


# ------------------------------------------------------------- calibration
def launch_cost(device="cuda", n: int = 2000) -> float:
    """Host seconds per launch: ``n`` one-element adds queued back to back
    on the host clock, before the device is waited for."""
    dev = resolve_device(device)
    x = torch.zeros(1, device=dev)
    for _ in range(50):
        x.add_(1)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    host = time.perf_counter() - t
    _sync(dev)
    return host / n


def calibrate_hw(device="cuda") -> Hardware:
    """Fit a ``Hardware`` to ``device`` from three measurements: a square
    matmul's FLOP/s (bf16 at 8192 on the card, f32 at 512 on the CPU), one
    read-and-write pass's bytes/s (each the best of 10 runs) (a single ``torch.mul`` over 256 MiB on
    the card, 16 MB on the CPU) and :func:`launch_cost`.  The efficiency is
    1.0, as in the reference; what one device cannot measure (link
    bandwidth, AllReduce latency, on-chip memory, tile edge) is
    ``H100_SXM``'s."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    n, dt = (8192, torch.bfloat16) if cuda else (512, torch.float32)
    a = torch.randn((n, n), generator=gen, device=dev).to(dt)
    c = torch.empty_like(a)
    torch.mm(a, a, out=c)
    _sync(dev)
    t_mm = _best_time(lambda: torch.mm(a, a, out=c), dev, 10)
    del a, c
    n_el = 64 * 2**20 if cuda else 4_000_000
    x = torch.randn(n_el, generator=gen, device=dev)
    y = torch.empty_like(x)
    torch.mul(x, 1.0001, out=y)
    _sync(dev)
    t_rw = _best_time(lambda: torch.mul(x, 1.0001, out=y), dev, 10)
    del x, y
    return Hardware(
        name=f"{dev.type}-calibrated",
        peak_flops=2.0 * n**3 / max(t_mm, 1e-9),
        hbm_bw=2 * n_el * 4 / max(t_rw, 1e-9),
        ici_bw=H100_SXM.ici_bw, vmem_bytes=H100_SXM.vmem_bytes,
        launch_overhead=max(launch_cost(dev), 1e-7),
        allreduce_latency=H100_SXM.allreduce_latency,
        mxu_dim=H100_SXM.mxu_dim, efficiency=1.0)


CPU_HW = Hardware(name="cpu-nominal", peak_flops=5e10, hbm_bw=1e10,
                  ici_bw=2.5e9, vmem_bytes=32 * 2**20, launch_overhead=5e-6,
                  allreduce_latency=20e-6, efficiency=1.0)
