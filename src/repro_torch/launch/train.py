"""End-to-end training entry point (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 300 --batch 16 --seq 64 --strategy auto \\
        --cluster h100_superpod --plan-out plan.json

Pipeline: synthetic data -> (with ``--strategy auto``) the DisCo search on
the traced step -> the DisCo-enacted data-parallel train step (bucketed
gradient sync over ``torch.distributed``) -> npz checkpoints.  The search
traces the step on meta tensors of the training batch's shape, prices it
for an H100 on ``--cluster`` and freezes the winner into a Plan
(``--plan-out`` saves it).  The strategy can also come from a saved
``repro.plan`` artifact or legacy ``strategy.json`` (``--strategy-file``),
or from one of the built-in strategies; the default is ``ddp``.  Every rank
runs the same deterministic search.

One process per GPU: under ``torchrun`` the world size, rank and rendezvous
come from the environment; otherwise the run is a group of one rank on a
local TCP rendezvous.  NCCL on CUDA, gloo on the CPU.
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from .. import plan as RP
from .. import tree as T
from ..checkpoint import restore_checkpoint, save_checkpoint
from ..cluster import list_presets
from ..configs import ARCHS, get_config
from ..data.pipeline import SyntheticLMDataset, tokens_to_tensor
from ..device import resolve_device
from ..distributed.train_step import GradSyncStrategy, build_train_step
from ..models import stacked as ST
from ..optim import OptState, adamw, linear_warmup_cosine


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device: torch.device) -> bool:
    """Join (or start) the default process group unless one exists.
    Returns True when this call created it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            rank=0, world_size=1)
    return True


def search_strategy(cfg, batch: int, seq: int, n_devices: int,
                    unchanged_limit: int = 80, seed: int = 0, cluster=None):
    """Trace the step at the training batch's shape (on meta tensors) and
    run the DisCo search through the ``repro_torch.plan.compile`` facade.
    ``cluster`` (a preset name or ClusterSpec) prices collectives on that
    topology; default is the legacy flat model.  Returns the Plan; its
    provenance also holds the trace (``"trace"``: wall time, prims by
    category) and the simulated compute time of the traced step before
    and after the search's op fusion (``"compute_time"``)."""
    t0 = time.perf_counter()
    g = RP.trace_model_graph(cfg, batch=batch, seq=seq, reduced=False)
    trace_s = time.perf_counter() - t0
    plan = RP.compile(graph=g, cluster=cluster, n_devices=n_devices,
                      unchanged_limit=unchanged_limit, seed=seed)
    sim = plan.simulator()
    plan.provenance["trace"] = {
        "wall_time": trace_s, "prims": len(g.prims),
        "by_category": dict(Counter(p.category for p in g.prims))}
    plan.provenance["compute_time"] = {
        "initial": sim.run(g).compute_time,
        "best": sim.run(plan.to_graph(g)).compute_time}
    return plan


def _ckpt_tree(params, opt: OptState):
    """(params, opt) in the reference's checkpoint structure: moments
    shaped like the parameter tree, so keypaths match."""
    return (params, OptState(T.unflatten(params, opt.mu),
                             T.unflatten(params, opt.nu), opt.count))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--strategy", default="ddp",
                    choices=["auto", "per-tensor", "ddp", "single-bucket"],
                    help="auto = DisCo backtracking search; the rest are "
                         "built-in strategies (used when no "
                         "--strategy-file is given)")
    ap.add_argument("--strategy-file", default=None,
                    help="enact a saved repro.plan artifact (or a legacy "
                         "strategy.json) instead of searching")
    ap.add_argument("--cluster", default=None, choices=list_presets(),
                    help="cluster preset the strategy search prices "
                         "collectives on")
    ap.add_argument("--plan-out", default=None,
                    help="save the searched Plan here (--strategy auto)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (one GPU per process) or cpu")
    args = ap.parse_args(argv)
    if args.plan_out and (args.strategy != "auto" or args.strategy_file):
        ap.error("--plan-out saves a searched Plan: it needs --strategy "
                 "auto and no --strategy-file")
    return args


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "grad_norms", "step_seconds", "plan"}``
    (per-step host times, each ending in a device sync; the searched Plan
    under ``--strategy auto``, else None)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    created = init_process_group(device)
    try:
        return _train(args, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, device: torch.device) -> dict:
    rank, world = dist.get_rank(), dist.get_world_size()
    log = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{world} ranks")

    params = ST.init_params(cfg, seed=args.seed, device=device)
    leaves = ST.leaves(params)
    n_params = sum(p.numel() for p in leaves)
    log(f"arch={cfg.name} params={n_params / 1e6:.2f}M dp={world} "
        f"device={device}")

    sched = linear_warmup_cosine(args.lr, warmup=20, total_steps=args.steps)
    opt_init, opt_update = adamw(sched, weight_decay=0.01)
    opt = opt_init(leaves)
    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch, seed=args.seed)

    plan = None
    if args.strategy_file:
        strat = GradSyncStrategy.load(args.strategy_file, params=params)
        log(f"loaded strategy: {len(strat.buckets)} buckets")
    elif args.strategy == "auto":
        t0 = time.perf_counter()
        plan = search_strategy(cfg, args.batch, args.seq, n_devices=world,
                               seed=args.seed, cluster=args.cluster)
        strat = plan.grad_sync(params)
        prov = plan.provenance
        log(f"DisCo search: {prov['initial_cost'] * 1e6:.1f} -> "
            f"{prov['best_cost'] * 1e6:.1f} us simulated "
            f"({prov['simulations']} sims, "
            f"{time.perf_counter() - t0:.1f}s); "
            f"{len(strat.buckets)} AllReduce buckets")
        if args.plan_out and rank == 0:
            plan.save(args.plan_out)
    elif args.strategy == "ddp":
        strat = GradSyncStrategy.size_capped(params)
    elif args.strategy == "single-bucket":
        strat = GradSyncStrategy.single_bucket(params)
    else:
        strat = GradSyncStrategy.per_tensor(params)

    step_fn = build_train_step(cfg, mode="ddp_tp", layout="dp",
                               strategy=strat,
                               optimizer=(opt_init, opt_update), remat=True)

    start = 0
    if args.ckpt_dir:
        try:
            (params, ckpt_opt), start = restore_checkpoint(
                args.ckpt_dir, _ckpt_tree(params, opt))
        except FileNotFoundError:
            pass
        else:
            opt = OptState(T.leaves(ckpt_opt.mu), T.leaves(ckpt_opt.nu),
                           ckpt_opt.count)
            log(f"resumed from step {start}")

    losses, gnorms, times = [], [], []
    for step in range(start, args.steps):
        batch = {"tokens": tokens_to_tensor(ds.global_step_batch(step), cfg,
                                            device)}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"step {step:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {gnorms[-1]:.3f}  {times[-1] * 1e3:.0f} ms/step")
        if (args.ckpt_dir and rank == 0 and step > start
                and step % args.ckpt_every == 0):
            save_checkpoint(args.ckpt_dir, step, _ckpt_tree(params, opt))
    if args.ckpt_dir and rank == 0:
        save_checkpoint(args.ckpt_dir, args.steps, _ckpt_tree(params, opt))
    if losses:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        log(f"loss: first10 {first:.4f} -> last10 {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    return {"losses": losses, "grad_norms": gnorms, "step_seconds": times,
            "plan": plan}


if __name__ == "__main__":
    main()
