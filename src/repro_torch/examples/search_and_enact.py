"""Search -> save -> enact: the DisCo workflow end to end (paper Sec. 3.1;
port of ``examples/search_and_enact.py``).

    python -m repro_torch.examples.search_and_enact               # on the GPU
    python -m repro_torch.examples.search_and_enact --device cpu
    python -m repro_torch.examples.search_and_enact \\
        --cluster a100_nvlink_ib --streams 4 --device cpu

Search Phase: :func:`repro_torch.plan.compile` traces reduced qwen2-0.5b's
training step, searches it and returns a frozen, versioned
:class:`~repro_torch.plan.Plan`; ``plan.save()`` writes its JSON.

Enactment Phase: ``Plan.load()`` round-trips the artifact (checked bit
for bit) and ``plan.grad_sync(params)`` lowers it to the
:class:`~repro_torch.distributed.train_step.GradSyncStrategy` the train
step enacts.  Where the reference compiles the ``ddp_tp`` step on a (4, 2)
mesh and reads the collectives from the HLO, the port counts those one
rank's step runs (:class:`~repro_torch.launch.dryrun.StepCounter`) on a
fake (4, 2) world, on fake tensors, under the per-tensor strategy and
under the Plan: the data group's all-reduces shrink, and its counts are
what the Plan's buckets imply, chunk by chunk (not what an XLA combiner
would leave).  Then one real step of the Plan runs on a one-rank (1, 1)
mesh of the device (NCCL on a GPU, where it launches the sync kernels;
gloo on the CPU).

:func:`search`, :func:`count_collectives`, :func:`implied_data_counts`
and :func:`enact` take a config, so the same steps run at full width.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

ARCH = "qwen2-0.5b"
SEARCH = dict(n_devices=4, unchanged_limit=120, seed=0)
MESH = {"data": 4, "model": 2}      # the reference's (4, 2) mesh
BATCH, SEQ = 8, 64


def search(cfg, *, cluster=None, streams: int = 1, max_steps=None,
           reduced: bool = True):
    """The Search Phase: ``repro_torch.plan.compile`` of ``cfg`` (a name
    or config; ``reduced`` cuts it to its reduced size first) for 4
    devices, as the reference's example searches."""
    from .. import plan as RP

    return RP.compile(cfg, cluster=cluster, streams=streams,
                      max_steps=max_steps, reduced=reduced, **SEARCH)


def save_and_load(plan, path: str):
    """``plan`` saved to ``path`` and loaded back; raises unless the round
    trip is exact, fingerprint included."""
    from ..plan import Plan

    plan.save(path)
    loaded = Plan.load(path)
    if loaded != plan or loaded.fingerprint() != plan.fingerprint():
        raise RuntimeError("plan save/load round trip drifted")
    return loaded


def meta_leaves(cfg) -> list:
    """``cfg``'s parameter leaves on the meta device (shapes and dtypes:
    what a strategy indexes)."""
    import torch

    from ..models import stacked as ST

    with torch.device("meta"):
        return ST.leaves(ST.init_params(cfg, device="meta"))


def count_collectives(cfg, strategy, *, mesh_shape=None) -> dict:
    """The collectives of one rank's ``ddp_tp`` step (``layout="tp"``,
    remat) of ``cfg`` at ``BATCH`` x ``SEQ``, its gradients synced by
    ``strategy``, on a fake world of ``mesh_shape`` (default the (4, 2)
    mesh) on fake tensors: ``StepCounter``'s ``per_op`` counts."""
    from ..data.pipeline import make_batch_specs
    from ..launch import dryrun as DR
    from ..launch.mesh import make_mesh

    shape = dict(mesh_shape or MESH)
    with DR.fake_world(math.prod(shape.values())):
        mesh = make_mesh(shape, device="cpu")
        res = DR.dryrun_train(cfg, mesh, ARCH,
                              specs=make_batch_specs(cfg, BATCH, SEQ),
                              strategy=strategy)
    return res["collectives"]


def by_group(coll: dict, size: int) -> dict:
    """Each op's count over the groups of ``size`` ranks."""
    return {op: d["by_group"][size]["count"]
            for op, d in sorted(coll["per_op"].items())
            if size in d["by_group"]}


def implied_data_counts(strategy, leaves) -> dict:
    """The data group's collectives one step of ``strategy`` runs over
    ``leaves`` (this rank's): per chunk of a bucket, an all-reduce for an
    unfused ``ar`` bucket, else a reduce-scatter and an all-gather (a
    fused bucket always), the chunks capped at the bucket's elements; and
    the loss's all-reduce."""
    ar = rs = 0
    for bi, b in enumerate(strategy.buckets):
        k = min(strategy.chunk_count(bi),
                max(sum(leaves[i].numel() for i in b), 1))
        if strategy.comm_kind(bi) == "ar" and not strategy.is_fused(bi):
            ar += k
        else:
            rs += k
    out = {"all-reduce": ar + 1}
    if rs:
        out.update({"all-gather": rs, "reduce-scatter": rs})
    return out


def enact(cfg, strategy, device) -> dict:
    """One AdamW step of ``cfg`` (weights from seed 0, drawn on a GPU
    there) under ``mode="ddp_tp"``, ``layout="tp"`` on a one-rank (1, 1)
    mesh of ``device`` (NCCL on a GPU, gloo on the CPU), its gradients
    synced by ``strategy``, on ``materialize_batch``'s ``BATCH`` x ``SEQ``
    batch.  Returns the loss, the gradient norm and the step's seconds
    (host clock, the device synced)."""
    import torch
    import torch.distributed as dist

    from ..data.pipeline import materialize_batch
    from ..distributed import tensor_parallel as TP
    from ..distributed.train_step import build_train_step
    from ..launch.mesh import make_debug_mesh
    from ..launch.train import init_process_group
    from ..models import stacked as ST
    from ..optim import adamw

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    created = init_process_group(device)
    try:
        mesh = make_debug_mesh((1, 1), device=device.type)
        opt = adamw(1e-3, weight_decay=0.01)
        step = build_train_step(cfg, mode="ddp_tp", layout="tp", mesh=mesh,
                                strategy=strategy, optimizer=opt,
                                remat=True)
        params = TP.shard_params(ST.init_params(
            cfg, seed=0, device=device,
            draw_on_device=device.type == "cuda"), step.tp)
        state = opt[0](ST.leaves(params))
        data = materialize_batch(cfg, BATCH, SEQ, device=device)
        sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, data)
        sync()
        seconds = time.perf_counter() - t0
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "step_s": seconds}
    finally:
        if created:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    from ..cluster import get_preset, list_presets
    from ..configs import get_config
    from ..device import resolve_device
    from ..distributed.train_step import GradSyncStrategy

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", default=None, choices=list_presets(),
                    help="cluster preset to search against; default: "
                         "the legacy flat model")
    ap.add_argument("--streams", type=int, default=1,
                    help="search against the N-stream event engine; with "
                         "--cluster the comm kind and chunk count are "
                         "searched too")
    ap.add_argument("--steps", type=int, default=None,
                    help="bound the search's step count")
    ap.add_argument("--device", default="cuda",
                    help="where the enacted step runs (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- Search Phase ----
    print("search phase ...")
    if args.cluster:
        spec = get_preset(args.cluster)
        print(f"  pricing collectives on {spec.name} "
              f"({spec.n_devices} devices, {len(spec.levels)} link levels, "
              f"{args.streams} stream(s))")
    plan = search(ARCH, cluster=args.cluster, streams=args.streams,
                  max_steps=args.steps)
    d = plan.describe()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "disco_plan.json")
        loaded = save_and_load(plan, path)
        print(f"  {d['grad_tensors']} gradient tensors -> "
              f"{d['allreduce_buckets']} fused AllReduce buckets "
              f"(predicted {plan.predicted_iteration_time * 1e3:.3f} ms, "
              f"{plan.provenance['simulations']} simulations); saved and "
              f"loaded {path}")
    if args.cluster:
        print(f"  searched collective-algorithm mix: {d['bucket_algos']}")
        if args.streams > 1:
            print(f"  searched comm kinds: {d['bucket_comm']}  "
                  f"chunk counts: {d['bucket_chunks']}")

    # ---- Enactment Phase ----
    print("enactment phase ...")
    print(f"  plan round-trips bit-for-bit [{loaded.fingerprint()}]")
    cfg = get_config(ARCH).reduced()
    leaves = meta_leaves(cfg)
    strat = loaded.grad_sync(leaves)
    per_tensor = GradSyncStrategy.per_tensor(leaves)
    coll = {name: count_collectives(cfg, s)
            for name, s in (("per-tensor", per_tensor), ("DisCo", strat))}
    data, model = ({name: by_group(c, MESH[g]) for name, c in coll.items()}
                   for g in ("data", "model"))
    implied = implied_data_counts(strat, leaves)
    print(f"  one rank's ddp_tp step on a fake {tuple(MESH.values())} world, "
          f"batch {BATCH} x {SEQ}: data group per-tensor {data['per-tensor']}"
          f", DisCo {data['DisCo']} (the Plan implies {implied}); model "
          f"group {model['DisCo']} under both")
    n_pt = data["per-tensor"]["all-reduce"]
    n_disco = data["DisCo"].get("all-reduce", 0)
    print(f"  data-group all-reduce count: per-tensor={n_pt}, "
          f"DisCo={n_disco}")
    if n_disco > n_pt or data["DisCo"] != implied or \
            model["DisCo"] != model["per-tensor"]:
        raise RuntimeError(f"the step's collectives {data}, {model} are not "
                           f"what the Plan implies: {implied}")
    res = enact(cfg, strat, device)
    print(f"  one step of the loaded Plan on a one-rank (1, 1) mesh of "
          f"{device}: loss {res['loss']:.4f}, {res['step_s'] * 1e3:.1f} ms")
    if not math.isfinite(res["loss"]):
        raise RuntimeError(f"the enacted step's loss is {res['loss']}")
    print("the searched schedule is carried verbatim into the step's "
          "collectives")
    return {"plan": plan, "loaded": loaded, "strategy": strat,
            "collectives": coll, "implied": implied, "step": res}


if __name__ == "__main__":
    main()
