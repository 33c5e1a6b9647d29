"""Compile -> save -> load -> enact -> replay: the serving-plan workflow
(port of ``examples/serve_with_plan.py``; DESIGN.md Sec. 15).

    python -m repro_torch.examples.serve_with_plan               # on the GPU
    python -m repro_torch.examples.serve_with_plan --device cpu --steps 20

Search Phase: :func:`repro_torch.serving.plan.compile_serving` prices one
decode window in the event engine (per-token TP collectives as
dep-coupled jobs, prefill admissions from a seeded request trace as a
competing traffic class) and searches the serving knobs (slots, decode
batch, KV-shard layout, collective algorithm, streams).  The result is a
frozen, schema-versioned :class:`ServingPlan`.

Enactment Phase: ``ServingPlan.load()`` round-trips the artifact
(asserted bit-for-bit) and ``ServeEngine(plan=...)`` enacts the searched
slot and batch choices on a reduced model; ``replay`` drives the engine
through a seeded trace on a virtual clock and prints the per-request
metrics.  The engine's slots and batch are clamped to a small host, so
the example stays quick; the plan's own geometry is for the priced
cluster.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> dict:
    from ..cluster import list_presets

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", default="h100_superpod",
                    choices=list_presets())
    ap.add_argument("--steps", type=int, default=None,
                    help="bound the search's step count")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: cuda)")
    args = ap.parse_args(argv)

    from ..serving.plan import ServingPlan, compile_serving
    from ..serving.workload import VirtualClock, Workload, replay

    # ---- Search Phase ----
    print("search phase ...")
    workload = Workload(n_requests=48, rate=32.0, concurrency=32, seed=0)
    plan = compile_serving("tinyllama-1.1b", cluster=args.cluster,
                           workload=workload, unchanged_limit=40,
                           max_steps=args.steps, seed=0)
    d = plan.describe()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_plan.json")
        plan.save(path)
        print(f"  searched serving knobs on {args.cluster}: "
              f"slots={d['slots']} batch={d['decode_batch']} "
              f"kv={d['kv_layout']} algo={d['algo']} "
              f"streams={d['streams']} (predicted "
              f"{plan.predicted_tokens_per_s:.0f} tok/s, ttft p99 "
              f"{plan.predicted_ttft_p99_s * 1e3:.3f} ms, "
              f"{plan.provenance['simulations']} simulations)")

        # ---- Enactment Phase ----
        print("enactment phase ...")
        loaded = ServingPlan.load(path)
    if loaded != plan or loaded.fingerprint() != plan.fingerprint():
        raise RuntimeError("serving plan save/load round trip drifted")
    print(f"  plan round-trips bit-for-bit [{loaded.fingerprint()}]")

    from ..configs import get_config
    from ..models import stacked as ST
    from ..serving.engine import ServeEngine

    cfg = get_config("tinyllama-1.1b").reduced()
    params = ST.init_params(cfg, seed=0, device=args.device)
    # the searched decode batch and KV layout carry over; the slot count
    # is clamped to this host
    slots = min(loaded.slots, 4)
    engine = ServeEngine(params, cfg, plan=loaded, max_slots=slots,
                         cache_len=64,
                         decode_batch=min(loaded.decode_batch, 2),
                         clock=VirtualClock())
    trace = Workload(n_requests=6, rate=64.0, concurrency=slots,
                     prompt_lens=(3, 8), new_tokens=(3, 6), seed=1)
    m = replay(engine, trace, step_time=1e-3)
    print(f"  replayed {m['completed']} requests / {m['tokens']} tokens in "
          f"{m['decode_steps']} decode steps on the virtual clock: "
          f"{m['tokens_per_s']:.0f} tok/s, "
          f"ttft p50 {m['ttft_p50_s'] * 1e3:.1f} ms, "
          f"latency p99 {m['latency_p99_s'] * 1e3:.1f} ms; kv layout "
          f"{engine.kv_layout}")
    if m["completed"] != trace.n_requests:
        raise RuntimeError("replay dropped requests")
    print("the searched serving plan is enacted by the engine")
    return {"plan": plan, "metrics": m, "engine": engine}


if __name__ == "__main__":
    main()
