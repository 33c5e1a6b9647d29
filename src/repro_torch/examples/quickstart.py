"""Quickstart: DisCo in five steps on the per-layer model (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart               # on the GPU
    python -m repro_torch.examples.quickstart --device cpu

1. build a reduced TinyLlama (6 layers) and train it a few SGD steps on
   the device,
2. trace its training step into the fusion IR (``model="layers"``: every
   layer's ops and one gradient per leaf),
3. cost the paper's baselines with the simulator (priced for an H100),
4. run the joint op/tensor-fusion backtracking search,
5. print the strategy and the simulated speed-up.
"""
from __future__ import annotations

import argparse
import dataclasses
import math


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the SGD steps run (default: cuda)")
    ap.add_argument("--layers", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config
    from ..core import Simulator, backtracking_search, evaluate_baselines
    from ..data.pipeline import materialize_batch
    from ..models import model as M
    from ..optim import apply_updates, sgd
    from ..plan import trace_model_graph
    from .. import tree as T

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=args.layers)
    params = M.init_params(cfg, seed=0, device=args.device)
    batch = materialize_batch(cfg, batch=8, seq=64, device=args.device)
    leaves = T.leaves(params)
    print(f"1/5 {cfg.name} at {cfg.n_layers} layers, {len(leaves)} leaves, "
          f"on {args.device}: SGD steps")
    init, update = sgd(0.5, momentum=0.9)
    state = init(leaves)
    losses = []
    for _ in range(3):
        for p in leaves:
            p.requires_grad_(True)
        loss = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        updates, state = update(list(grads), state, leaves)
        apply_updates(leaves, updates)
        losses.append(float(loss.detach()))
    print(f"    losses {[round(l, 4) for l in losses]}")
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"non-finite loss: {losses}")

    print("2/5 tracing the training step into the fusion IR ...")
    g = trace_model_graph(cfg, batch=8, seq=64, model="layers",
                          reduced=False)
    print(f"    {g.describe()}")

    sim = Simulator(n_devices=256)
    print("3/5 baseline strategies (simulated per-iteration time):")
    base = evaluate_baselines(g, sim)
    for name, t in sorted(base.items(), key=lambda kv: kv[1]):
        print(f"    {name:22s} {t * 1e6:9.1f} us")

    print("4/5 joint op/tensor-fusion backtracking search (Alg. 1) ...")
    res = backtracking_search(g, sim, alpha=1.05, beta=10,
                              unchanged_limit=150, seed=0)
    print(f"    {res.simulations} simulations in {res.wall_time:.1f}s")

    print("5/5 best strategy found:")
    print(f"    {res.best.describe()}")
    r = sim.run(res.best)
    print(f"    compute {r.compute_time * 1e6:.1f} us, comm "
          f"{r.comm_time * 1e6:.1f} us, overlap ratio {r.overlap_ratio:.2f}")
    best_base = min(v for k, v in base.items() if k != "FO")
    print(f"    DisCo {res.best_cost * 1e6:.1f} us vs best baseline "
          f"{best_base * 1e6:.1f} us "
          f"(+{(best_base - res.best_cost) / res.best_cost * 100:.1f}%), "
          f"FO bound {base['FO'] * 1e6:.1f} us")
    return {"losses": losses, "graph": g, "baselines": base,
            "best_cost": res.best_cost}


if __name__ == "__main__":
    main()
