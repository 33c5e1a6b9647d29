"""The port's named phases in a cell's traced steps (not run by the
benchmark's own runs).

    python3 bench/phases.py --workload <name> --seed <n> [--seconds 10] \\
        [--steps 5] [--out file.jsonl]

Builds the cell's program as ``bench/run.py`` does (``perfkit.harness.
Cell``), runs its checked steps, a window of about ``--seconds`` untraced
steps, then ``--steps`` more steps under ``torch.profiler`` on rank 0 (the
harness's ``bench.traced`` and ``bench.step`` spans around them), every
step timed by CUDA events.  The trace is reduced twice: by
``perfkit.trace``, the view the cell's per-layer readers take, and by
``perfkit.spans``, each device op with the port's step phase and model
region.  Prints one JSON line: the readings of both, the window's and the
traced steps' median step (what tracing costs), the device ms of each
phase against the busy time of a traced step, the heaviest kernels of
each model region, and the ten longest idle gaps with the host span or op
at each.  Needs the cell's CUDA devices."""
import argparse
import json
import math
import os
import statistics
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from perfkit import flops, harness, manifest, spans, trace  # noqa: E402


def _traced(cell, params, state, seed, first, steps):
    """``steps`` steps, under the profiler on rank 0; returns the steps'
    ms and, on rank 0, the exported trace's events."""
    torch = cell.torch
    from torch.profiler import ProfilerActivity, profile, record_function

    clock = harness._Clock(cell.device)

    def run():
        nonlocal params, state
        clock.mark()
        for i in range(steps):
            with record_function("bench.step"):
                params, state, _ = cell.one(
                    params, state, cell.batch(seed, first + i))
            clock.mark()
        torch.cuda.synchronize(cell.device)

    if cell.rank != 0:
        run()
        return clock.step_ms(), None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.traced"):
            run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return clock.step_ms(), json.load(f)
    finally:
        os.unlink(path)


def _top(ops, steps, n=6):
    """The ``n`` heaviest kernel names of ``ops``, ms a step."""
    ms = {}
    for o in ops:
        ms[o["name"][:80]] = ms.get(o["name"][:80], 0.0) + o["dur"] / 1e3 \
            / steps
    return sorted(ms.items(), key=lambda kv: -kv[1])[:n]


def _gap_hosts(view, top=3, n=12):
    """For each of the ``top`` longest idle gaps, the step thread's host
    events over it: (name, start from the gap's start, duration), in ms."""
    out = []
    for a, g in trace.idle_gaps(view)[:top]:
        over = [h for h in view["host"]
                if h["ts"] < a + g and h["ts"] + h["dur"] > a]
        over = sorted(over, key=lambda h: -h["dur"])[:n]
        out.append({"gap_ms": g / 1e3, "host": [
            (h["name"][:60], (h["ts"] - a) / 1e3, h["dur"] / 1e3)
            for h in sorted(over, key=lambda h: h["ts"])]})
    return out


def _by(view, key, steps):
    out = {}
    for o in view["ops"]:
        out[o[key]] = out.get(o[key], 0.0) + o["dur"] / 1e3 / steps
    return {str(k): v for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def phases(cell, seed: int, seconds: float, steps: int) -> dict:
    torch, dist, TS = cell.torch, cell.dist, cell.TS
    params, state, _, host_s = cell.checked(seed)
    est = min(host_s[1:] or host_s)
    n = torch.tensor([max(2, math.ceil(seconds / max(est, 1e-3)))],
                     device=cell.device)
    dist.broadcast(n, 0)
    n = int(n)
    first = cell.mix["check_steps"]
    TS.reset_collectives()
    torch.cuda.synchronize(cell.device)
    dist.barrier()
    clock = harness._Clock(cell.device)
    clock.mark()
    for i in range(n):
        params, state, _ = cell.one(params, state,
                                    cell.batch(seed, first + i))
        clock.mark()
    torch.cuda.synchronize(cell.device)
    window_ms = clock.step_ms()
    counted = getattr(TS, "COLLECTIVE_BYTES", None)
    coll = {k: v / n for k, v in counted.items()} if counted else None
    traced_ms, raw = _traced(cell, params, state, seed, first + n, steps)
    if raw is None:
        return None
    view, sview = trace.reduce_trace(raw), spans.reduce_trace(raw)
    del raw
    k = view["steps"]
    ctx = {"view": view, "window_s": sum(window_ms) / 1e3, "steps": n,
           "step_ms": window_ms, "chips": cell.world,
           "flops_per_step": flops.train_flops_per_token(cell.conf, cell.S)
           * cell.rows * cell.S,
           "plan_predicted_s": cell.plan.predicted_iteration_time,
           "staging": cell.staging}
    bench = {e["name"]: manifest.metric_reader(e["name"])(ctx)
             for e in manifest.manifest()["per_layer"]}
    price = cell.plan.price()
    mine = spans.readings(sview, collective_bytes=coll,
                          plan_comm_s=price["serialized_comm_s"],
                          chips=cell.world)
    busy = trace.busy_us(view) / 1e3 / k
    by_phase = _by(sview, "phase", k)
    fwd_bwd = (mine["fwd_ms"] or 0) + (mine["bwd_ms"] or 0)
    fb_ops = [o for o in sview["ops"]
              if o["phase"] in ("step.fwd", "step.bwd")]
    regions = {str(r): _top([o for o in fb_ops if o["region"] == r], k)
               for r in spans.REGIONS + (None,)}
    phase_top = {str(p): _top([o for o in sview["ops"] if o["phase"] == p],
                              k) for p in spans.PHASES + (None,)}
    w_med, t_med = (statistics.median(window_ms),
                    statistics.median(traced_ms))
    region_sum = sum(mine[x] or 0 for x in ("attn_ms", "ffn_ms", "io_ms"))
    phased = sum(v for p, v in by_phase.items() if p != "None")
    return {
        "chips": cell.world,
        "window_steps": n, "traced_steps": k,
        "window_step_ms_median": w_med, "traced_step_ms_median": t_med,
        "traced_step_ms": traced_ms,
        "tracing_cost_pct": 100.0 * (t_med - w_med) / w_med,
        "tokens_per_s_window": n * cell.rows * cell.S
        / (sum(window_ms) / 1e3),
        "readings": mine, "bench_readers": bench,
        "busy_ms_per_step": busy, "phase_ms": by_phase,
        "phased_over_busy": phased / busy if busy else None,
        "region_ms": _by({"ops": fb_ops}, "region", k),
        "regions_over_fwd_bwd": region_sum / fwd_bwd if fwd_bwd else None,
        "region_top_kernels": regions,
        "phase_top_kernels": phase_top,
        "bucket_nccl_ms_by_step": [
            sum(o["dur"] for o in sview["ops"] if o["nccl"]
                and o["phase"] == "sync.bucket" and o["step"] == i) / 1e3
            for i in range(k)],
        "collective_bytes_per_step": coll, "plan_price": {
            x: price[x] for x in ("serialized_comm_s", "engine_finish_s",
                                  "total_grad_bytes", "buckets")},
        "idle_gaps": trace.breakdown(view)["idle_gaps"],
        "gap_hosts": _gap_hosts(view),
        "checks": {
            "regions_within_1pct": (abs(region_sum - fwd_bwd)
                                    <= 0.01 * fwd_bwd),
            "phases_within_2pct_of_busy": abs(phased - busy) <= 0.02 * busy,
            "update_over_optim": ((mine["update_ms"] or 0)
                                  > (bench.get("optim_ms") or 0)),
            "grad_sync_exposed_le_sync_exposed": (
                (mine["grad_sync_exposed_ms"] or 0)
                <= (bench.get("sync_exposed_ms") or 0) + 1e-9)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    harness.cache_env()
    w = manifest.cell(args.workload)
    import torch

    chips = w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA devices", file=sys.stderr)
        return 3
    rank, kids = args.rank or 0, []
    if chips > 1 and args.rank is None:
        kids = harness._start_ranks(sys.argv[1:] if argv is None else argv,
                                    chips, script=__file__)
        harness._watch(kids)
    elif args.rank is not None:
        harness._orphan_guard()
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    cell = harness.Cell(w, rank=rank, world=chips, device=device)
    try:
        rec = phases(cell, args.seed, args.seconds,
                     args.steps or w["mix"]["trace_steps"])
    finally:
        cell.close()
        for k in kids:
            k.wait()
    if rank == 0:
        rec = dict(rec, workload=args.workload, seed=args.seed,
                   device=torch.cuda.get_device_name(device))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
