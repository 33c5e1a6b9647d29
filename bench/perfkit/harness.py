"""One run of one training cell of the PyTorch port (``repro_torch``).

Set-up (counted in ``setup_s``, from the process's start): the port's
process group (NCCL, one process a card; on four cards rank 0 starts the
other three), the weights drawn on the card from the seed, the Plan (the
step traced on meta tensors, then searched, or replayed from the port's
``PlanCache`` under ``bench/.cache/plans``), ``build_train_step`` with the
Plan's buckets and the harness's AdamW, and the first ``check_steps`` steps
of the run, which warm up every shape and whose losses, first moments and
weight changes are kept for the comparison.  The same step object then
runs the window: back-to-back steps on fresh batches drawn on the card,
timed by CUDA events, no host sync until the end.  With ``--trace 1`` the
window is followed by ``trace_steps`` more steps under ``torch.profiler``
on rank 0.  Then the program's state is freed and the plain reference
follows the checked steps from the same seed, in f32."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

from . import compare, flops, hw, manifest, reference, trace, traffic, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = manifest.BENCH / ".cache"
FAULTS = ("unchanged", "half_batch", "no_exchange", "loss_altered")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def cache_env() -> None:
    """Every compile cache of the program at a fixed place in the
    checkout."""
    cache = CACHE
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# ---------------------------------------------------------- the program
def port_config(conf: dict):
    """The port's ModelConfig for a configuration file: the registry
    entry it names, with the file's depth, widths and dtype."""
    from repro_torch.configs import get_config

    base = get_config(conf["registry"])
    kw = dict(n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
              n_heads=conf["num_attention_heads"],
              n_kv_heads=conf["num_key_value_heads"],
              d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
              dtype=conf["dtype"], head_dim=0)
    if base.mla is not None:
        kw["mla"] = dataclasses.replace(
            base.mla, kv_lora_rank=conf["kv_lora_rank"],
            q_lora_rank=conf["q_lora_rank"],
            qk_nope_head_dim=conf["qk_nope_head_dim"],
            qk_rope_head_dim=conf["qk_rope_head_dim"],
            v_head_dim=conf["v_head_dim"])
    if base.moe is not None:
        kw["moe"] = dataclasses.replace(
            base.moe, n_routed=conf["n_routed_experts"],
            n_shared=conf["n_shared_experts"],
            top_k=conf["num_experts_per_tok"],
            d_expert=conf["moe_intermediate_size"],
            first_dense_layers=conf["first_k_dense_replace"],
            capacity_factor=conf["deviations"]["capacity_factor"]["port"])
    if base.hd != base.d_model // base.n_heads:
        raise ValueError(f"{base.name}: a head width apart from d_model / "
                         f"heads is not read from the file")
    return dataclasses.replace(base, **kw)


def registry_mismatch(conf: dict) -> list:
    """Fields in which the file's model differs from the port's registry
    entry, other than the depth: [] for a file that runs the registry's
    widths."""
    from repro_torch.configs import get_config

    base = get_config(conf["registry"])
    mine = port_config(conf)
    return [f.name for f in dataclasses.fields(base)
            if f.name not in ("n_layers", "name")
            and getattr(base, f.name) != getattr(mine, f.name)]


def bench_cluster(world: int):
    from repro_torch.cluster import ClusterSpec, LinkLevel

    return ClusterSpec(f"bench_h100_nvlink4_x{world}",
                       (LinkLevel("nvlink4", world, hw.NVLINK_BYTES_S,
                                  hw.NVLINK_ALPHA_S),))


def get_plan(cfg, batch: int, seq: int, world: int, rank: int, dist):
    """The cell's Plan: the step traced at one rank's batch, searched for
    ``world`` H100s on NVLink, through the port's PlanCache (rank 0 first;
    the others then hit its entry).  No warm start: a Plan never depends
    on which cells ran before in this checkout."""
    from repro_torch import plan as RP

    def make():
        g = RP.trace_model_graph(cfg, batch=batch, seq=seq, reduced=False)
        return RP.compile(graph=g, cluster=bench_cluster(world),
                          n_devices=world, unchanged_limit=80, seed=0,
                          cache=str(CACHE / "plans"),
                          warm_start=False)

    if world == 1:
        return make()
    plan = make() if rank == 0 else None
    dist.barrier()
    return plan if rank == 0 else make()


class _Clock:
    """Step boundaries: CUDA events on the card, the host clock on the
    CPU (tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        import torch

        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class Cell:
    """A cell's program on this rank: the process group, the port's
    config, the Plan and the step object, built once; then, per seed,
    the checked steps and the reference's."""

    def __init__(self, w: dict, *, rank: int, world: int, device,
                 check_registry: bool = True):
        import torch
        import torch.distributed as dist
        from torch.profiler import record_function

        from repro_torch import tree as T
        from repro_torch.distributed import train_step as TS
        from repro_torch.launch import train as TRAIN
        from repro_torch.models import stacked as ST
        from repro_torch.optim import adamw

        self.torch, self.dist, self.T, self.TS = torch, dist, T, TS
        _SYNC.setdefault("sync_grads", TS.sync_grads)
        self.rank, self.world, self.device = rank, world, device
        self.conf, self.mix, self.sizing = w["conf"], w["mix"], w["sizing"]
        self.B, self.S = self.sizing["batch_per_chip"], self.mix["seq_len"]
        self.rows = self.B * world
        self.o = o = self.mix["optimizer"]
        off = registry_mismatch(self.conf) if check_registry else []
        if off:
            raise ValueError(f"{self.conf['registry']}: the file's widths "
                             f"differ from the port's registry in {off}")
        self.cfg = cfg = port_config(self.conf)
        self.created = TRAIN.init_process_group(device)
        self.log = (lambda *a: print(*a, file=sys.stderr, flush=True)) \
            if rank == 0 else (lambda *a: None)
        with torch.device("meta"):
            self.tpl = ST.init_params(cfg, device="meta")
        self.spec = [(p, tuple(t.shape), t.dtype)
                     for p, t in T.leaves_with_paths(self.tpl)]
        t0 = time.time()
        self.plan = get_plan(cfg, self.B, self.S, world, rank, dist)
        meta = T.leaves(self.tpl)
        self.strat = self.plan.grad_sync(meta)
        self.log(f"plan: {time.time() - t0:.1f} s, cache "
                 f"{self.plan.provenance.get('cache', {}).get('outcome')}, "
                 f"{len(self.strat.buckets)} buckets, predicted "
                 f"{self.plan.predicted_iteration_time * 1e3:.1f} ms")
        nb = len(self.strat.buckets)
        self.staging = flops.staging_launches(
            self.strat.buckets, [self.strat.comm_kind(i) for i in range(nb)],
            [self.strat.chunk_count(i) for i in range(nb)],
            [self.strat.is_fused(i) for i in range(nb)],
            [p.numel() for p in meta],
            [str(p.dtype).replace("torch.", "") for p in meta], world)
        self.opt_init, opt_update = adamw(
            o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"])

        def update(*a):
            with record_function("bench.optimizer"):
                return opt_update(*a)

        self.step = TS.build_train_step(
            cfg, mode="ddp_tp", layout="dp", strategy=self.strat,
            optimizer=(self.opt_init, update), remat=self.mix["remat"],
            clip_norm=o["clip_norm"], lr=o["lr"])

    def close(self) -> None:
        self.TS.sync_grads = _SYNC["sync_grads"]
        if self.created:
            self.dist.destroy_process_group()

    def draw(self, seed: int, i: int):
        p, s, dt = self.spec[i]
        return weights.draw_leaf(p, s, dt, seed, i, self.device)

    def batch(self, seed: int, step: int, faults=()) -> dict:
        tok = traffic.batch_tokens(self.mix, self.cfg.vocab, self.rows, seed,
                                   step, self.device)
        if "half_batch" in faults:
            tok = tok.view(self.world, self.B, self.S)[:, :self.B // 2]
            tok = tok.reshape(-1, self.S)
        return {"tokens": tok}

    def one(self, params, state, b, faults=()):
        """One call of the step as the window makes it, or with a fault
        planted (the faults serve the tests and ``bench/readings.py``)."""
        self.TS.sync_grads = (_no_exchange if "no_exchange" in faults
                              else _SYNC["sync_grads"])
        if "unchanged" in faults:
            loss, _ = self.step.loss_and_grads(params, b)
            self.dist.all_reduce(loss)
            for p in self.T.leaves(params):
                p.grad = None
            return params, state, {"loss": loss / self.world}
        params, state, m = self.step(params, state, b)
        if "loss_altered" in faults:
            m = dict(m, loss=m["loss"] * 1.01)
        return params, state, m

    def checked(self, seed: int, faults=()):
        """Fresh weights from ``seed`` and the first ``check_steps`` steps
        through the window's own call and feed.  Returns (params, state,
        readings, host seconds a step)."""
        torch, T = self.torch, self.T
        leaves = [self.draw(seed, i) for i in range(len(self.spec))]
        params = T.unflatten(self.tpl, leaves)
        state = self.opt_init(leaves)
        losses, host_s, g1 = [], [], None
        for s in range(self.mix["check_steps"]):
            h0 = time.perf_counter()
            params, state, m = self.one(params, state,
                                        self.batch(seed, s, faults), faults)
            losses.append(float(m["loss"]))
            host_s.append(time.perf_counter() - h0)
            if s == 0:
                g1 = [float(torch.linalg.vector_norm(mu)) / (1 - self.o["b1"])
                      for mu in state.mu]
        with torch.no_grad():
            leaves = T.leaves(params)
            change = [float(torch.linalg.vector_norm(
                p.float() - self.draw(seed, i).float()))
                for i, p in enumerate(leaves)]
            spread = None
            if self.world > 1:
                mine = torch.tensor(
                    [[float(p.float().sum()),
                      float(torch.linalg.vector_norm(p.float()))]
                     for p in leaves], device=self.device)
                every = [torch.empty_like(mine) for _ in range(self.world)]
                self.dist.all_gather(every, mine)
                spread = max(float((e - every[0]).abs().max())
                             for e in every)
        prog = {"losses": losses, "grad_norms": g1, "change_norms": change,
                "rank_spread": spread}
        return params, state, prog, host_s

    def reference(self, seed: int, prec: str = "f32") -> dict:
        """The plain reference over the checked steps from ``seed``."""
        torch = self.torch
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist = self.dist
        return reference.train(
            reference.spec_of(self.conf), self.spec,
            lambda i: self.draw(seed, i),
            lambda s: self.batch(seed, s)["tokens"],
            self.mix["check_steps"], self.o, rank=self.rank,
            world=self.world, rows=self.B, prec=prec,
            all_reduce=(lambda t: dist.all_reduce(t)) if self.world > 1
            else None)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def run(w: dict, seed: int, seconds: float, trace_on: bool, *, rank: int,
        world: int, device, t_start: float, faults=(),
        check_registry: bool = True) -> dict:
    """One rank's run.  Returns rank 0's result (metrics, device, checks);
    other ranks return None."""
    from repro_torch.kernels import ops as K

    cell = Cell(w, rank=rank, world=world, device=device,
                check_registry=check_registry)
    torch, dist, TS = cell.torch, cell.dist, cell.TS
    try:
        params, state, prog, host_s = cell.checked(seed, faults)
        cell.log(f"checked steps: losses {prog['losses']}, host s {host_s}")
        # the window: a number of steps fixed from the checked steps' pace
        # (the fastest after the first: the second can still warm up)
        est = min(host_s[1:] or host_s)
        n = torch.tensor([max(2, math.ceil(seconds / max(est, 1e-3)))],
                         device=device)
        dist.broadcast(n, 0)
        n = int(n)
        K.reset_launches()
        TS.reset_collectives()
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        setup_s = time.time() - t_start
        clock = _Clock(device)
        first = cell.mix["check_steps"]
        window_losses = []
        w0 = time.perf_counter()
        clock.mark()
        for i in range(n):
            params, state, m = cell.one(params, state,
                                        cell.batch(seed, first + i, faults),
                                        faults)
            window_losses.append(m["loss"])
            clock.mark()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        step_ms = clock.step_ms()
        peak = torch.tensor([float(torch.cuda.max_memory_allocated(device))
                             if cuda else 0.0], device=device)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        failed = sum(not math.isfinite(float(x)) for x in window_losses)
        launches = {k: getattr(K, k).launches for k in
                    ("bucket_pack", "fused_pack", "fused_unpack",
                     "convert_copy")}
        cell.log(f"window: {n} steps in {window_s:.3f} s; launches "
                 f"{launches}; collectives {dict(TS.COLLECTIVES)}")
        view = None
        if trace_on:
            view = _traced_steps(
                lambda p, s, i: cell.one(p, s, cell.batch(seed, i, faults),
                                         faults),
                params, state, first + n, cell.mix["trace_steps"], rank,
                device)
        del params, state, m, window_losses
        cell.free()
        r0 = time.time()
        ref = cell.reference(seed)
        ref_s = time.time() - r0
        if rank != 0:
            return None
        ok, checks = compare.judge(compare.numbers(prog, ref),
                                   cell.sizing["limits"])
        cell.log(f"reference: {ref_s:.1f} s, losses {ref['losses']}")
        rows, S = cell.rows, cell.S
        ctx = {"view": view, "window_s": window_s, "steps": n,
               "step_ms": step_ms, "chips": world,
               "flops_per_step": flops.train_flops_per_token(cell.conf, S)
               * rows * S,
               "plan_predicted_s": cell.plan.predicted_iteration_time,
               "staging": cell.staging}
        out = {"correct": ok, "attempted": n, "failed": failed,
               "setup_s": setup_s, "window_s": window_s,
               "tokens_per_s": n * rows * S / window_s,
               "peak_mem_gib": float(peak) / 2**30, "ctx": ctx,
               "checks": checks, "reference_s": ref_s}
        if view is not None:
            out["busy_s"] = trace.busy_us(view) / 1e6
            out["trace_window_s"] = (view["window"][1] - view["window"][0]) \
                / 1e6
            out["breakdown"] = trace.breakdown(view)
        return out
    finally:
        cell.close()


_SYNC: dict = {}


def _no_exchange(grads, strategy, group=None):
    """The fault "the exchange between chips left out": each rank keeps
    its own gradients."""
    return list(grads)


def _traced_steps(one, params, state, first, steps, rank, device):
    """``steps`` more steps, under the profiler on rank 0; its trace
    reduced to ``perfkit.trace``'s view (None on other ranks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if rank != 0:
        for i in range(steps):
            params, state, _ = one(params, state, first + i)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return None
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            for i in range(steps):
                with record_function("bench.step"):
                    params, state, _ = one(params, state, first + i)
            if device.type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.load(path)
    finally:
        os.unlink(path)


# ------------------------------------------------------------- the run
def result_line(w: dict, out: dict, trace_on: bool, device_name: str,
                read=manifest.metric_reader) -> dict:
    metrics = {}
    if trace_on:
        for e in w["per_layer"]:
            v = read(e["name"])(out["ctx"])
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        for e in w["end_to_end"]:
            metrics[e["name"]] = {"value": out[e["name"]], "unit": e["unit"]}
    dev = {"platform": "gpu", "kind": device_name, "count": w["chips"],
           "memory_peak_bytes": int(out["peak_mem_gib"] * 2**30)}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["trace_window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(argv, world: int, script=None) -> list:
    """Rank 0 is this process; ranks 1.. are children on the other cards,
    running ``script`` (``bench/run.py``) with ``argv``, their output on
    this process's standard error."""
    port = _free_port()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
    script = str(script or manifest.BENCH / "run.py")
    kids = []
    for r in range(1, world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
        kids.append(subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(r)], env=env,
            stdout=sys.stderr, stderr=sys.stderr))
    return kids


def _watch(kids) -> None:
    """End the run if a rank fails, rather than wait in a collective."""
    def loop():
        while True:
            for k in kids:
                rc = k.poll()
                if rc not in (None, 0):
                    print(f"rank process {k.pid} exited with {rc}",
                          file=sys.stderr, flush=True)
                    for j in kids:
                        if j.poll() is None:
                            j.kill()
                    os._exit(1)
            time.sleep(0.5)
    threading.Thread(target=loop, daemon=True).start()


def _orphan_guard() -> None:
    parent = os.getppid()

    def loop():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(1.0)
    threading.Thread(target=loop, daemon=True).start()


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cache_env()
    w = manifest.cell(args.workload)
    chips = w["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    rank = args.rank or 0
    kids = []
    if chips > 1 and args.rank is None:
        kids = _start_ranks(argv, chips)
        _watch(kids)
    elif args.rank is not None:
        _orphan_guard()
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    try:
        out = run(w, args.seed, args.seconds, bool(args.trace), rank=rank,
                  world=chips, device=device, t_start=t_start)
    finally:
        for k in kids:
            try:
                k.wait(timeout=120)
            except subprocess.TimeoutExpired:
                k.kill()
                k.wait()
    if rank != 0:
        return 0
    if any(k.returncode for k in kids):
        print("a rank process failed", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 2
    line = result_line(w, out, bool(args.trace),
                       torch.cuda.get_device_name(device))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
