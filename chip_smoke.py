#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which stops the run with a nonzero exit on failure:

(a) card and build: the card's name and power limit from ``nvidia-smi``;
    the CUDA kernels built from ``src/repro_torch/kernels/csrc``.
(b) kernels against their plain PyTorch versions, bitwise, at the main
    path's shapes (every tinyllama-1.1b leaf in bf16, 25 MiB buckets, 2
    chunks) and at a padding case (dp=8, odd leaf sizes); each kernel timed
    with CUDA events (median of 20 runs after warm-up) beside its plain
    version, one PyTorch call where there is one, and its HBM bound.
(c) training: reduced tinyllama on the card against the same run on the
    CPU; then the main path — ``repro_torch.launch.train.main`` on full
    tinyllama-1.1b (22 layers, d_model 2048, bf16 weights, f32 AdamW
    moments), batch 4 x seq 2048, in a one-rank NCCL group, with every
    bucket fused into 2 chunks.  Launch and collective counters are zeroed
    just before and read just after, and must show every kernel ran.
(d) a trace: device time by kernel over 3 more steps of the main path,
    from ``torch.profiler`` (printed only; it changes no result).
(e) a JSON line of every kernel's numbers, then the device line last.

Exits nonzero, printing no result, without a CUDA device.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.kernels import build, ops as K, ref as R  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
ARCH, BATCH, SEQ, STEPS, CHUNKS = "tinyllama-1.1b", 4, 2048, 4, 2
SOURCE = "src/repro_torch/kernels/csrc/grad_sync.cu"
REPLACES = {"convert_copy": "src/repro/kernels/bucket_pack.py:20",
            "fused_pack": "src/repro/kernels/fused_grad_sync.py:40",
            "fused_unpack": "src/repro/kernels/fused_grad_sync.py:66"}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call.
    A spin kernel queued first keeps the card busy while the host enqueues
    the call, so the time is the call's device time, as in a step where the
    host runs ahead of the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({4: torch.int32, 2: torch.int16}[
        t.element_size()])


def check_equal(what: str, got: list, want: list) -> float:
    """Bitwise equality of two tensor lists; returns the max abs error."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tensors != {len(want)}")
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, float((g.float() - w.float()).abs().max())
                  if g.numel() else 0.0)
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what}: not bitwise equal "
                                 f"(max abs err {err})")
    return err


def meta_params(cfg):
    """The parameter tree of ``cfg`` as meta tensors: shapes and dtypes
    only, nothing drawn or allocated."""
    with torch.device("meta"):
        return ST.init_params(cfg, device="meta")


def phase_card_and_build() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, secs, log = build.build()
    print(f"build: {path.name} " + (f"compiled in {secs:.1f} s" if log
                                     else "already built"))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    build.load_library()


def phase_kernels(dev, strat, leaves) -> dict:
    """Each kernel bitwise against its plain version, and timed, on random
    gradients shaped like the main path's ``leaves``."""
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    print(f"main-path shapes: {len(grads)} leaves, "
          f"{sum(g.numel() for g in grads) / 1e6:.1f}M elements, "
          f"{len(strat.buckets)} buckets of <= 25 MiB, {CHUNKS} chunks")
    res = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "max_abs_err": 0.0,
               "library_ms": None} for k in REPLACES}

    # convert-copy: the optimizer's f32 upcast of every bf16 gradient
    res["convert_copy"]["library_ms"] = 0.0
    for g in grads:
        if g.dtype == torch.float32:
            continue
        r = res["convert_copy"]
        r["max_abs_err"] = max(r["max_abs_err"], check_equal(
            "convert_copy", [K.convert_copy(g, torch.float32)],
            [R.convert_copy_ref(g, torch.float32)]))
        r["ms"] += time_ms(lambda: K.convert_copy(g, torch.float32))
        r["plain_ms"] += time_ms(lambda: R.convert_copy_ref(g, torch.float32))
        r["library_ms"] += time_ms(lambda: g.to(torch.float32))
        r["bytes"] += g.numel() * (g.element_size() + 4)
    noise = torch.randn(1 << 20, generator=gen, device=dev).mul_(1.0001)
    check_equal("convert_copy f32->bf16",
                [K.convert_copy(noise, torch.bfloat16)],
                [R.convert_copy_ref(noise, torch.bfloat16)])

    # fused pack and unpack, one bucket at a time as sync_grads runs them
    for bucket in strat.buckets:
        leaves = [grads[i] for i in bucket]
        total = sum(l.numel() for l in leaves)
        k = min(CHUNKS, total)
        shapes = [l.shape for l in leaves]
        dtypes = [l.dtype for l in leaves]
        parts = K.fused_pack(leaves, total, 1, k)
        r = res["fused_pack"]
        r["max_abs_err"] = max(r["max_abs_err"], check_equal(
            "fused_pack", parts, R.fused_pack_ref(leaves, total, 1, k)))
        r["ms"] += time_ms(lambda: K.fused_pack(leaves, total, 1, k))
        r["plain_ms"] += time_ms(
            lambda: R.fused_pack_ref(leaves, total, 1, k))
        r["bytes"] += (sum(l.numel() * l.element_size() for l in leaves)
                       + 4 * sum(p.numel() for p in parts))
        # unpack f32 noise, so the casts round
        for p in parts:
            p.normal_(generator=gen)
        out = [torch.empty_like(l) for l in leaves]
        cuts = R.chunk_cuts(total, k)
        flat = torch.cat([p[:cuts[c + 1] - cuts[c]]
                          for c, p in enumerate(parts)])
        r = res["fused_unpack"]
        r["max_abs_err"] = max(r["max_abs_err"], check_equal(
            "fused_unpack", K.fused_unpack(parts, shapes, dtypes, out=out),
            R.fused_unpack_ref(flat, shapes, dtypes)))
        r["ms"] += time_ms(lambda: K.fused_unpack(parts, shapes, dtypes,
                                                  out=out))
        r["plain_ms"] += time_ms(
            lambda: R.fused_unpack_ref(torch.cat(
                [p[:cuts[c + 1] - cuts[c]] for c, p in enumerate(parts)]),
                shapes, dtypes))
        r["bytes"] += 4 * total + sum(l.numel() * l.element_size()
                                      for l in leaves)
        del parts, out, flat

    # padding case: dp=8, odd sizes, mixed dtypes, a pad to `total`
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        sizes = [17, 1000003, 5, 65537, 3]
        leaves = [torch.randn(s, generator=gen, device=dev).to(dt)
                  for s in sizes]
        leaves[1] = leaves[1].float()
        for total, k in ((sum(sizes), 3), (sum(sizes) + 13, 4)):
            parts = K.fused_pack(leaves, total, 8, k)
            check_equal("fused_pack dp=8", parts,
                        R.fused_pack_ref(leaves, total, 8, k))
        parts = K.fused_pack(leaves, sum(sizes), 8, 3)
        for p in parts:
            p.normal_(generator=gen)
        cuts = R.chunk_cuts(sum(sizes), 3)
        flat = torch.cat([p[:cuts[c + 1] - cuts[c]]
                          for c, p in enumerate(parts)])
        shapes, dtypes = [l.shape for l in leaves], [l.dtype for l in leaves]
        check_equal("fused_unpack dp=8",
                    K.fused_unpack(parts, shapes, dtypes),
                    R.fused_unpack_ref(flat, shapes, dtypes))
        odd = leaves[0][1:]     # a 2-byte-offset view: the scalar path
        check_equal("convert_copy unaligned",
                    [K.convert_copy(odd, torch.float32)],
                    [R.convert_copy_ref(odd, torch.float32)])
    torch.cuda.synchronize()
    del grads
    for name, r in res.items():
        r["bound_ms"] = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"kernel {name}: bitwise equal to plain; per step at the "
              f"main path's shapes ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"library_ms={lib}")
    return res


def phase_training(dev, tmp: str, strat, leaves) -> tuple[dict, str]:
    # the port on the card against the port on the CPU, on a small input
    small = os.path.join(tmp, "small.json")
    cfg = get_config(ARCH).reduced()
    buckets = TS.GradSyncStrategy.size_capped(meta_params(cfg),
                                              1 << 16).buckets
    TS.GradSyncStrategy(buckets, comms=["ar"] * len(buckets),
                        chunks=[2] * len(buckets),
                        fused=[1] * len(buckets)).save(small)
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "64", "--strategy-file", small, "--log-every", "100"]
    gpu = TRAIN.main(argv + ["--device", "cuda"])["losses"]
    cpu = TRAIN.main(argv + ["--device", "cpu"])["losses"]
    # rtol 1e-3: f32 matmuls (TF32 off) summed in another order by cuBLAS
    # and the CPU BLAS, carried through 3 AdamW steps
    for g, c in zip(gpu, cpu):
        if not math.isclose(g, c, rel_tol=1e-3):
            raise AssertionError(f"reduced run: cuda {gpu} != cpu {cpu}")
    print(f"reduced tinyllama, 3 steps: cuda losses {gpu} match cpu {cpu}")

    # the main path: full tinyllama-1.1b, every bucket fused, 2 chunks
    plan = os.path.join(tmp, "plan.json")
    sizes = [p.numel() for p in leaves]
    n_upcast = sum(p.dtype != torch.float32 for p in leaves)
    nb = len(strat.buckets)
    chunks = sum(min(CHUNKS, sum(sizes[i] for i in b)) for b in strat.buckets)
    TS.GradSyncStrategy(strat.buckets, comms=["ar"] * nb,
                        chunks=[CHUNKS] * nb, fused=[1] * nb).save(plan)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    TS.reset_collectives()
    out = TRAIN.main(["--arch", ARCH, "--steps", str(STEPS), "--batch",
                      str(BATCH), "--seq", str(SEQ), "--strategy-file", plan,
                      "--log-every", "1", "--device", "cuda"])
    launches = {name: getattr(K, name).launches for name in REPLACES}
    coll = dict(TS.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()

    losses = out["losses"]
    if len(losses) != STEPS or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    # pack and unpack once per bucket per step; convert-copy once per bf16
    # gradient per step (the optimizer's f32 upcast)
    want = {"fused_pack": nb * STEPS, "fused_unpack": nb * STEPS,
            "convert_copy": n_upcast * STEPS}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"main path, want {n}")
    for kind in ("reduce_scatter", "all_gather"):
        if coll[kind] != chunks * STEPS:
            raise AssertionError(f"{kind}: {coll[kind]} calls, want "
                                 f"sum(chunks) x steps = {chunks * STEPS}")
    steady = out["step_seconds"][1:]
    step_s = statistics.median(steady)
    print(f"training {ARCH}: {STEPS} steps, batch {BATCH} x seq {SEQ}, "
          f"{nb} fused buckets x {CHUNKS} chunks; losses {losses}")
    print(f"step time {step_s * 1e3:.1f} ms (median of steps 2..{STEPS}; "
          f"first step {out['step_seconds'][0] * 1e3:.1f} ms), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"launches on the main path: {launches}; collectives: {coll}")
    return launches, plan


def phase_trace(plan: str, steps: int = 3) -> None:
    """Device time by kernel name over a fresh run of the main path (its
    set-up copies included), from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TRAIN.main(["--arch", ARCH, "--steps", str(steps), "--batch",
                    str(BATCH), "--seq", str(SEQ), "--strategy-file", plan,
                    "--log-every", "100", "--device", "cuda"])
    rows = sorted(((getattr(e, "self_device_time_total", 0), e.key)
                   for e in prof.key_averages()), reverse=True)
    rows = [(t, k) for t, k in rows if t > 0]
    total = sum(t for t, _ in rows)
    if not total:
        print("trace: the profiler recorded no device time")
        return
    print(f"trace: {total / 1e3 / steps:.1f} ms device time per step over "
          f"{steps} steps (set-up copies included); top kernels:")
    for t, k in rows[:15]:
        print(f"  {100 * t / total:5.1f}%  {t / 1e3 / steps:8.2f} ms/step  "
              f"{k[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    phase_card_and_build()
    # the main path's leaves (shapes and dtypes only) and 25 MiB buckets
    leaves = ST.leaves(meta_params(get_config(ARCH)))
    strat = TS.GradSyncStrategy.size_capped(leaves)
    res = phase_kernels(dev, strat, leaves)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches, plan = phase_training(dev, tmp, strat, leaves)
        phase_trace(plan)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
                "bound_ms": res[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": res[name]["library_ms"]}
               for name in REPLACES]
    print(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
