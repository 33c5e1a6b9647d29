#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which stops the run with a nonzero exit on failure:

(a) card and build: the card's name and power limit from ``nvidia-smi``;
    the CUDA kernels built from ``src/repro_torch/kernels/csrc`` (one nvcc
    per source, started together).
(b) gradient-sync kernels against their plain PyTorch versions, bitwise,
    at the training path's shapes (every tinyllama-1.1b leaf in bf16,
    25 MiB buckets, 2 chunks) and at a padding case (dp=8, odd leaf sizes);
    each kernel timed with CUDA events (median of 20 runs after warm-up)
    beside its plain version, one PyTorch call where there is one, and its
    HBM bound.
(c) flash attention against its plain version at the serving path's
    prefill shapes (q (1,S,32,64), k and v (1,S,4,64), bf16, causal, S in
    1, 129, 1000, 2048) and at off-path cases (f32, hd 128, a window of
    128, non-causal); at the path's shapes also against the plain version
    on f32 copies of the inputs, to about one bf16 ulp of the output;
    timed per launch beside its plain version,
    ``scaled_dot_product_attention`` and its bound.
(d) training: reduced tinyllama on the card against the same run on the
    CPU; then the training path — ``repro_torch.launch.train.main`` on full
    tinyllama-1.1b (22 layers, d_model 2048, bf16 weights, f32 AdamW
    moments), batch 4 x seq 2048, in a one-rank NCCL group, with every
    bucket fused into 2 chunks.  Launch and collective counters are zeroed
    just before and read just after, and must show every kernel ran.
(e) a trace: device time by kernel over 3 more steps of the training path,
    from ``torch.profiler`` (printed only; it changes no result).
(f) serving checks: reduced tinyllama served on the card against the same
    requests served on the CPU (equal greedy tokens); full tinyllama-1.1b
    ``prefill`` with the kernel against ``prefill`` without it at 129 and
    2048 tokens (largest logit and cache differences under stated
    tolerances), the 2048-token prefill timed, and a decode step traced.
(g) serving: the serving path — ``ServeEngine`` on full tinyllama-1.1b
    (bf16 weights and KV cache, 8 slots, cache 4096), 35 requests submitted
    at once (32 of ``Workload(n_requests=32, prompt_lens=(16, 2048),
    new_tokens=(32, 64))`` plus prompts of 1, 129 and 2048 tokens), decoded
    greedily to completion.  The launch counters are zeroed just before and
    read just after: flash attention runs once per layer per prefill.
(h) a JSON line of every kernel's numbers, then the device line last.

Exits nonzero, printing no result, without a CUDA device.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.kernels import build, ops as K, ref as R  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as ENG  # noqa: E402
from repro_torch.serving import workload as WL  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16/f16 tensor cores
F32_FLOP_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
ARCH, BATCH, SEQ, STEPS, CHUNKS = "tinyllama-1.1b", 4, 2048, 4, 2
SLOTS, CACHE_LEN = 8, 4096
FLASH_SEQS = (1, 129, 1000, 2048)
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"convert_copy": CSRC + "grad_sync.cu",
          "fused_pack": CSRC + "grad_sync.cu",
          "fused_unpack": CSRC + "grad_sync.cu",
          "flash_attention": CSRC + "flash_attention.cu"}
REPLACES = {"convert_copy": "src/repro/kernels/bucket_pack.py:20",
            "fused_pack": "src/repro/kernels/fused_grad_sync.py:40",
            "fused_unpack": "src/repro/kernels/fused_grad_sync.py:66",
            "flash_attention": "src/repro/kernels/flash_attention.py:82"}
SYNC_KERNELS = ("convert_copy", "fused_pack", "fused_unpack")
# Largest |logit| difference allowed between full tinyllama-1.1b prefill
# with the flash kernel and without it (dense attention), bf16 weights.
# Both bf16 paths lie about 0.065 from an f32 run (logits of magnitude up
# to 4, 22 layers of bf16 rounding), so they differ by up to about 0.14;
# a wrong mask or head mapping moves logits by their own scale.  See
# PERF.md, section 6 (the serving slice).
PREFILL_LOGIT_TOL = 0.25
# The same for every k/v cache entry (22 layers of bf16 k and v, the first
# layer's equal on both paths).  Both paths measured 0.08 (S=129) and 0.10
# (S=2048) apart, H100; a wrong mask moves later layers' k/v by their own
# scale.  See PERF.md, section 6.
PREFILL_CACHE_TOL = 0.25
# Flash attention in bf16 against the plain version on f32 copies of its
# inputs: one bf16 rounding of the output (relative 2**-9) and f32 sums.
FLASH_F32_RTOL, FLASH_F32_ATOL = 8e-3, 2e-3


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
               "library_ms": None} for k in SYNC_KERNELS}

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
        r["bound_by"] = "bytes"
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"kernel {name}: bitwise equal to plain; per step at the "
              f"main path's shapes ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"library_ms={lib}")
    return res


def flash_bound(B, S, T_, H, KV, hd, dtype, causal) -> tuple[float, str]:
    """The least time for one attention call on these inputs: the larger
    of its operations over the peak rate for the input dtype (2 FLOPs per
    multiply-add, QK and PV, over the (query, key) pairs the mask keeps,
    counted as the block-level causal skip sees them: keys 0..qpos) and its
    bytes (q, k, v read once, o written once) over HBM bandwidth."""
    pairs = (sum(min(qp + 1, T_) for qp in range(S)) if causal else S * T_)
    flops = 4 * B * H * hd * pairs
    nbytes = torch.finfo(dtype).bits // 8 * (2 * B * S * H * hd
                                             + 2 * B * T_ * KV * hd)
    peak = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_flash(dev) -> dict:
    """Flash attention against its plain version at the serving path's
    prefill shapes and at off-path cases; timed per launch at the path's
    shapes.  Returns the numbers at S=2048, the largest prefill, with the
    largest error over all path shapes."""
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(S, T_, H, KV, hd, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((1, S, H, hd), (1, T_, KV, hd), (1, T_, KV, hd))]

    def check(what, q, k, v, causal=True, window=None) -> float:
        got = K.flash_attention(q, k, v, causal=causal, window=window)
        want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16 (and f16)
        t = 2e-5 if q.dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(
            got.float(), want.float(), rtol=t, atol=t,
            msg=lambda m: f"flash_attention {what}: {m}")
        return err

    res = {}
    for S in FLASH_SEQS:
        q, k, v = inputs(S, S, 32, 4, 64, torch.bfloat16)
        err = check(f"bf16 S={S}", q, k, v)
        # the plain version rounds p to bf16 before the PV product and the
        # kernel does not, so 2e-2 is loose at long rows (|o| ~ 0.05 at
        # S=2048); against the plain version on f32 copies (no rounding
        # but the inputs') the kernel is held to about one bf16 ulp of o
        got = K.flash_attention(q, k, v)
        want32 = R.flash_attention_ref(q.float(), k.float(), v.float())
        err32 = float((got.float() - want32).abs().max())
        torch.testing.assert_close(
            got.float(), want32, rtol=FLASH_F32_RTOL, atol=FLASH_F32_ATOL,
            msg=lambda m: f"flash_attention bf16 S={S} vs f32 copies: {m}")
        ms = time_ms(lambda: K.flash_attention(q, k, v))
        plain = time_ms(lambda: R.flash_attention_ref(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound, by = flash_bound(1, S, S, 32, 4, 64, q.dtype, True)
        res[S] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                  "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        print(f"kernel flash_attention bf16 q (1,{S},32,64) kv (1,{S},4,64) "
              f"causal: max_abs_err={err:.3e} (vs f32 copies {err32:.3e}, "
              f"max |o| {float(want32.abs().max()):.3f}) ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bound:.5f} ({by})")
    for what, S, T_, H, KV, hd, dt, causal, window in (
            ("f32", 129, 129, 32, 4, 64, torch.float32, True, None),
            ("f16", 1000, 1000, 32, 4, 64, torch.float16, True, None),
            ("hd 128", 1000, 1000, 16, 2, 128, torch.bfloat16, True, None),
            ("window 128", 1000, 1000, 32, 4, 64, torch.bfloat16, True, 128),
            ("non-causal", 129, 300, 32, 4, 64, torch.bfloat16, False, None)):
        err = check(what, *inputs(S, T_, H, KV, hd, dt), causal=causal,
                    window=window)
        print(f"kernel flash_attention {what} (S={S}, T={T_}, H={H}, "
              f"KV={KV}, hd={hd}): max_abs_err={err:.3e} within tolerance")
    main = dict(res[max(FLASH_SEQS)])
    main["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return main


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
    launches = {name: getattr(K, name).launches for name in SYNC_KERNELS}
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


def _engine_requests(vocab: int, seed: int, lens, new: int) -> list:
    rng = np.random.default_rng(seed)
    return [ENG.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=new) for i, n in enumerate(lens)]


def phase_serving_checks(dev, params, cfg) -> None:
    """The serving path's results against references: the engine on the
    card against the engine on the CPU (reduced tinyllama, f32), and full
    tinyllama-1.1b prefill with the kernel against prefill without it."""
    rcfg = cfg.reduced()
    cpu_params = ST.init_params(rcfg, seed=0, device="cpu")
    outs = {}
    for name, p in (("cuda", T.map(lambda a: a.to(dev), cpu_params)),
                    ("cpu", cpu_params)):
        eng = ENG.ServeEngine(p, rcfg, max_slots=3, cache_len=96)
        for r in _engine_requests(rcfg.vocab, 3, (1, 7, 40, 64, 65),
                                  8):
            eng.submit(r)
        outs[name] = {r.rid: r.output for r in eng.run_to_completion()}
    if outs["cuda"] != outs["cpu"] or len(outs["cpu"]) != 5:
        raise AssertionError(f"reduced engine: cuda {outs['cuda']} != cpu "
                             f"{outs['cpu']}")
    print(f"reduced tinyllama engine, 5 requests over 3 slots: cuda greedy "
          f"tokens equal cpu's ({sum(map(len, outs['cpu'].values()))} "
          f"tokens)")

    # the same weights in f32 (TF32 off): how far each bf16 path lies from
    # a run that rounds nowhere but in its inputs
    params32 = T.map(lambda a: a.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for S in (129, 2048):
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab, (1, S))).to(dev)
        with torch.no_grad():
            lk, ck = ST.prefill(params, cfg, toks, CACHE_LEN,
                                use_kernels=True)
            lp, cp = ST.prefill(params, cfg, toks, CACHE_LEN)
            l32, c32 = ST.prefill(params32, cfg32, toks, CACHE_LEN)
        if lk.shape != (1, cfg.vocab) or not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"prefill S={S}: logits {tuple(lk.shape)} "
                                 f"not finite or misshapen")
        diff = float((lk.float() - lp.float()).abs().max())
        def cache_diff(a, b):
            return max(float((a[0][n].float() - b[0][n].float()).abs().max())
                       for n in ("k", "v"))

        cdiff = cache_diff(ck, cp)
        e_k = float((lk.float() - l32).abs().max())
        e_p = float((lp.float() - l32).abs().max())
        print(f"prefill {ARCH} S={S}: max |logit| {float(lp.abs().max()):.3f}"
              f", kernel vs dense max |diff| {diff:.4e} (tolerance "
              f"{PREFILL_LOGIT_TOL}); cache max |entry| "
              f"{max(float(c32[0][n].abs().max()) for n in ('k', 'v')):.3f}, "
              f"kernel vs dense max |diff| {cdiff:.4e} (tolerance "
              f"{PREFILL_CACHE_TOL}); against f32 weights: logits kernel "
              f"{e_k:.4e}, dense {e_p:.4e}, cache kernel "
              f"{cache_diff(ck, c32):.4e}, dense {cache_diff(cp, c32):.4e}; "
              f"argmax {int(lk.argmax())} / {int(lp.argmax())} / "
              f"{int(l32.argmax())} (kernel / dense / f32)")
        if not diff <= PREFILL_LOGIT_TOL:
            raise AssertionError(f"prefill S={S}: kernel logits differ from "
                                 f"dense by {diff} > {PREFILL_LOGIT_TOL}")
        if not cdiff <= PREFILL_CACHE_TOL:
            raise AssertionError(f"prefill S={S}: kernel caches differ from "
                                 f"dense by {cdiff} > {PREFILL_CACHE_TOL}")
        # the kernel (f32 probabilities) adds no error of its own to the
        # bf16 model: it lies no further from the f32 run than twice the
        # dense bf16 path does
        if not e_k <= 2 * e_p:
            raise AssertionError(f"prefill S={S}: kernel path {e_k} from "
                                 f"the f32 run, dense path {e_p}")
        del ck, cp, c32
    del params32

    for use_kernels in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                ST.prefill(params, cfg, toks, CACHE_LEN,
                           use_kernels=use_kernels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"prefill {ARCH} 2048 tokens, use_kernels={use_kernels}: "
              f"{statistics.median(times) * 1e3:.1f} ms (median of 3, host "
              f"clock, synced)")
    phase_decode_trace(dev, params, cfg)


def phase_decode_trace(dev, params, cfg, steps: int = 5) -> None:
    """Where a decode step's time goes: ``decode_step`` over full slots
    (8 slots at positions 64..1856 of a 4096 cache), timed on the host
    clock, then traced with ``torch.profiler`` (printed only).  The idle
    share is read from the trace alone: the device's busy time (the union
    of its activities) over the span from the first one's start to the
    last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    caches = ST.init_cache(cfg, SLOTS, CACHE_LEN, device=dev)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=dev)
    pos = torch.arange(SLOTS, device=dev) * 256 + 64

    def run(n):
        with torch.no_grad():
            for _ in range(n):
                ST.decode_step(params, cfg, caches, tok, pos)
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(10)
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    # device rows from the device's own activities: the key averages also
    # give each host op the time of the kernels it launched, so summing
    # them counts every kernel twice
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    dev_rows = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                      reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, reach = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    wall = spans[-1][1] - spans[0][0] if spans else 0.0
    idle = f"{100 * (1 - busy / wall):.1f}%" if wall else "not measured"
    print(f"decode step, {SLOTS} slots: {host_ms:.2f} ms per step (host "
          f"clock, 10 steps, synced); traced {steps} steps: device busy "
          f"{busy / 1e3 / steps:.2f} ms of {wall / 1e3 / steps:.2f} ms per "
          f"step (first to last device activity), idle {idle}")
    for t, n, k in dev_rows[:6]:
        print(f"  device {t / 1e3 / steps:7.3f} ms/step  {n // steps:5d} "
              f"calls/step  {k[:90]}")
    rows = prof.key_averages()
    cpu_rows = sorted(((e.self_cpu_time_total, e.count, e.key)
                       for e in rows), reverse=True)
    for t, n, k in cpu_rows[:8]:
        print(f"  host   {t / 1e3 / steps:7.3f} ms/step  {n // steps:5d} "
              f"calls/step  {k[:90]}")
    del caches


def phase_serving(dev, params, cfg) -> int:
    """The serving path: 35 requests through ``ServeEngine`` on full
    tinyllama-1.1b.  Returns the flash-attention launches of that run."""
    wl = WL.Workload(n_requests=32, prompt_lens=(16, 2048),
                     new_tokens=(32, 64), seed=0)
    reqs = WL.materialize_requests(wl, cfg.vocab)
    for r in _engine_requests(cfg.vocab, 1, (1, 129, 2048), 32):
        r.rid += len(wl.requests())
        reqs.append(r)
    eng = ENG.ServeEngine(params, cfg, max_slots=SLOTS, cache_len=CACHE_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: getattr(K, name).launches for name in REPLACES}
    peak = torch.cuda.max_memory_allocated()

    if sorted(r.rid for r in done) != list(range(len(reqs))):
        raise AssertionError(f"serving: {len(done)} of {len(reqs)} requests "
                             f"completed")
    for r in done:
        if (len(r.output) != r.max_new_tokens
                or not all(0 <= t < cfg.vocab for t in r.output)):
            raise AssertionError(f"serving: request {r.rid} gave "
                                 f"{len(r.output)} tokens, want "
                                 f"{r.max_new_tokens} in [0, {cfg.vocab})")
    want = {name: 0 for name in SYNC_KERNELS}
    want["flash_attention"] = cfg.n_layers * len(reqs)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, want {want} "
                             f"(flash attention once per layer per prefill)")
    m = eng.metrics()
    plens = [len(r.prompt) for r in reqs]
    print(f"serving {ARCH}: {len(reqs)} requests (prompts {min(plens)}-"
          f"{max(plens)} tokens, {sum(plens)} in all), {SLOTS} slots, cache "
          f"{CACHE_LEN}, {cfg.dtype}; {m['tokens']} tokens in "
          f"{m['decode_steps']} decode steps, {wall:.2f} s wall")
    print(f"serving metrics: ttft p50 {m['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{m['ttft_p99_s'] * 1e3:.1f} ms; tpot p50 "
          f"{m['tpot_p50_s'] * 1e3:.2f} ms, p99 {m['tpot_p99_s'] * 1e3:.2f} "
          f"ms; latency p50 {m['latency_p50_s']:.2f} s, p99 "
          f"{m['latency_p99_s']:.2f} s; {m['tokens_per_s']:.1f} tokens/s "
          f"over the span; max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"launches on the serving path: {launches}")
    return launches["flash_attention"]


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
    res["flash_attention"] = phase_flash(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches, plan = phase_training(dev, tmp, strat, leaves)
        phase_trace(plan)
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    params = ST.init_params(cfg, seed=0, device=dev)
    phase_serving_checks(dev, params, cfg)
    launches["flash_attention"] = phase_serving(dev, params, cfg)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
                "bound_ms": res[name]["bound_ms"],
                "bound_by": res[name]["bound_by"],
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
