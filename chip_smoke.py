#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100, sm_90a).

    python3 chip_smoke.py [--only ad]

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
(c) flash attention against its plain version at tinyllama's prefill
    shapes (q (1,S,32,64), k and v (1,S,4,64), bf16, causal, S in 1, 129,
    1000, 2048) and at off-path cases (f32, hd 128, a window of 128,
    non-causal); at the path's shapes also against the plain version on f32
    copies of the inputs, to about one bf16 ulp of the output; timed per
    launch beside its plain version, ``scaled_dot_product_attention`` and
    its bound.  Each line names the route that served it (bf16 and f16 on
    the tensor cores, f32 on the CUDA cores), the achieved TFLOP/s, and the
    tensor-core kernel's registers and spills (from the build's ``-Xptxas
    -v`` log) and shared memory per block.
(d) the RG-LRU kernel against its plain version at recurrentgemma-9b's
    prefill shapes ((1,S,4096) bf16, S in 1, 129, 1024, 1984, 2048), at
    off-path cases (f32, B=2, L=1000, lam in another dtype), at lengths on
    either side of its chunk of 32 steps (B=2) and with extreme decays (a
    about e^-48 and a = 1); timed at S=2048 beside its plain version and
    its HBM bound, with the CUDA launches of one call (from the profiler)
    and its scratch bytes.
(e) flash attention at recurrentgemma-9b's local attention (q (1,S,16,256),
    k and v (1,S,1,256), bf16, causal, window 2048, S in 1, 129, 1984,
    2048, and S=3000 past the window), checked, timed and reported as in
    (c).
(f) the WKV-6 kernel against its plain version, output and final state, at
    rwkv6-3b's prefill shapes ((1,S,40,64), bf16 r, k, v with f32 w and u,
    S in 1, 129, 2048), at off-path cases (f32, w in bf16, f16, B=2 at
    hd 32, hd 128), at lengths on either side of its chunk of 4096/hd
    steps (B=2, hd 32, 64 and 128, f32 and w in bf16) and with extreme
    decays (w = 0, 1e-40 and 1); timed at S=2048 beside its plain version
    and its bound, with the CUDA launches of one call and its scratch
    bytes.
(g) training: reduced tinyllama on the card against the same run on the
    CPU; then the training path -- ``repro_torch.launch.train.main`` on full
    tinyllama-1.1b (22 layers, d_model 2048, bf16 weights, f32 AdamW
    moments), batch 4 x seq 2048, in a one-rank NCCL group, with every
    bucket fused into 2 chunks.  Launch and collective counters are zeroed
    just before and read just after, and must show every kernel ran.
(h) a trace: device time by kernel over 3 more steps of the training path,
    from ``torch.profiler`` (printed only; it changes no result).
(i) unfused buckets: the bucket-pack kernel bitwise against its plain
    version at the training path's buckets and at a padding case, timed
    beside its plain version, ``torch.cat`` into an f32 view and its HBM
    bound; then ``train.main`` on full tinyllama-1.1b (batch 2 x seq 512,
    3 steps) with a strategy that mixes fused buckets with unfused ``ar``
    and ``rs_ag`` buckets at 1 and 3 chunks: the bucket pack runs once per
    unfused bucket per step, the fused kernels once per fused bucket per
    step; and at each of 2 steps of the same model the gradients that
    strategy syncs are bitwise equal to those an all-fused one syncs.
(j) the search path: ``train.main --strategy auto --cluster h100_superpod``
    traces full tinyllama-1.1b's step at batch 4 x seq 2048 on meta
    tensors, searches it priced for an H100, saves the Plan and enacts it
    on the card for 4 steps.  The counters are zeroed just before and read
    just after: each sync kernel and collective ran as often as the Plan
    implies.  Also: finite losses, buckets covering every leaf once, the
    saved Plan loading back equal (and through ``GradSyncStrategy.load``
    into the same buckets), trace plus search within 120 s; printed: the
    prims by category, the Plan, its predicted compute time beside the
    measured step, and one launch's host cost beside the ``H100_SXM``
    value.
(k) serving checks, tinyllama-1.1b: the reduced model served on the card
    against the same requests served on the CPU (equal greedy tokens); full
    ``prefill`` with the kernel against ``prefill`` without it, and both
    against f32 weights, at 129 and 2048 tokens (largest logit and cache
    differences under stated tolerances); the 2048-token prefill timed and
    traced; a decode step traced.
(l) serving tinyllama-1.1b: ``ServeEngine`` (bf16 weights and KV cache, 8
    slots, cache 4096), 35 requests submitted at once (32 of
    ``Workload(n_requests=32, prompt_lens=(16, 2048), new_tokens=(32,
    64))`` plus prompts of 1, 129 and 2048 tokens), decoded greedily to
    completion.  The launch counters are zeroed just before and read just
    after: flash attention runs once per layer per prefill, every launch
    on the tensor-core route.
(m) serving checks, recurrentgemma-9b, as (k): the reduced model on the
    card against the CPU; full ``prefill`` with both kernels against
    ``prefill`` without them and both against f32 weights, at 129 and 1984
    tokens (logits, k/v caches and RG-LRU states under stated tolerances);
    the 1984-token prefill timed and traced (device busy time, time in the
    RG-LRU and flash launches); a decode step traced.  Full-size weights
    are drawn on the card.
(n) serving recurrentgemma-9b (38 layers, d_model 4096, bf16 weights and
    cache, 8 slots, cache 2048 = the attention window): 20 requests
    submitted at once (16 of ``Workload(n_requests=16, prompt_lens=(16,
    1920), new_tokens=(32, 64))`` plus prompts of 1, 129, 1024 and 1984
    tokens), greedy.  The RG-LRU kernel runs once per RG-LRU layer per
    prefill (26 x 20) and flash attention once per attention layer (12 x
    20), every launch on the tensor-core route.
(o) serving checks, rwkv6-3b, as (k): the reduced model on the card
    against the CPU; full ``prefill`` with the WKV-6 kernel against
    ``prefill`` without it and both against f32 weights, at 129 and 2048
    tokens (logits and the recurrent state: the WKV state and both token
    shifts' last inputs); the 2048-token prefill timed and traced (device
    busy time, time in the WKV-6 launches); a decode step traced.
    Full-size weights are drawn on the card.
(p) serving rwkv6-3b (32 layers, d_model 2560, 40 heads at hd 64, bf16
    weights, 8 slots, cache 4096): the traffic of (l), greedy.  The WKV-6
    kernel runs once per layer per prefill (32 x 35).
(q) the estimator: ``calibrate_hw`` fits the card's bf16 matmul peak,
    read-and-write bandwidth and launch cost (printed beside
    ``H100_SXM``'s); full tinyllama-1.1b's step, traced at batch 4 x seq
    2048 on meta tensors, is simulated at dp=1 under the fit and under
    ``H100_SXM`` beside phase (j)'s measured step (the paper's Table 2);
    the GNN (the reference's fig11 settings: 2 layers, 4 heads of 16, 250
    oracle-labelled fused groups of that graph, 40 epochs) is trained on
    the card, its training loss must halve and its forward on the card
    equal the CPU's within 1e-5 in log-time; the step is searched on
    ``h100_superpod`` with the GNN as the cost model and with the oracle,
    the GNN's Plan is scored by the oracle (the gap in percent), beside
    every baseline of ``evaluate_baselines``; the GNN's Plan is enacted
    through ``train.main --strategy-file`` for 4 steps (finite losses,
    launches and collectives as the Plan implies, the bucket pack bitwise
    on its unfused buckets, the saved Plan naming ``GNNEstimator``); 96
    tier B fused ops (up to 10 ops on f32 2048 x 2048) are each compiled
    by ``torch.compile`` into one graph and timed on the card, and a GNN
    (the reference's fig9 settings: 3 layers, 60 epochs, batches of 32)
    trained on 85% of them prints its held-out error percentiles and its
    share within 14%; a compile into a plan cache, repeated, is a hit
    that makes no oracle query.  The phase must finish within
    ``ESTIMATOR_LIMIT_S``.
(r) the per-layer model, full tinyllama-1.1b (after (l), on its weights):
    the step at batch 4 x seq 2048 traced on meta tensors with
    ``model="layers"`` at 6 and 22 layers (no opaque prim, one gradient
    marker per leaf) and searched on ``h100_superpod`` under ``H100_SXM``
    (prims by category, trace and search seconds, the Plan's buckets, the
    simulated compute; trace plus search at 22 layers within 120 s); one
    loss and its gradients on the card (``remat``), the per-layer model
    against the stacked one on the same bf16 weights (the loss within
    ``LAYERS_LOSS_RTOL``, the global gradient norm within
    ``LAYERS_GNORM_RTOL``), then 5 such steps of each model timed, with the
    per-layer model's peak memory; a 2048-token prefill through the flash kernel: 22 launches,
    all on the tensor cores, and last-token logits equal to the stacked
    model's prefill.
(s) the serving plan: ``compile_serving`` for (l)'s traffic on
    ``h100_superpod`` at TP degree 1 (the knobs, the predicted tokens/s
    and TTFT p99, the search seconds); the plan saved and loaded bit for
    bit; a compile through a ``PlanCache`` repeated is a hit that runs no
    simulation; then ``ServeEngine(params, cfg, plan=plan)`` serves (l)'s
    35 requests as (l) does (every request in full, flash once per layer
    per prefill on the tensor cores, the engine's ``kv_layout`` the
    plan's), its metrics printed beside (l)'s and the plan's prediction.
(t) deepseek-v2-lite-16b at full width (27 layers, d_model 2048, MLA with a
    512-wide latent, 64 routed experts top-6 and 2 shared; 15.71B
    parameters drawn on the card, expert stacks cast one at a time): the
    reduced model's engine on the card against the CPU; per-row routing in
    the engine: the reduced model (f32, capacity 1.0, 16 slots) gives the
    greedy tokens of a batch-1 prefill and ``decode_step`` loop, and at full
    width the engine's first decode step over 4 of the cell's requests picks
    each row's top-6 experts in every MoE layer as a batch-1 step does (a
    swap only between experts whose router logits lie closer than the two
    steps' router logits differ), its logits within
    ``DS_ROW_LOGIT_TOL``; then (l)'s traffic served at 8 slots and cache
    4096 (every request in full, no kernel launched: MLA and the experts run
    no kernel), a decode step traced; loss and gradients at a cut depth of
    4 layers (1 dense, 3 MoE) at batch 1 x 2048, finite, the aux loss
    printed; the full 27-layer step at batch 4 x 2048 traced on meta
    tensors and searched on ``h100_superpod`` (prims, DOT FLOPs beside the
    analytic model's, buckets, seconds; not enacted: its f32 AdamW moments
    alone would take 126 GB).
(u) the int8 KV cache on full tinyllama-1.1b (weights drawn on the card): 64
    decode steps from ``init_cache`` (cache 4096) at 8 and at 64 rows, with
    the bf16 cache and then the int8 cache on the same tokens: ms per step
    (host clock, synced), peak memory, the caches' bytes and the largest
    logit difference of the int8 run from the bf16 run.
(v) tensor parallelism: ``train.main`` on full tinyllama-1.1b (batch 4 x
    seq 2048, 1 warm-up and 3 timed steps) with ``--mesh single`` (a (1,
    1) ``("data", "model")`` mesh in a one-rank NCCL group, ``layout
    "tp"``: the tensor-parallel layers, the vocab-parallel embedding and
    cross-entropy, the model group's collectives at degree 1) against
    ``--mesh dp``, both through a strategy that mixes fused buckets with
    unfused ``ar`` and ``rs_ag`` ones.  The counters are zeroed just before
    each run and read just after: each sync kernel and collective ran as
    often as the strategy implies in both.  Printed: both layouts' losses
    and gradient norms and their relative gaps (the vocab-parallel CE
    runs its head GEMM in f32, the plain one in bf16: the gaps must stay
    under ``TP_LOSS_RTOL`` and ``TP_GNORM_RTOL``), step times, peak
    memory, and the model group's collective calls.
(w) the VLM prefix decoder, full paligemma-3b (18 layers, d_model 2048,
    8 heads over 1 KV head at hd 256, vocab 257216; weights drawn on the
    card): flash attention against its plain version at its prefill
    shapes (q (1,S,8,256), k and v (1,S,1,256), bf16, causal, S in 1, 129
    and 2048, the patches counted in S), timed as in (c); ``prefill`` of
    256 stub patch embeddings and 1792 tokens with the kernel against
    ``prefill`` without it, both against f32 weights (last-token logits
    and k/v caches within (k)'s tolerances and ``F32_PATHS_TOL``): one
    flash launch per decoder layer (18), all on the tensor cores; that
    prefill timed and traced (device busy time, flash's share); 16
    ``decode_step``s from each of the two caches, logits within (k)'s
    tolerance; then ``train.main --strategy auto --cluster h100_superpod``
    at batch 4 x 2048 text tokens (the stubs in every batch) for 4 steps:
    finite losses, the sync kernels and collectives the Plan implies,
    trace plus search within 120 s; printed: prims by category, the
    Plan's buckets, the steady step, text tokens/s and peak memory.
(x) the encoder-decoder, full seamless-m4t-medium (12 encoder and 12
    decoder layers, d_model 1024, 16 heads over 16 KV heads at hd 64,
    vocab 256208; weights drawn on the card), as (w): flash at (1,S,16,64)
    over 16 KV heads; prefill of 2048 tokens cross-attending the encoder's
    output over 1024 stub frames (12 flash launches: the encoder's and
    the cross-attention's attention are plain, non-causal, as in the
    reference); 16 decode steps passing the encoder's output as
    ``memory``; the launcher's search and 4 steps at batch 4 x 2048.
(y) training the other blocks at full width and a cut depth:
    recurrentgemma-9b at 8 layers (two (rec, rec, attn) cycles and the
    two-layer tail), rwkv6-3b at 4 and deepseek-v2-lite-16b at 4 (1 dense,
    3 MoE; weights drawn on the card).  Each step at batch 1 x 2048 is
    traced on meta tensors and searched for ``h100_superpod`` by the
    launcher's ``search_strategy``; the Plan is enacted by
    ``build_train_step`` under ``layout="dp"`` and under ``layout="tp"``
    on a (1, 1) mesh (the RG-LRU, RWKV-6, MLA and expert-parallel blocks'
    tensor-parallel paths at degree 1), 3 AdamW steps each (the
    launcher's schedule) on the same weights and batches.  The counters are
    zeroed just before each run and read just after: each sync kernel and
    collective ran as often as the Plan implies, and no serving kernel ran.
    Printed: trace seconds, prims and the WKV op's fx nodes (one forward
    and one backward a layer), the Plan, step time, tokens/s, peak
    memory, the model group's collectives, losses and gradient norms with
    the layouts' gaps (under ``TP_LOSS_RTOL`` and ``TP_GNORM_RTOL``).  The
    phase must finish within ``TRAIN_BLOCKS_LIMIT_S``.
(z) the reference's dry run in the port, and ZeRO-3 on the card:
    - at the script's start two processes begin the full-width dry runs on
      the host, each on a core of its own at the lowest priority (nice
      19), ``python -m repro_torch.launch.dryrun --arch rwkv6-3b``
      (its 40 heads split over 16 model ranks) and ``--arch
      deepseek-coder-33b`` (``mode="fsdp_tp"``), each at ``train_4k`` as
      rank 0 of the (16, 16) production mesh on the ``fake`` process-group
      backend and fake tensors; the phase reads their JSON and prints each
      run's flops, collectives per op and group size, argument + temp GiB
      per device, ``best_time_s`` and seconds;
    - the pricing CLI on phase (j)'s saved Plan (``--plan``) and phase
      (s)'s serving plan (``--serve-plan``), in subprocesses: each exits 0
      with the prices ``Plan.price()`` and ``ServingPlan.price()`` give
      here; with a ``--cluster`` that differs from the Plan's it exits 1
      and prints the differing fields;
    - full-width deepseek-coder-33b at 4 of its 62 layers (2.58B
      parameters; weights drawn on the card), batch 1 x 2048, 3 AdamW
      steps under ``mode="fsdp_tp"`` on a one-rank NCCL (1, 1) mesh, then
      the same 3 steps under ``ddp_tp`` with ``layout="tp"``: the counters
      zeroed just before each run and read just after (the clip's
      convert-copy launches, the data group's gathers and scatters),
      losses and gradient norms within ``ZERO3_GAP`` (one rank: the same
      sums in the same order); printed: step, tokens/s and
      ``max_memory_allocated``, beside the dry run's argument + temp
      bytes for the same step on a fake (1, 1) world (a peak the update
      makes); then the forward and backward alone
      (``step.loss_and_grads``) at ``MEM_BATCH`` x 2048, whose temp (the
      gradients and activations) is printed beside the dry run's.
    Within ``DRYRUN_LIMIT_S``.
(aa) serving under the tensor-parallel layout:
    - at the script's start, beside (z)'s dry runs and likewise on a core
      of its own at nice 19, ``python -m repro_torch.launch.sweep --arch
      tinyllama-1.1b,deepseek-v2-lite-16b,rwkv6-3b --shape
      prefill_32k,decode_32k,long_500k --meshes single`` (each run a
      subprocess: rank 0 of (16, 16), fake backend and tensors), and a
      process running the memory points' dry runs on a fake (1, 1) world;
      the phase prints each sweep run's flops, collectives per op and
      group size, argument + temp GiB per device, ``best_time_s`` and host
      seconds (deepseek-v2-lite-16b's ``long_500k`` is not applicable);
    - on the weights each serving phase holds (tinyllama-1.1b after (s),
      recurrentgemma-9b after (n), rwkv6-3b after (p),
      deepseek-v2-lite-16b after (t)'s serving run): the longest prompt's
      prefill with ``use_kernels=True, tp=`` (a one-rank NCCL (1, 1)
      mesh) and ``SERVE_TP_STEPS`` decode steps with ``tp=``, against the
      same calls without ``tp``: logits within the cell's bf16
      tolerance, greedy tokens and caches equal, flash, RG-LRU and WKV-6
      launches per prefill equal (the counters zeroed just before each
      prefill and read just after); prefill and decode ms beside dp's;
    - two memory points of tinyllama-1.1b on a (1, 1) mesh, each built by
      the dry run's own builders on the card: a decode step at
      ``MEM_DECODE_ROWS`` rows over caches of ``MEM_SEQ`` and a
      kernel-free prefill of ``MEM_PREFILL_ROWS`` x ``MEM_SEQ``; the
      card's ``max_memory_allocated`` beside the dry run's argument +
      temp, within ``MEM_POINT_GAP``.
    Within ``SERVE_TP_LIMIT_S``, the serving checks' seconds counted in.
(ab) the example twins (``repro_torch.examples``):
    - search_and_enact at full width: at the script's start a process on
      a core of its own at nice 19 searches full qwen2-0.5b
      (``SE.search``, ``ENACT_CLUSTER``, ``ENACT_STREAMS`` streams, 4
      devices, at most ``ENACT_MAX_STEPS`` steps), saves and loads the
      Plan (an exact round trip) and counts the collectives of one rank's
      ``ddp_tp`` step on a fake (4, 2) world under per-tensor syncing and
      under the Plan; the phase asserts the data group's counts are what
      the Plan's buckets imply and the model group's equal, holds the
      step's sync kernels to their plain versions at its shapes, and runs
      one step of the loaded Plan on a one-rank NCCL (1, 1) mesh
      (``SE.enact``): sync launches and collectives as the Plan implies,
      a finite loss;
    - the train_lm twin at its defaults (reduced qwen2-0.5b, 200 steps,
      ``--strategy auto``): launches and collectives as its Plan implies,
      the loss at the last log below the first;
    - the serve_decode twin's CLI at its defaults (one flash launch a
      layer);
    - on held weights: serve_decode's loop on full tinyllama-1.1b (after
      (aa)'s check) and full rwkv6-3b (after its serving phase), 8 prompts
      of 32 and 64 new tokens, one prefill's kernel launches asserted
      (flash 22, WKV-6 32), logits against a kernel-free prefill and
      ``DECODE_CHECK_STEPS`` steps fed the same tokens within the cell's
      tolerance, the greedy picks counted; and the int8 KV cache under
      ``tp=`` on a one-rank NCCL (1, 1) mesh, ``A8_STEPS`` steps from a
      sharded ``init_cache`` of ``A8_ROWS`` x ``A8_CACHE``, logits,
      entries and scales bit for bit equal to dp's.
    Within ``EXAMPLES_LIMIT_S``, the checks on held weights counted in.
    The counters are zeroed just before each run and read just after.
(ac) serving deepseek-coder-33b at full width (62 layers, d_model 7168,
    56 query heads over 8 KV heads at hd 128, d_ff 19200; 33.34B
    parameters, 66.7 GB in bf16):
    - flash attention at its prefill shape (q (1,S,56,128), k and v
      (1,S,8,128), bf16, causal, S in 1, 129 and 2048) checked, timed
      and reported as in (c), with the tensor-core kernel's registers,
      spills and shared memory at hd 128; and the 7:1 head mapping at
      S = 2048, each KV head's v its own index, so every query head h
      puts out h // 7;
    - the weights drawn on the card from seed 0, a layer at a time
      (``by_layer``: no f32 stack; their bytes, the draw's seconds and
      peak); the reduced model's engine on
      the card against the CPU;
    - the 2048-token prompt's prefill with the kernel (62 launches) and 8
      greedy decode steps against a kernel-free prefill and the same
      steps fed the same tokens: the largest |logit| difference under the
      cell's tolerance, the greedy picks that agree;
    - that prefill timed with and without the kernel and traced; a decode
      step at 8 slots timed and traced (device busy, idle share, device
      activities);
    - ``ServeEngine`` (8 slots, cache 4096) on 19 requests submitted at
      once, 16 of ``Workload(n_requests=16, prompt_lens=(16, 2048),
      new_tokens=(32, 64))`` plus prompts of 1, 129 and 2048 tokens,
      greedy: every request in full, flash once per layer per prefill
      (62 x 19) on the tensor cores, the counters zeroed just before and
      read just after; TTFT, TPOT, tokens/s and
      ``max_memory_allocated`` printed, the peak under the card's memory.
    Within ``CODER_SERVE_LIMIT_S``.
(ad) training attention at the deepseek-coder-33b cell's shape (q (2,
    4096, 56, 128), k and v (2, 4096, 8, 128), bf16, causal): the
    gradients through the flash kernel (its forward with the log-sum-exp,
    its backward) against autograd of the plain version on f32 copies,
    one launch of each counted; then the forward without and with the
    log-sum-exp and the backward timed (median CUDA-event ms) beside their
    bounds, the chunked path's forward and backward (``plain_ms``) and
    ``scaled_dot_product_attention``'s forward and its backward
    (``library_ms``); and the forward's serving shapes of (c), (e), (w),
    (x) and (ac) at S = 2048 re-timed (and at hd 128 with the log-sum-exp
    too).
    ``python3 chip_smoke.py --only ad`` runs (a) and (ad) alone.
Then the total seconds and the card's name and power limit again, a JSON
line of every kernel's numbers, and the device line last.

Exits nonzero, printing no result, without a CUDA device.
"""
import copy
import dataclasses
import functools
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC)

from repro_torch import plan as RP  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.cluster import get_preset  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (DOT, OPAQUE, OracleEstimator,  # noqa: E402
                              Simulator, evaluate_baselines, profile_graph)
from repro_torch.core import gnn as GNN  # noqa: E402
from repro_torch.core import profile as PROF  # noqa: E402
from repro_torch.core.hw import H100_SXM  # noqa: E402
from repro_torch.data.pipeline import materialize_batch  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import tensor_parallel as TPAR  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.examples import search_and_enact as SE  # noqa: E402
from repro_torch.examples import serve_decode as SD  # noqa: E402
from repro_torch.examples import train_lm as TLM  # noqa: E402
from repro_torch.kernels import build, ops as K, ref as R  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.optim import adamw, apply_updates  # noqa: E402
from repro_torch.optim import linear_warmup_cosine  # noqa: E402
from repro_torch.optim import clip_by_global_norm  # noqa: E402
from repro_torch.serving import engine as ENG  # noqa: E402
from repro_torch.serving import plan as SP  # noqa: E402
from repro_torch.serving import workload as WL  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16/f16 tensor cores
F32_FLOP_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
ARCH, BATCH, SEQ, STEPS, CHUNKS = "tinyllama-1.1b", 4, 2048, 4, 2
SLOTS = 8
FLASH_SEQS = (1, 129, 1000, 2048)
RG_ARCH = "recurrentgemma-9b"
RG_SEQS = (1, 129, 1024, 1984, 2048)      # RG-LRU and flash check lengths
RWKV_ARCH = "rwkv6-3b"
WKV_SEQS = (1, 129, 2048)                 # WKV-6 check lengths
DS_ARCH = "deepseek-v2-lite-16b"
VLM_ARCH, ENCDEC_ARCH = "paligemma-3b", "seamless-m4t-medium"
# the multimodal phases: flash check lengths (paligemma's counting its
# patches), the text tokens of the checked prefill (after paligemma's 256
# patches, or cross-attending seamless's 1024 frames), the decode steps
# from its cache, and the most seconds the two phases may take together
MM_FLASH_SEQS = (1, 129, 2048)
MM_PROMPT = {VLM_ARCH: 1792, ENCDEC_ARCH: 2048}
MM_DECODE_STEPS = 16
MM_LIMIT_S = 180.0
# the deepseek phase: the cut depth and sequence of its loss-and-gradient
# step, the requests of the full-width routing check (the cell's shortest
# prompts), and the largest |logit| difference allowed between the engine's
# first decode step (8 rows, M = 8 GEMMs) and a batch-1 decode_step (M = 1)
# on the same cache, bf16 weights: the two round apart in bf16 at every
# GEMM of 27 layers, as the flash and dense prefills of tinyllama do
# (TINYLLAMA.logit_tol); a wrong expert, latent row or position moves the
# logits by their own scale
DS_LOSS_LAYERS, DS_LOSS_SEQ = 4, 2048
DS_ROUTE_REQUESTS = 4
DS_ROW_LOGIT_TOL = 0.25
# the int8 phase: decode steps and the row counts (the engine's 8 slots and
# the serving plan's 64)
INT8_STEPS, INT8_ROWS = 64, (8, 64)
# the unfused-bucket phase: batch x seq, steps of the launcher's run, steps
# of the bitwise check, and each bucket's (fused, kind, chunks) in turn
B1_BATCH, B1_SEQ, B1_STEPS, B1_CHECK_STEPS = 2, 512, 3, 2
# the search path: the cluster it prices for, and the most seconds its
# trace and search may take together
SEARCH_CLUSTER, SEARCH_LIMIT_S = "h100_superpod", 120.0
# the estimator phase: tier A fused groups and GNN epochs (the reference's
# fig11 benchmark), tier B's fused-op count, ops per fused op and width
# (Fig. 9 --measured; each compile takes about a second of host time, and
# the whole script stays well inside its 1200 s), and the most seconds the
# whole phase may take
EST_SAMPLES, EST_EPOCHS = 250, 40
TIER_B_SAMPLES, TIER_B_NODES, TIER_B_DIM = 96, 10, 2048
ESTIMATOR_LIMIT_S = 600.0
# the per-layer phase: the depths it traces and searches at the training
# batch, the loss-and-gradient steps it times, and the per-layer model
# against the stacked one on the same bf16 weights: the loss relative (full
# against chunked cross-entropy) and the global gradient norm relative
LAYERS_DEPTHS = (6, 22)
LAYERS_STEPS = 5
LAYERS_LOSS_RTOL, LAYERS_GNORM_RTOL = 1e-3, 1e-2
# the serving-plan phase: the cluster it prices (one card's TP group, so
# the priced deployment is the one the card enacts)
SERVE_PLAN_TP = 1
# the tensor-parallel phase: steps (the first a warm-up), and the largest
# relative gaps allowed between the tp and dp layouts' losses and gradient
# norms on the same weights and batches.  Only the cross-entropy's head
# GEMM differs at degree 1 (f32 against bf16 logits, about 1e-3 in the
# loss); a wrong vocab slice, mask or reduction moves them by their own
# scale.
TP_STEPS = 4
TP_LOSS_RTOL, TP_GNORM_RTOL = 1e-2, 2e-2
# the training phase of the other blocks (y): each model's cut depth, the
# batch, the steps of each layout (the first a warm-up) and the most
# seconds the phase may take
TRAIN_DEPTHS = {RG_ARCH: 8, RWKV_ARCH: 4, DS_ARCH: 4}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 2048, 3
TRAIN_BLOCKS_LIMIT_S = 180.0
# phase (z): the full-width dry runs (arch, shape), the ZeRO-3 model, its
# cut depth, and the most seconds the phase may take (the dry runs start
# with the script, on the host)
DRYRUNS = (("rwkv6-3b", "train_4k"), ("deepseek-coder-33b", "train_4k"))
FSDP_ARCH, FSDP_DEPTH = "deepseek-coder-33b", 4
DRYRUN_LIMIT_S = 150.0
# the most relative gap of fsdp_tp's losses and gradient norms from
# ddp_tp's: on a (1, 1) mesh both modes sum the same numbers in the same
# order (PR 26's calls 1 and 2 read 0)
ZERO3_GAP = 1e-6
# the rows of the forward-and-backward memory point, where the gradients
# and activations, not the update, make the peak
MEM_BATCH = 4
# phase (aa): the serving dry runs swept on the host from the script's
# start (arch x shape on the (16, 16) mesh); the decode steps of the
# TP-against-dp serving checks; the
# memory points' rows (a decode step over caches of MEM_SEQ, a kernel-free
# prefill of MEM_SEQ tokens) and the most relative gap of the card's peak
# from the dry run's argument + temp; the most seconds the phase may take,
# its serving checks (run beside each model's serving phase, on the
# weights it holds) counted in
SWEEP_ARCHS = ("tinyllama-1.1b", "deepseek-v2-lite-16b", "rwkv6-3b")
SWEEP_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
SERVE_TP_STEPS = 16
MEM_DECODE_ROWS, MEM_PREFILL_ROWS, MEM_SEQ = 8, 2, 32768
MEM_POINT_GAP = 0.05
SERVE_TP_LIMIT_S = 150.0
# phase (ab): the example twins.  search_and_enact at full width: the
# arch, the cluster and streams of its search, the search's step bound;
# serve_decode at full width: rows, prompt and new tokens (the CLI's
# defaults), and the steps of the kernel-free run each full-width decode
# is held to; the int8 cache under tp: rows, cache and decode steps; the
# most seconds the phase may take, its checks on held weights counted in
ENACT_ARCH, ENACT_CLUSTER, ENACT_STREAMS, ENACT_MAX_STEPS = (
    "qwen2-0.5b", "a100_nvlink_ib", 4, 40)
DECODE_ROWS, DECODE_PROMPT, DECODE_NEW, DECODE_CHECK_STEPS = 8, 32, 64, 8
A8_ROWS, A8_CACHE, A8_STEPS = 8, 4096, 16
EXAMPLES_LIMIT_S = 150.0
# phase (ac): full deepseek-coder-33b served; the flash check lengths of its
# prefill shape (56 query heads over 8 KV heads at hd 128), the decode
# steps of its kernel-free check, and the most seconds the phase may take
CODER_ARCH = "deepseek-coder-33b"
CODER_FLASH_SEQS = (1, 129, 2048)
CODER_CHECK_STEPS = 8
CODER_SERVE_LIMIT_S = 180.0
B1_PATTERN = ((1, "ar", CHUNKS), (0, "ar", 1), (0, "rs_ag", 3),
              (0, "ar", 3), (0, "rs_ag", 1))
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"convert_copy": CSRC + "grad_sync.cu",
          "bucket_pack": CSRC + "grad_sync.cu",
          "fused_pack": CSRC + "grad_sync.cu",
          "fused_unpack": CSRC + "grad_sync.cu",
          "flash_attention": CSRC + "flash_attention.cu",
          "rglru_scan": CSRC + "rglru.cu",
          "rwkv6_wkv": CSRC + "wkv6.cu"}
REPLACES = {"convert_copy": "src/repro/kernels/bucket_pack.py:20",
            "bucket_pack": "src/repro/kernels/bucket_pack.py:44",
            "fused_pack": "src/repro/kernels/fused_grad_sync.py:40",
            "fused_unpack": "src/repro/kernels/fused_grad_sync.py:66",
            "flash_attention": "src/repro/kernels/flash_attention.py:82",
            "rglru_scan": "src/repro/kernels/rglru.py:40",
            "rwkv6_wkv": "src/repro/kernels/rwkv6.py:44"}
SYNC_KERNELS = ("convert_copy", "fused_pack", "fused_unpack")
# Operations of the RG-LRU kernel per element: the gate math (r scale,
# two exp, 1 - e, max, sqrt, i x, product) and one multiply-add.
RGLRU_OPS_PER_ELEM = 11
# f32 operations of WKV-6 per (step, key, value), FMA counted as 2: a
# multiply-add to read the state out and a multiply and a multiply-add to
# update it (the bonus term factors into one dot product per step).
WKV_OPS_PER_ENTRY = 5
# The kernels' chunk lengths (csrc/rglru.cu kChunk; csrc/wkv6.cu
# kChunkElems / hd), for the checks at the chunks' edges.
RGLRU_CHUNK = 32
WKV_CHUNK_ELEMS = 4096


@dataclasses.dataclass(frozen=True)
class Serving:
    """One serving cell: the model, the engine's cache, the prefill check
    lengths with their tolerances (``cache_tol`` for k/v leaves,
    ``state_tol`` for recurrent state leaves, None where the model has
    none), the reduced engine's prompts, and the traffic (a ``Workload``
    plus extra prompts of 32 new tokens each)."""
    arch: str
    cache_len: int
    check_seqs: tuple
    logit_tol: float
    cache_tol: Optional[float]
    state_tol: Optional[float]
    reduced_lens: tuple
    workload: WL.Workload
    extra_prompts: tuple


TINYLLAMA = Serving(
    ARCH, 4096, (129, 2048),
    # Largest |logit| difference allowed between full tinyllama-1.1b
    # prefill with the flash kernel and without it (dense attention), bf16
    # weights.  Both bf16 paths lie about 0.065 from an f32 run (logits of
    # magnitude up to 4, 22 layers of bf16 rounding), so they differ by up
    # to about 0.14; a wrong mask or head mapping moves logits by their own
    # scale.  See PERF.md, section 6 (the serving slice).
    logit_tol=0.25,
    # The same for every k/v cache entry (22 layers of bf16 k and v, the
    # first layer's equal on both paths).  Both paths measured 0.08 (S=129)
    # and 0.10 (S=2048) apart, H100; a wrong mask moves later layers' k/v by
    # their own scale.  See PERF.md, section 6.
    cache_tol=0.25, state_tol=None,
    reduced_lens=(1, 7, 40, 64, 65),
    workload=WL.Workload(n_requests=32, prompt_lens=(16, 2048),
                         new_tokens=(32, 64), seed=0),
    extra_prompts=(1, 129, 2048))

RECURRENTGEMMA = Serving(
    RG_ARCH, 2048, (129, 1984),
    # Largest |logit| difference allowed between full recurrentgemma-9b
    # prefill with both kernels and without them, bf16 weights.  The
    # kernel-free path runs the RG-LRU gates and scan in bf16, the kernel in
    # f32.  Measured 0.176 (S=129) and 0.172 (S=1984) at logits up to 22-25,
    # where a bf16 ulp is 0.125; each path lies 0.155-0.166 from an f32 run
    # (H100, PERF.md section 6).  A wrong recurrence or mask moves logits
    # by their own scale.
    logit_tol=0.5,
    # The same for every k/v cache entry (12 attention layers): measured
    # 0.121 and 0.131 at entries up to 5.4 (bf16 ulp 0.031) ...
    cache_tol=0.4,
    # ... and for every RG-LRU state entry, h and conv (26 layers):
    # measured 0.141 and 0.109 at entries up to 4.8.
    state_tol=0.4,
    reduced_lens=(1, 7, 30, 40, 55),
    workload=WL.Workload(n_requests=16, prompt_lens=(16, 1920),
                         new_tokens=(32, 64), seed=0),
    extra_prompts=(1, 129, 1024, 1984))
RWKV6 = Serving(
    RWKV_ARCH, 4096, (129, 2048),
    # Largest |logit| difference allowed between full rwkv6-3b prefill with
    # the WKV-6 kernel and without it (its plain version), bf16 weights.
    # Both run the recurrence in f32 on the same inputs, but where the sums'
    # order flips a bf16 rounding of the output the random-weight model
    # carries it on and grows it layer by layer: each bf16 path lies
    # 0.91-1.10 from an f32 run at logits up to 5.7, and the two paths
    # measured 0.51 (S=129) and 0.46 (S=2048) apart (H100, PERF.md
    # section 6).  The f32 check
    # (F32_PATHS_TOL) is the tight one.
    logit_tol=1.5,
    cache_tol=None,
    # The same for every recurrent state entry (32 layers: the f32 WKV
    # state and the bf16 last inputs of both token shifts): measured 3.03
    # and 2.67 at entries up to 27, each path 4.4-5.6 from the f32 run.
    state_tol=9.0,
    reduced_lens=(1, 7, 40, 64, 65),
    workload=TINYLLAMA.workload,
    extra_prompts=TINYLLAMA.extra_prompts)
DEEPSEEK = Serving(
    DS_ARCH, 4096, (), logit_tol=DS_ROW_LOGIT_TOL, cache_tol=None,
    state_tol=None, reduced_lens=(1, 7, 40, 64, 65),
    workload=TINYLLAMA.workload, extra_prompts=TINYLLAMA.extra_prompts)
CODER = Serving(
    CODER_ARCH, 4096, (2048,),
    # Largest |logit| difference allowed between full deepseek-coder-33b's
    # prefill of 2048 tokens (and 8 decode steps after it) with the flash
    # kernel and without it (dense attention), bf16 weights: measured 0.172
    # at logits up to 6.3 (62 layers of bf16 rounding on either path; H100,
    # PERF.md section 6).  A wrong mask or head mapping moves logits by
    # their own scale.
    logit_tol=0.5, cache_tol=None, state_tol=None,
    reduced_lens=(1, 7, 40, 64, 65),
    workload=WL.Workload(n_requests=16, prompt_lens=(16, 2048),
                         new_tokens=(32, 64), seed=0),
    extra_prompts=(1, 129, 2048))
# Kernel against kernel-free prefill with f32 weights, every cell: the
# largest |difference| allowed in logits and in every cache and state entry.
# Only the order of f32 sums differs (and flash's f32 probabilities), so a
# wrong state, mask or index moves them by their own scale.  Measured at
# most 4.1e-5 (tinyllama-1.1b, recurrentgemma-9b) and 1.1e-4 in logits and
# 5.5e-4 in WKV states up to 27 (rwkv6-3b), H100; PERF.md section 6.
F32_PATHS_TOL = 2e-3
# Flash attention in bf16 against the plain version on f32 copies of its
# inputs: one bf16 rounding of the output (relative 2**-9) and f32 sums.
FLASH_F32_RTOL, FLASH_F32_ATOL = 8e-3, 2e-3
# The tensor-core flash kernel's registers and spills by (dtype, hd), read
# from this run's build log (empty when the library was already built).
FLASH_TC_PTXAS: dict = {}


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


def cuda_launches(fn) -> list:
    """The CUDA kernels that one call of ``fn`` launches, in order, as
    (name, device microseconds from its start to its end), from
    ``torch.profiler``'s device activity (copies and fills left out).  A
    programmatic dependent launch starts before the one ahead of it ends,
    so its span includes its wait."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))),
                  key=lambda e: e.time_range.start)
    out = []
    for e in kern:
        m = re.search(r"::(\w+)[<(]", e.name)
        out.append((m.group(1) if m else e.name[:40],
                    e.time_range.elapsed_us()))
    return out


def launch_line(launches: list) -> str:
    return (f"cuda_launches_per_call={len(launches)} (" + ", ".join(
        f"{name} {us:.2f} us" for name, us in launches) + ")")


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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_card_and_build() -> None:
    print("card (nvidia-smi name, power.limit):")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, secs, log = build.build()
    print(f"build: {path.name} " + (f"compiled in {secs:.1f} s" if secs
                                     else "already built"))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    FLASH_TC_PTXAS.update(flash_tc_ptxas(log))
    build.load_library()


def flash_tc_ptxas(log: str) -> dict:
    """Registers and spill bytes of each ``flash_tc_kernel`` instance in an
    ``nvcc -Xptxas -v`` log, keyed by (dtype name, head dim)."""
    out, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            # serving's instance (no log-sum-exp store: Lb0)
            m = re.search(r"flash_tc_kernelI(13__nv_bfloat16|6__half)Li(\d+)"
                          r"ELb0E", entry.group(1))
            key = (("bf16" if "bfloat" in m.group(1) else "f16"),
                   int(m.group(2))) if m else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(key, {})["spills"] = (int(m.group(1)),
                                                 int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


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


def flash_flops(B, S, T_, H, hd, causal, window=None) -> int:
    """Operations of one attention call: 2 FLOPs per multiply-add, QK and
    PV, over the (query, key) pairs the mask keeps (causal: keys 0..qpos,
    and at most ``window`` of them)."""
    pairs = (sum(min(qp + 1, T_, window or T_) for qp in range(S))
             if causal else S * T_)
    return 4 * B * H * hd * pairs


def flash_bound(B, S, T_, H, KV, hd, dtype, causal,
                window=None) -> tuple[float, str]:
    """The least time for one attention call on these inputs: the larger
    of its operations (:func:`flash_flops`) over the peak rate for the
    input dtype and its bytes (q, k, v read once, o written once) over HBM
    bandwidth."""
    flops = flash_flops(B, S, T_, H, hd, causal, window)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * B * S * H * hd
                                             + 2 * B * T_ * KV * hd)
    peak = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_inputs(gen, dev, S, T_, H, KV, hd, dt):
    return [torch.randn(shape, generator=gen, device=dev).to(dt)
            for shape in ((1, S, H, hd), (1, T_, KV, hd), (1, T_, KV, hd))]


def _flash_route(dtype, hd) -> str:
    """The route flash attention takes at this dtype (which
    :func:`_flash_check` asserts), and for the tensor-core kernel its
    registers, spills and shared memory per block at this head dim."""
    dt = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype)
    if dt is None:
        return "route=CUDA cores"
    use = FLASH_TC_PTXAS.get((dt, hd))
    smem = build.load_library().repro_flash_attention_tc_smem(hd)
    regs = (f"{use['registers']} registers, {use['spills'][0]}/"
            f"{use['spills'][1]} bytes spilled/reloaded" if use
            else "registers not in this run's build log")
    return f"route=tensor cores ({regs}, {smem} bytes smem/block)"


def _flash_check(what, q, k, v, causal=True, window=None) -> float:
    """The kernel against its plain version at the tolerances of
    tests/test_kernels.py; returns the largest error.  Checks that the
    dtype's route served the launch."""
    counts = (K.flash_attention.tc_launches,
              K.flash_attention.cuda_core_launches)
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tc = q.dtype != torch.float32
    if (K.flash_attention.tc_launches, K.flash_attention.cuda_core_launches
            ) != (counts[0] + tc, counts[1] + (not tc)):
        raise AssertionError(f"flash_attention {what}: {q.dtype} did not "
                             f"take the {'tensor' if tc else 'CUDA'}-core "
                             f"route")
    # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16 (and f16)
    t = 2e-5 if q.dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(
        got.float(), want.float(), rtol=t, atol=t,
        msg=lambda m: f"flash_attention {what}: {m}")
    return err


def _flash_path_shape(what, q, k, v, window=None) -> dict:
    """A main-path shape (bf16, causal): checked against the plain version
    and against the plain version on f32 copies, then timed beside the
    plain version, SDPA and the bound."""
    err = _flash_check(what, q, k, v, window=window)
    # the plain version rounds p to bf16 once before the PV product and the
    # kernel splits it into hi = rn(p) and lo = rn(p - hi), so 2e-2 is
    # loose at long rows (|o| ~ 0.05 at S=2048); against the plain version
    # on f32 copies (no rounding but the inputs') the kernel is held to
    # about one bf16 ulp of o
    got = K.flash_attention(q, k, v, window=window)
    want32 = R.flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=window)
    err32 = float((got.float() - want32).abs().max())
    torch.testing.assert_close(
        got.float(), want32, rtol=FLASH_F32_RTOL, atol=FLASH_F32_ATOL,
        msg=lambda m: f"flash_attention {what} vs f32 copies: {m}")
    ms = time_ms(lambda: K.flash_attention(q, k, v, window=window))
    plain = time_ms(lambda: R.flash_attention_ref(q, k, v, window=window))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # the window is no shorter than the sequence at the timed shapes, so
    # a causal SDPA computes the same function
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    (_, S, H, hd), KV = q.shape, k.shape[2]
    bound, by = flash_bound(1, S, S, H, KV, hd, q.dtype, True, window)
    tflops = flash_flops(1, S, S, H, hd, True, window) / ms / 1e9
    print(f"kernel flash_attention {what} q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} causal: max_abs_err={err:.3e} (vs f32 copies "
          f"{err32:.3e}, max |o| {float(want32.abs().max()):.3f}) "
          f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bound:.5f} ({by}) {tflops:.1f} TFLOP/s; "
          f"{_flash_route(q.dtype, hd)}")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err}


def phase_flash(dev) -> dict:
    """Flash attention against its plain version at tinyllama's prefill
    shapes and at off-path cases; timed per launch at the path's shapes.
    Returns the numbers at S=2048, the largest prefill, with the largest
    error over all path shapes."""
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {S: _flash_path_shape(f"bf16 S={S}", *_flash_inputs(
        gen, dev, S, S, 32, 4, 64, torch.bfloat16)) for S in FLASH_SEQS}
    for what, S, T_, H, KV, hd, dt, causal, window in (
            ("f32", 129, 129, 32, 4, 64, torch.float32, True, None),
            ("f16", 1000, 1000, 32, 4, 64, torch.float16, True, None),
            ("hd 128", 1000, 1000, 16, 2, 128, torch.bfloat16, True, None),
            ("window 128", 1000, 1000, 32, 4, 64, torch.bfloat16, True, 128),
            ("non-causal", 129, 300, 32, 4, 64, torch.bfloat16, False, None)):
        err = _flash_check(what, *_flash_inputs(gen, dev, S, T_, H, KV, hd,
                                                dt),
                           causal=causal, window=window)
        print(f"kernel flash_attention {what} (S={S}, T={T_}, H={H}, "
              f"KV={KV}, hd={hd}): max_abs_err={err:.3e} within tolerance; "
              f"{_flash_route(dt, hd)}")
    main = dict(res[max(FLASH_SEQS)])
    main["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return main


def phase_flash_recurrentgemma(dev) -> float:
    """Flash attention at recurrentgemma-9b's local attention: 16 query
    heads over 1 KV head at hd 256, window 2048, at the prefill lengths and
    past the window.  Returns the largest error against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = get_config(RG_ARCH)
    H, KV, hd, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    errs = [_flash_path_shape(
        f"bf16 S={S} window {w}",
        *_flash_inputs(gen, dev, S, S, H, KV, hd, torch.bfloat16),
        window=w)["max_abs_err"] for S in (1, 129, 1984, 2048)]
    for dt in (torch.bfloat16, torch.float32):
        err = _flash_check(f"S=3000 window {w} {dt}", *_flash_inputs(
            gen, dev, 3000, 3000, H, KV, hd, dt), window=w)
        errs.append(err)
        print(f"kernel flash_attention S=3000 past the window {w} "
              f"(H={H}, KV={KV}, hd={hd}, {dt}): max_abs_err={err:.3e} "
              f"within tolerance; {_flash_route(dt, hd)}")
    return max(errs)


def phase_rglru(dev) -> dict:
    """The RG-LRU kernel against its plain version at recurrentgemma-9b's
    prefill shapes and at off-path cases; timed at S=2048 beside its plain
    version and its bound."""
    gen = torch.Generator(device=dev).manual_seed(3)
    L = get_config(RG_ARCH).recurrent.lru_width

    def inputs(B, S, L, dt, lam_dt=None, extreme=False):
        # with ``extreme``: r = 1 (a = exp(-8 softplus(lam)), about e^-48
        # at lam = 6) and r = 0 (a = 1) at scattered entries, lam = 6 on
        # every other channel
        x = torch.randn(B, S, L, generator=gen, device=dev)
        r = torch.rand(B, S, L, generator=gen, device=dev)
        i = torch.rand(B, S, L, generator=gen, device=dev)
        lam = torch.linspace(2.0, 6.0, L, device=dev)
        if extreme:
            pick = torch.randint(0, 4, r.shape, generator=gen, device=dev)
            r = r.masked_fill(pick == 0, 1.0).masked_fill(pick == 1, 0.0)
            lam[1::2] = 6.0
        return x.to(dt), r.to(dt), i.to(dt), lam.to(lam_dt or dt)

    def check(what, args) -> float:
        got = K.rglru_scan(*args)
        want = R.rglru_ref(*args)
        torch.cuda.synchronize()
        # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16
        t = 2e-5 if got.dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t,
                                   msg=lambda m: f"rglru_scan {what}: {m}")
        return err

    errs = {}
    for S in RG_SEQS:
        args = inputs(1, S, L, torch.bfloat16)
        errs[S] = check(f"bf16 S={S}", args)
        print(f"kernel rglru_scan bf16 (1,{S},{L}): max_abs_err="
              f"{errs[S]:.3e} within 2e-2")
    for what, B, S, Lw, dt, lam_dt in (
            ("f32", 1, 1024, L, torch.float32, None),
            ("B=2", 2, 300, L, torch.bfloat16, None),
            ("L=1000", 1, 129, 1000, torch.bfloat16, torch.float32),
            ("f32 B=2 L=1000", 2, 129, 1000, torch.float32, torch.bfloat16)):
        err = check(what, inputs(B, S, Lw, dt, lam_dt))
        print(f"kernel rglru_scan {what} ({B},{S},{Lw}) {dt}: max_abs_err="
              f"{err:.3e} within tolerance")
    # either side of the kernel's chunk, and decays at their extremes
    C = RGLRU_CHUNK
    for what, B, S, Lw, dt, lam_dt, extreme in (
            *((f"S=C{d:+d}", 2, C + d, L, torch.bfloat16, None, False)
              for d in (-1, 0, 1)),
            ("S=2C+1", 2, 2 * C + 1, L, torch.float32, None, False),
            ("extreme decays", 2, 2 * C + 1, 1000, torch.float32, None,
             True),
            ("extreme decays", 2, 2 * C + 1, 1000, torch.bfloat16,
             torch.float32, True),
            ("extreme decays", 1, max(RG_SEQS), L, torch.bfloat16, None,
             True)):
        args = inputs(B, S, Lw, dt, lam_dt, extreme)
        err = check(f"{what} {dt}", args)
        print(f"kernel rglru_scan {what} ({B},{S},{Lw}) {dt}, lam "
              f"{args[3].dtype}: max_abs_err={err:.3e} within tolerance")
    args = inputs(1, max(RG_SEQS), L, torch.bfloat16)
    ms = time_ms(lambda: K.rglru_scan(*args))
    launches = cuda_launches(lambda: K.rglru_scan(*args))
    scratch = K.rglru_scan_scratch_bytes(*args[0].shape)
    plain = time_ms(lambda: R.rglru_ref(*args), reps=5)
    n = args[0].numel()
    nbytes = 4 * n * args[0].element_size() + L * args[3].element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = RGLRU_OPS_PER_ELEM * n / F32_FLOP_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel rglru_scan bf16 (1,{max(RG_SEQS)},{L}): ms={ms:.4f} "
          f"plain_ms={plain:.4f} "
          f"bound_ms={bound:.5f} ({by}, {nbytes / 1e6:.1f} MB) "
          f"library_ms=none; {launch_line(launches)} "
          f"scratch_bytes={scratch}")
    return {"ms": ms, "plain_ms": plain, "library_ms": None,
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(errs.values())}


def phase_wkv6(dev) -> dict:
    """The WKV-6 kernel against its plain version, output and final state,
    at rwkv6-3b's prefill shapes and at off-path cases; timed at S=2048
    beside its plain version and its bound."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = get_config(RWKV_ARCH)
    H, hd = cfg.n_heads, cfg.hd

    def inputs(B, S, H, hd, dt, w_dt=torch.float32, extreme=False):
        # decays exp(-exp(-2 + noise)) near 0.87, as the model's w0 = -2
        # gives them; with ``extreme``, also w = 0, 1e-40 (denormal in
        # f32) and 1 at scattered (step, key) entries
        r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            B, S, H, hd, generator=gen, device=dev)))
        if extreme:
            pick = torch.randint(0, 8, w.shape, generator=gen, device=dev)
            w = (w.masked_fill(pick == 0, 0.0).masked_fill(pick == 1, 1e-40)
                 .masked_fill(pick == 2, 1.0))
        u = 0.1 * torch.randn(H, hd, generator=gen, device=dev)
        return r, k, v, w.to(w_dt), u

    def check(what, args) -> float:
        out, final = K.rwkv6_wkv(*args)
        want, want_final = R.rwkv6_ref(*args)
        torch.cuda.synchronize()
        # tests/test_kernels.py::test_rwkv6: 5e-4 for f32, 5e-2 for bf16
        t = 5e-4 if out.dtype == torch.float32 else 5e-2
        for name, got, ref in (("out", out, want),
                               ("final state", final, want_final)):
            torch.testing.assert_close(
                got.float(), ref.float(), rtol=t, atol=t,
                msg=lambda m: f"rwkv6_wkv {what} {name}: {m}")
        err = float((out.float() - want.float()).abs().max())
        err_s = float((final - want_final).abs().max())
        print(f"kernel rwkv6_wkv {what} {tuple(args[0].shape)} w "
              f"{args[3].dtype}: max_abs_err out {err:.3e} (max |out| "
              f"{float(want.float().abs().max()):.2f}), final state "
              f"{err_s:.3e} (max |S| {float(want_final.abs().max()):.2f}), "
              f"within {t}")
        return max(err, err_s)

    errs = [check(f"bf16 S={S}", inputs(1, S, H, hd, torch.bfloat16))
            for S in WKV_SEQS]
    for what, B, S, Hh, d, dt, w_dt in (
            ("f32", 1, 2048, H, hd, torch.float32, torch.float32),
            ("w in bf16", 1, 129, H, hd, torch.bfloat16, torch.bfloat16),
            ("f16", 1, 129, H, hd, torch.float16, torch.float32),
            ("B=2 hd 32", 2, 300, 4, 32, torch.bfloat16, torch.float32),
            ("hd 128", 1, 200, 2, 128, torch.float32, torch.float32)):
        check(what, inputs(B, S, Hh, d, dt, w_dt))
    # either side of the kernel's chunk of 4096/hd steps, and decays at
    # their extremes
    for d in (32, 64, 128):
        C = WKV_CHUNK_ELEMS // d
        Hh = H if d == hd else 4
        for S in (C - 1, C, C + 1, 2 * C + 1):
            check(f"S={S} (C={C}) f32", inputs(2, S, Hh, d, torch.float32))
        check(f"S={2 * C + 1} (C={C}) w in bf16",
              inputs(2, 2 * C + 1, Hh, d, torch.bfloat16, torch.bfloat16))
        for dt, w_dt in ((torch.float32, torch.float32),
                         (torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            check(f"extreme decays S={2 * C + 1} (C={C}) {dt}",
                  inputs(2, 2 * C + 1, Hh, d, dt, w_dt, extreme=True))
    check("extreme decays bf16 S=2048", inputs(
        1, max(WKV_SEQS), H, hd, torch.bfloat16, extreme=True))
    args = inputs(1, max(WKV_SEQS), H, hd, torch.bfloat16)
    ms = time_ms(lambda: K.rwkv6_wkv(*args))
    launches = cuda_launches(lambda: K.rwkv6_wkv(*args))
    scratch = K.rwkv6_wkv_scratch_bytes(*args[0].shape)
    plain = time_ms(lambda: R.rwkv6_ref(*args), reps=3, warmup=1)
    r, k, v, w, u = args
    n = r.numel()
    nbytes = (4 * n * r.element_size() + n * w.element_size()
              + 4 * u.numel() + 4 * H * hd * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = WKV_OPS_PER_ENTRY * n * hd / F32_FLOP_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel rwkv6_wkv bf16 {tuple(r.shape)}, f32 w: ms={ms:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bound:.5f} ({by}; "
          f"{nbytes / 1e6:.1f} MB in {t_bytes * 1e3:.5f} ms, "
          f"{WKV_OPS_PER_ENTRY * n * hd / 1e9:.2f} GFLOP in "
          f"{t_ops * 1e3:.5f} ms) library_ms=none; "
          f"{launch_line(launches)} scratch_bytes={scratch}")
    return {"ms": ms, "plain_ms": plain, "library_ms": None,
            "bound_ms": bound, "bound_by": by, "max_abs_err": max(errs)}


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


def _mixed_strategy(strat) -> TS.GradSyncStrategy:
    """``strat``'s buckets with each bucket's (fused, kind, chunks) taken
    from :data:`B1_PATTERN` in turn."""
    pat = [B1_PATTERN[i % len(B1_PATTERN)] for i in range(len(strat.buckets))]
    return TS.GradSyncStrategy(strat.buckets, comms=[p[1] for p in pat],
                               chunks=[p[2] for p in pat],
                               fused=[p[0] for p in pat])


def implied_counts(strat, leaves, steps: int) -> tuple[dict, dict]:
    """Sync-kernel launches and collective calls that ``steps`` steps of
    ``strat`` make at dp=1: a bucket pack per unfused bucket; a fused pack
    and unpack per fused one; a convert-copy per unfused bucket whose
    leaves are all bf16 (its cast back) and per bf16 gradient after the
    sync (the optimizer's f32 upcast); per chunk, an all-reduce for an
    unfused ``ar`` bucket, else a reduce-scatter and an all-gather."""
    sizes = [p.numel() for p in leaves]
    n_fused = sum(strat.is_fused(bi) for bi in range(len(strat.buckets)))
    synced_dt = {}      # each leaf's dtype after the sync
    cast_back = 0       # all-bf16 unfused buckets, cast back by convert_copy
    calls = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for bi, b in enumerate(strat.buckets):
        dt = functools.reduce(torch.promote_types,
                              [leaves[i].dtype for i in b])
        for i in b:
            synced_dt[i] = leaves[i].dtype if strat.is_fused(bi) else dt
        cast_back += (not strat.is_fused(bi)) and dt != torch.float32
        k = min(strat.chunk_count(bi), sum(sizes[i] for i in b))
        if strat.comm_kind(bi) == "ar" and not strat.is_fused(bi):
            calls["all_reduce"] += k * steps
        else:
            calls["reduce_scatter"] += k * steps
            calls["all_gather"] += k * steps
    launches = {"bucket_pack": (len(strat.buckets) - n_fused) * steps,
                "fused_pack": n_fused * steps,
                "fused_unpack": n_fused * steps,
                "convert_copy": (cast_back + sum(
                    dt != torch.float32 for dt in synced_dt.values()))
                * steps}
    return launches, calls


def check_bucket_pack(strat, grads) -> float:
    """The bucket-pack kernel bitwise against its plain version on every
    unfused bucket of ``strat``, packing ``grads`` into f32 as the sync
    does.  Returns the largest absolute error."""
    err = 0.0
    for bi, b in enumerate(strat.buckets):
        if strat.is_fused(bi):
            continue
        ls = [grads[i] for i in b]
        total = sum(l.numel() for l in ls)
        err = max(err, check_equal(
            f"bucket_pack bucket {bi} ({len(ls)} leaves, {total} elements)",
            [K.bucket_pack(ls, total, torch.float32)],
            [R.bucket_pack_ref(ls, total, torch.float32)]))
    return err


def check_sync(dev, strat, steps: int, batch: int, seq: int) -> None:
    """``steps`` AdamW steps of full tinyllama-1.1b at ``batch`` x ``seq``
    whose gradients ``strat`` syncs, each step's synced gradients bitwise
    against an all-fused sync (2 chunks) of the same gradients: at dp=1
    both are exact casts, so this holds every pack, cast back and unpack
    of ``strat`` at the main path's shapes."""
    nb = len(strat.buckets)
    fused = TS.GradSyncStrategy(strat.buckets, comms=["ar"] * nb,
                                chunks=[CHUNKS] * nb, fused=[1] * nb)
    cfg = get_config(ARCH)
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    plist = ST.leaves(params)
    opt_init, opt_update = adamw(1e-3, weight_decay=0.01)
    opt = opt_init(plist)
    tgen = torch.Generator(device=dev).manual_seed(7)
    created = TRAIN.init_process_group(dev)
    try:
        for step in range(steps):
            tokens = torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=tgen, device=dev)
            for p in plist:
                p.requires_grad_(True)
            loss = ST.loss_fn(params, cfg, {"tokens": tokens}, remat=True)
            grads = torch.autograd.grad(loss, plist)
            got = TS.sync_grads([g.clone() for g in grads], strat)
            want_g = TS.sync_grads([g.clone() for g in grads], fused)
            n_f32 = sum(g.dtype != w.dtype for g, w in zip(got, want_g))
            check_equal(f"step {step} synced gradients against the "
                        f"all-fused sync",
                        [g.float() for g in got],
                        [w.float() for w in want_g])
            print(f"step {step}: loss {float(loss.detach()):.4f}; "
                  f"{len(got)} synced gradients bitwise equal to the "
                  f"all-fused sync ({n_f32} come back as f32 views of a "
                  f"mixed bucket)")
            with torch.no_grad():
                for p in plist:
                    p.requires_grad_(False)
                clipped, _ = clip_by_global_norm(got, 1.0)
                updates, opt = opt_update(clipped, opt, plist)
                apply_updates(plist, updates)
            del grads, got, want_g
    finally:
        if created:
            dist.destroy_process_group()
    del params, plist, opt
    torch.cuda.empty_cache()


def phase_unfused_buckets(dev, tmp: str, strat, leaves) -> tuple[dict, int]:
    """The bucket-pack kernel bitwise against its plain version and timed;
    the launcher's run with unfused buckets, its launches counted; each
    step's synced gradients against an all-fused sync of the same
    gradients.  Returns the kernel's numbers and its launches in the run."""
    mixed = _mixed_strategy(strat)
    unfused = [bi for bi in range(len(strat.buckets)) if not mixed.is_fused(bi)]
    gen = torch.Generator(device=dev).manual_seed(6)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": check_bucket_pack(mixed, grads)}
    nbytes = 0
    for bi in unfused:
        ls = [grads[i] for i in strat.buckets[bi]]
        total = sum(l.numel() for l in ls)
        res["ms"] += time_ms(lambda: K.bucket_pack(ls, total))
        res["plain_ms"] += time_ms(lambda: R.bucket_pack_ref(ls, total))
        buf = torch.empty(total, dtype=torch.float32, device=dev)
        flat = [l.reshape(-1) for l in ls]
        res["library_ms"] += time_ms(lambda: torch.cat(flat, out=buf))
        nbytes += sum(l.numel() * l.element_size() for l in ls) + 4 * total
        del buf, flat
    # padding case: odd sizes, mixed dtypes, a pad to `total`, and each out
    # dtype; one leaf at a 2-byte offset (the scalar path)
    sizes = [17, 1000003, 5, 65537, 3]
    odd = [torch.randn(n + 1, generator=gen, device=dev).mul_(1.0001).to(dt)
           for n, dt in zip(sizes, (torch.bfloat16, torch.float32,
                                    torch.float16, torch.bfloat16,
                                    torch.float32))]
    odd[0] = odd[0][1:]
    odd[1:] = [l[:-1] for l in odd[1:]]
    for out_dt in (torch.float32, torch.bfloat16, torch.float16):
        check_equal(f"bucket_pack padded to {out_dt}",
                    [K.bucket_pack(odd, sum(sizes) + 13, out_dt)],
                    [R.bucket_pack_ref(odd, sum(sizes) + 13, out_dt)])
    torch.cuda.synchronize()
    del grads, odd
    res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["bound_by"] = "bytes"
    print(f"kernel bucket_pack: bitwise equal to plain; per step at the "
          f"main path's {len(unfused)} unfused buckets ms={res['ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} "
          f"library_ms={res['library_ms']:.4f} (torch.cat into an f32 "
          f"buffer)")

    # the main path: the launcher, with unfused buckets
    plan = os.path.join(tmp, "mixed.json")
    mixed.save(plan)
    nb = len(strat.buckets)
    want, calls = implied_counts(mixed, leaves, B1_STEPS)
    torch.cuda.empty_cache()
    K.reset_launches()
    TS.reset_collectives()
    out = TRAIN.main(["--arch", ARCH, "--steps", str(B1_STEPS), "--batch",
                      str(B1_BATCH), "--seq", str(B1_SEQ), "--strategy-file",
                      plan, "--log-every", "1", "--device", "cuda"])
    launches = {name: getattr(K, name).launches for name in want}
    coll = dict(TS.COLLECTIVES)
    if launches != want:
        raise AssertionError(f"unfused-bucket run: launches {launches}, "
                             f"want {want}")
    if coll != calls:
        raise AssertionError(f"unfused-bucket run: collectives {coll}, "
                             f"want {calls}")
    if not all(math.isfinite(l) for l in out["losses"]):
        raise AssertionError(f"unfused-bucket run: losses {out['losses']}")
    print(f"training {ARCH} with {len(unfused)} unfused buckets (ar and "
          f"rs_ag at 1 and 3 chunks) and {nb - len(unfused)} fused: "
          f"{B1_STEPS} steps, batch {B1_BATCH} x seq {B1_SEQ}; losses "
          f"{out['losses']}; step time "
          f"{statistics.median(out['step_seconds'][1:]) * 1e3:.1f} ms; "
          f"launches {launches}; collectives {coll}")

    # each step's synced gradients, this strategy against an all-fused one
    # on the same gradients (at dp=1 both are exact casts)
    check_sync(dev, mixed, B1_CHECK_STEPS, B1_BATCH, B1_SEQ)
    return res, launches["bucket_pack"]


def phase_tensor_parallel(tmp: str, strat, leaves) -> None:
    """(v): ``--mesh single`` (layout "tp" at degree 1) against ``--mesh
    dp`` on full tinyllama-1.1b, each run's sync kernels and collectives
    counted, losses, gradient norms, step times and peaks printed."""
    mixed = _mixed_strategy(strat)
    path = os.path.join(tmp, "tp.json")
    mixed.save(path)
    want, calls = implied_counts(mixed, leaves, TP_STEPS)
    runs = {}
    for mesh in ("dp", "single"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        TS.reset_collectives()
        out = TRAIN.main(["--arch", ARCH, "--steps", str(TP_STEPS),
                          "--batch", str(BATCH), "--seq", str(SEQ),
                          "--strategy-file", path, "--log-every", "100",
                          "--device", "cuda", "--mesh", mesh])
        launches = {name: getattr(K, name).launches for name in want}
        coll = dict(TS.COLLECTIVES)
        if launches != want or coll != calls:
            raise AssertionError(f"--mesh {mesh}: launches {launches}, "
                                 f"collectives {coll}; want {want}, {calls}")
        vals = out["losses"] + out["grad_norms"]
        if len(out["losses"]) != TP_STEPS or not all(
                math.isfinite(v) for v in vals):
            raise AssertionError(f"--mesh {mesh}: {out}")
        runs[mesh] = dict(out, launches=launches, collectives=coll,
                          peak=torch.cuda.max_memory_allocated(),
                          step_s=statistics.median(out["step_seconds"][1:]))
    dp, tp = runs["dp"], runs["single"]
    gaps = {k: [abs(a - b) / abs(b) for a, b in zip(tp[k], dp[k])]
            for k in ("losses", "grad_norms")}
    for mesh, r in runs.items():
        print(f"tensor parallel {ARCH} --mesh {mesh} (batch {BATCH} x seq "
              f"{SEQ}): losses {r['losses']}, grad norms {r['grad_norms']}; "
              f"step {r['step_s'] * 1e3:.1f} ms (median of steps "
              f"2..{TP_STEPS}; first {r['step_seconds'][0] * 1e3:.1f} ms), "
              f"max_memory_allocated {r['peak'] / 2**30:.2f} GiB; launches "
              f"{r['launches']}; collectives {r['collectives']}; model "
              f"group's collectives {r['tp_collectives']}")
    print(f"tensor parallel: relative gaps tp against dp, losses "
          f"{['%.2e' % g for g in gaps['losses']]}, grad norms "
          f"{['%.2e' % g for g in gaps['grad_norms']]}; step "
          f"{tp['step_s'] / dp['step_s']:.4f}x, peak "
          f"{tp['peak'] / dp['peak']:.4f}x; card {card_line()}")
    if max(gaps["losses"]) > TP_LOSS_RTOL or \
            max(gaps["grad_norms"]) > TP_GNORM_RTOL:
        raise AssertionError(f"tp against dp: relative gaps {gaps} over "
                             f"{TP_LOSS_RTOL} / {TP_GNORM_RTOL}")


def phase_search(dev, tmp: str, leaves) -> tuple[float, float]:
    """The search path: ``train.main --strategy auto`` traces full
    tinyllama-1.1b on meta tensors, searches it priced for an H100 on
    ``h100_superpod`` and enacts the searched Plan on the card.  Counters
    are zeroed just before and read just after; they must equal what the
    Plan implies.  Then the Plan's unfused buckets are packed by the kernel
    and its plain version, and one step's sync through the Plan is held
    bitwise against an all-fused sync.  Returns bucket_pack's largest
    error and the median step in seconds."""
    path = os.path.join(tmp, "searched.json")
    torch.cuda.empty_cache()
    K.reset_launches()
    TS.reset_collectives()
    out = TRAIN.main(["--arch", ARCH, "--strategy", "auto", "--cluster",
                      SEARCH_CLUSTER, "--batch", str(BATCH), "--seq",
                      str(SEQ), "--steps", str(STEPS), "--plan-out", path,
                      "--log-every", "1", "--device", "cuda"])
    launches = {name: getattr(K, name).launches
                for name in ("bucket_pack",) + SYNC_KERNELS}
    coll = dict(TS.COLLECTIVES)
    plan, losses = out["plan"], out["losses"]
    prov = plan.provenance
    if len(losses) != STEPS or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"search path: losses not finite: {losses}")
    covered = sorted(i for b in plan.buckets for i in b)
    if covered != list(range(len(leaves))):
        raise AssertionError(f"searched buckets {plan.buckets} do not "
                             f"cover the {len(leaves)} leaves once each")
    strat = plan.grad_sync(leaves)
    want, calls = implied_counts(strat, leaves, STEPS)
    if launches != want or coll != calls:
        raise AssertionError(f"search path: launches {launches}, "
                             f"collectives {coll}; the Plan implies "
                             f"{want}, {calls}")
    loaded = RP.Plan.load(path)
    if loaded != plan:
        raise AssertionError("the saved Plan does not load as it was")
    read = TS.GradSyncStrategy.load(path, params=leaves)
    if dataclasses.asdict(read) != dataclasses.asdict(strat):
        raise AssertionError(f"GradSyncStrategy.load read {read}, the "
                             f"Plan lowers to {strat}")
    trace, sim_s = prov["trace"], prov["search_wall_time"]
    if trace["wall_time"] + sim_s > SEARCH_LIMIT_S:
        raise AssertionError(f"trace {trace['wall_time']:.1f} s + search "
                             f"{sim_s:.1f} s exceed {SEARCH_LIMIT_S} s")
    print(f"search path {ARCH} (batch {BATCH} x seq {SEQ}) on "
          f"{SEARCH_CLUSTER}: {trace['prims']} prims {trace['by_category']};"
          f" trace {trace['wall_time']:.2f} s, search {sim_s:.3f} s, "
          f"{prov['steps']} steps, {prov['simulations']} simulations; "
          f"simulated {prov['initial_cost'] * 1e3:.3f} -> "
          f"{prov['best_cost'] * 1e3:.3f} ms")
    for bi, b in enumerate(strat.buckets):
        print(f"  bucket {bi}: leaves {b} {strat.comm_kind(bi)} x "
              f"{strat.chunk_count(bi)} chunks, "
              f"{'fused' if strat.is_fused(bi) else 'unfused'}")
    step_s = statistics.median(out["step_seconds"][1:])
    ct = prov["compute_time"]
    print(f"predicted dp=1 compute time {ct['best'] * 1e3:.1f} ms (the "
          f"searched op fusion; {ct['initial'] * 1e3:.1f} ms unfused) "
          f"against a measured median step of {step_s * 1e3:.1f} ms "
          f"(steps 2..{STEPS}); the step runs with remat and AdamW, the "
          f"trace with neither")
    print(f"one CUDA launch: {PROF.launch_cost(dev) * 1e6:.2f} us of host "
          f"time measured, H100_SXM.launch_overhead "
          f"{H100_SXM.launch_overhead * 1e6:.2f} us")
    print(f"search path: losses {losses}; launches {launches}; collectives "
          f"{coll}")
    # the kernels at the Plan's own buckets: bucket_pack on seeded
    # gradients, then one step's sync against an all-fused sync
    gen = torch.Generator(device=dev).manual_seed(8)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    err = check_bucket_pack(strat, grads)
    del grads
    n_unfused = sum(not strat.is_fused(bi)
                    for bi in range(len(strat.buckets)))
    print(f"bucket_pack bitwise equal to plain on the Plan's {n_unfused} "
          f"unfused buckets (max abs err {err})")
    check_sync(dev, strat, 1, BATCH, SEQ)
    return err, step_s


class _CountingOracle(OracleEstimator):
    """The oracle estimator, counting its queries: a compile that answers
    from the plan cache makes none (its cache key stays the oracle's)."""

    def __init__(self, hw):
        super().__init__(hw)
        self.queries = 0

    def group_time(self, g, gid):
        self.queries += 1
        return super().group_time(g, gid)


def _rel_errors(model, samples) -> np.ndarray:
    pred = GNN.predict_times(model, samples)
    true = np.array([s[3] for s in samples])
    return np.abs(pred - true) / true


def phase_estimator(dev, tmp: str, leaves, step_s: float) -> float:
    """DisCo's cost model on the card: ``calibrate_hw`` fits the card's
    peak, bandwidth and launch cost; full tinyllama-1.1b's step, traced as
    in the search path, is simulated under the fit and under ``H100_SXM``
    beside the measured step (the paper's Table 2); the GNN is trained on
    the card on tier A fused groups of that graph (the reference's fig11
    settings) and held against its CPU forward; the step is searched with
    the GNN as the cost model and with the oracle, the GNN's Plan scored
    by the oracle beside the paper's baselines (Fig. 6, Fig. 11) and
    enacted through ``train.main --strategy-file`` with its kernels and
    collectives counted; tier B fused ops are compiled and timed on the
    card and the GNN's held-out error on them printed (Fig. 9); and a
    cached compile replays with no query.  Returns bucket_pack's largest
    error on the GNN Plan's unfused buckets."""
    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the GNN's card-against-CPU check "
                             "assumes f32 matmuls")
    cal = PROF.calibrate_hw(dev)
    h = H100_SXM
    print(f"calibrated {cal.name}: peak {cal.peak_flops / 1e12:.1f} TFLOP/s "
          f"(bf16 matmul 8192^3; H100_SXM {h.peak_flops / 1e12:.1f} x "
          f"efficiency {h.efficiency}), read+write "
          f"{cal.hbm_bw / 1e12:.3f} TB/s (H100_SXM {h.hbm_bw / 1e12:.3f}), "
          f"launch {cal.launch_overhead * 1e6:.2f} us of host time "
          f"(H100_SXM {h.launch_overhead * 1e6:.2f})")

    cfg = get_config(ARCH)
    t = time.time()
    g = RP.trace_model_graph(cfg, batch=BATCH, seq=SEQ, reduced=False,
                             hw=cal)
    trace_s = time.time() - t
    sim_cal = Simulator(hw=cal, n_devices=1).run(g).iteration_time
    sim_h100 = Simulator(hw=h, n_devices=1).run(
        profile_graph(g, h)).iteration_time
    print(f"Table 2, {ARCH} batch {BATCH} x seq {SEQ} ({len(g.prims)} "
          f"prims, traced in {trace_s:.1f} s): simulated dp=1 step "
          f"{sim_cal * 1e3:.1f} ms calibrated, {sim_h100 * 1e3:.1f} ms "
          f"under H100_SXM, measured {step_s * 1e3:.1f} ms (phase (j)): "
          f"{(sim_cal / step_s - 1) * 100:+.1f}% and "
          f"{(sim_h100 / step_s - 1) * 100:+.1f}%")

    # tier A: oracle-labelled fused groups of the traced step
    corpus = PROF.sample_fused_groups(g, EST_SAMPLES, random.Random(0),
                                      max_members=16, hw=cal)
    gcfg = GNN.GNNConfig(n_layers=2, n_heads=4, head_dim=16, mlp_dim=64)
    t = time.time()
    model, losses = GNN.train(corpus, gcfg, epochs=EST_EPOCHS,
                              batch_size=32, seed=0, device=dev)
    train_s = time.time() - t
    if not losses[-1] < losses[0] * 0.5:
        raise AssertionError(f"GNN training loss did not fall: {losses}")
    feats = [torch.from_numpy(np.stack([s[k] for s in corpus]))
             for k in range(3)]
    with torch.no_grad():
        on_card = GNN.forward_batch(model, *[f.to(dev) for f in feats])
        on_cpu = GNN.forward_batch(copy.deepcopy(model).cpu(), *feats)
    fwd_err = float((on_card.cpu() - on_cpu).abs().max())
    if not fwd_err <= 1e-5:
        raise AssertionError(f"GNN forward on the card is {fwd_err} from "
                             f"the CPU's in log-time")
    rel = _rel_errors(model, corpus)
    print(f"tier A: {len(corpus)} fused groups of the traced step; GNN "
          f"{gcfg} trained on the card in {train_s:.1f} s, loss "
          f"{losses[0]:.3f} -> {losses[-1]:.4f}; forward on the card "
          f"within {fwd_err:.2e} of the CPU's (log-time); training-set "
          f"error p50 {np.percentile(rel, 50):.3f}")

    # search priced by the GNN and by the oracle, both scored by the oracle
    spec = get_preset(SEARCH_CLUSTER)
    gnn = GNN.GNNEstimator(model, gcfg, device=dev)
    oracle_sim = Simulator(hw=cal, cluster=spec)
    kw = dict(graph=g, cluster=spec, hw=cal, unchanged_limit=80, seed=0)
    plan_o = RP.compile(**kw)
    plan_g = RP.compile(estimator=gnn, **kw)
    true_g = oracle_sim.cost(plan_g.to_graph(g))
    best_o = oracle_sim.cost(plan_o.to_graph(g))
    for name, pl in (("oracle", plan_o), ("GNN", plan_g)):
        pv = pl.provenance
        print(f"search with the {name}: {pv['search_wall_time']:.3f} s, "
              f"{pv['steps']} steps, {pv['simulations']} simulations, "
              f"{len(pl.buckets)} buckets, priced "
              f"{pl.predicted_iteration_time * 1e3:.3f} ms")
    print(f"GNN estimator: {gnn.queries} queries, "
          f"{gnn.query_seconds / max(gnn.queries, 1) * 1e3:.3f} ms of host "
          f"time each (a batch-1 forward and a sync)")
    print(f"Fig. 11: the GNN's Plan scored by the oracle {true_g * 1e3:.3f} "
          f"ms against the oracle's {best_o * 1e3:.3f} ms: gap "
          f"{(true_g / best_o - 1) * 100:+.2f}%")
    base = evaluate_baselines(g, oracle_sim)
    rows = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in base.items())
    print(f"Fig. 6, priced by the oracle on {SEARCH_CLUSTER}: {rows}; "
          f"DisCo (oracle) {best_o * 1e3:.3f}; DisCo (GNN) "
          f"{true_g * 1e3:.3f} ms")

    # the GNN's Plan enacted on the card
    path = os.path.join(tmp, "gnn_plan.json")
    plan_g.save(path)
    if RP.Plan.load(path).estimator != "GNNEstimator":
        raise AssertionError("the saved Plan does not record the GNN")
    strat = TS.GradSyncStrategy.load(path, params=leaves)
    want, calls = implied_counts(strat, leaves, STEPS)
    torch.cuda.empty_cache()
    K.reset_launches()
    TS.reset_collectives()
    out = TRAIN.main(["--arch", ARCH, "--steps", str(STEPS), "--batch",
                      str(BATCH), "--seq", str(SEQ), "--strategy-file",
                      path, "--log-every", "1", "--device", "cuda"])
    launches = {name: getattr(K, name).launches for name in want}
    coll = dict(TS.COLLECTIVES)
    if launches != want or coll != calls:
        raise AssertionError(f"GNN Plan: launches {launches}, collectives "
                             f"{coll}; the Plan implies {want}, {calls}")
    if not all(math.isfinite(l) for l in out["losses"]):
        raise AssertionError(f"GNN Plan: losses {out['losses']}")
    gen = torch.Generator(device=dev).manual_seed(9)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    err = check_bucket_pack(strat, grads)
    del grads
    print(f"GNN Plan enacted: buckets {strat.buckets}; losses "
          f"{out['losses']}; step "
          f"{statistics.median(out['step_seconds'][1:]) * 1e3:.1f} ms; "
          f"launches {launches}; collectives {coll}; bucket_pack bitwise "
          f"on its unfused buckets")

    # tier B: fused ops compiled and timed on the card (Fig. 9, --measured)
    rec = {}
    measured = PROF.measured_fused_samples(
        TIER_B_SAMPLES, seed=0, max_nodes=TIER_B_NODES, dim=TIER_B_DIM,
        device=dev, record=rec)
    labels = [s[3] for s in measured]
    if rec["graphs"] != len(measured) or not all(
            math.isfinite(x) and x > 0 for x in labels):
        raise AssertionError(f"tier B: {rec['graphs']} graphs for "
                             f"{len(measured)} samples, labels {labels}")
    random.Random(0).shuffle(measured)
    n_tr = int(len(measured) * 0.85)
    bcfg = GNN.GNNConfig(n_layers=3, n_heads=4, head_dim=16, mlp_dim=64)
    model_b, losses_b = GNN.train(measured[:n_tr], bcfg, epochs=60,
                                  batch_size=32, seed=0, device=dev)
    rel = _rel_errors(model_b, measured[n_tr:])
    print(f"Fig. 9 tier B: {len(measured)} fused ops of up to "
          f"{TIER_B_NODES} ops on f32 ({TIER_B_DIM}, {TIER_B_DIM}), each "
          f"one graph; {min(labels) * 1e3:.3f}-{max(labels) * 1e3:.3f} ms "
          f"on the card; compile {rec['compile_s']:.1f} s, timing "
          f"{rec['time_s']:.1f} s; GNN {bcfg} on {n_tr}, loss "
          f"{losses_b[0]:.3f} -> {losses_b[-1]:.4f}; held-out "
          f"{len(rel)}: error p50 {np.percentile(rel, 50):.3f} p90 "
          f"{np.percentile(rel, 90):.3f} p95 {np.percentile(rel, 95):.3f}, "
          f"within 14%: {np.mean(rel < 0.14):.2f} (the paper: over 0.90 "
          f"on a GPU)")

    # the plan cache: the second compile is a hit that makes no query
    cdir = os.path.join(tmp, "plan-cache")
    first, second = _CountingOracle(cal), _CountingOracle(cal)
    cold = RP.compile(estimator=first, cache=cdir, **kw)
    hit = RP.compile(estimator=second, cache=cdir, **kw)
    if (hit.provenance["cache"]["outcome"] != "hit" or second.queries
            or hit != cold):
        raise AssertionError(f"plan cache: {hit.provenance['cache']}, "
                             f"{second.queries} queries on the second "
                             f"compile")
    print(f"plan cache: cold compile {first.queries} oracle queries, then "
          f"a hit with 0 in {hit.provenance['facade_wall_time']:.3f} s")
    wall = time.time() - t_phase
    if wall > ESTIMATOR_LIMIT_S:
        raise AssertionError(f"estimator phase took {wall:.1f} s, over "
                             f"{ESTIMATOR_LIMIT_S} s")
    print(f"estimator phase: {wall:.1f} s")
    return err


def _engine_requests(vocab: int, seed: int, lens, new: int) -> list:
    rng = np.random.default_rng(seed)
    return [ENG.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=new) for i, n in enumerate(lens)]


def phase_reduced_engine(dev, cfg, cell: Serving) -> None:
    """The reduced model (f32) served on the card against the same
    requests served on the CPU: equal greedy tokens."""
    rcfg = cfg.reduced()
    rcache = min(96, rcfg.window or 96)
    cpu_params = ST.init_params(rcfg, seed=0, device="cpu")
    outs = {}
    for name, p in (("cuda", T.map(lambda a: a.to(dev), cpu_params)),
                    ("cpu", cpu_params)):
        eng = ENG.ServeEngine(p, rcfg, max_slots=3, cache_len=rcache)
        for r in _engine_requests(rcfg.vocab, 3, cell.reduced_lens, 8):
            eng.submit(r)
        outs[name] = {r.rid: r.output for r in eng.run_to_completion()}
    n = len(cell.reduced_lens)
    if outs["cuda"] != outs["cpu"] or len(outs["cpu"]) != n:
        raise AssertionError(f"reduced engine: cuda {outs['cuda']} != cpu "
                             f"{outs['cpu']}")
    print(f"reduced {cell.arch} engine, {n} requests over 3 slots, cache "
          f"{rcache}: cuda greedy tokens equal cpu's "
          f"({sum(map(len, outs['cpu'].values()))} tokens)")


def phase_serving_checks(dev, params, cfg, cell: Serving) -> None:
    """The serving path's results against references: the engine on the
    card against the engine on the CPU (the reduced model, f32), and full
    ``prefill`` with the kernels against ``prefill`` without them, both
    held against a run with f32 weights."""
    phase_reduced_engine(dev, cfg, cell)

    def diffs(a, b) -> dict:
        """Largest |difference| of the k/v leaves and of the recurrent
        state leaves of two cache trees."""
        out = {"cache": 0.0, "state": 0.0}
        for (path, x), y in zip(T.leaves_with_paths(a), T.leaves(b)):
            kind = "cache" if path.endswith(("['k']", "['v']")) else "state"
            out[kind] = max(out[kind],
                            float((x.float() - y.float()).abs().max()))
        return out

    # the same weights in f32 (TF32 off): how far each bf16 path lies from
    # a run that rounds nowhere but in its inputs
    params32 = T.map(lambda a: a.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for S in cell.check_seqs:
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab, (1, S))).to(dev)
        with torch.no_grad():
            lk, ck = ST.prefill(params, cfg, toks, cell.cache_len,
                                use_kernels=True)
            lp, cp = ST.prefill(params, cfg, toks, cell.cache_len)
            l32, c32 = ST.prefill(params32, cfg32, toks, cell.cache_len)
            lk32, ck32 = ST.prefill(params32, cfg32, toks, cell.cache_len,
                                    use_kernels=True)
        if lk.shape != (1, cfg.vocab) or not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"prefill S={S}: logits {tuple(lk.shape)} "
                                 f"not finite or misshapen")
        diff = float((lk.float() - lp.float()).abs().max())
        dkp, dk32, dp32 = diffs(ck, cp), diffs(ck, c32), diffs(cp, c32)
        scale = diffs(c32, T.map(torch.zeros_like, c32))
        e_k = float((lk.float() - l32).abs().max())
        e_p = float((lp.float() - l32).abs().max())
        print(f"prefill {cell.arch} S={S}: max |logit| "
              f"{float(lp.abs().max()):.3f}, kernel vs dense max |diff| "
              f"{diff:.4e} (tolerance {cell.logit_tol}); against f32 "
              f"weights: logits kernel {e_k:.4e}, dense {e_p:.4e}; argmax "
              f"{int(lk.argmax())} / {int(lp.argmax())} / "
              f"{int(l32.argmax())} (kernel / dense / f32)")
        # in f32 the two paths differ only in the order of f32 sums, which
        # the bf16 model's own rounding does not swamp: a kernel fault shows
        # here at the scale of the logits
        e32 = float((lk32 - l32).abs().max())
        d32 = diffs(ck32, c32)
        print(f"prefill {cell.arch} S={S}, f32 weights: kernel vs dense max "
              f"|diff| logits {e32:.4e}, k/v {d32['cache']:.4e}, state "
              f"{d32['state']:.4e} (tolerance {F32_PATHS_TOL} each)")
        if not max(e32, d32["cache"], d32["state"]) <= F32_PATHS_TOL:
            raise AssertionError(f"prefill S={S}, f32 weights: kernel path "
                                 f"differs from dense by {e32} (logits), "
                                 f"{d32} (caches) > {F32_PATHS_TOL}")
        if cell.cache_tol is not None:
            print(f"prefill {cell.arch} S={S}: k/v cache max |entry| "
                  f"{scale['cache']:.3f}, kernel vs dense max |diff| "
                  f"{dkp['cache']:.4e} (tolerance {cell.cache_tol}); against "
                  f"f32 weights: kernel {dk32['cache']:.4e}, dense "
                  f"{dp32['cache']:.4e}")
            if not dkp["cache"] <= cell.cache_tol:
                raise AssertionError(f"prefill S={S}: kernel caches differ "
                                     f"from dense by {dkp['cache']} > "
                                     f"{cell.cache_tol}")
        if cell.state_tol is not None:
            names = sorted({p.rsplit("[", 1)[-1].strip("']")
                            for p, _ in T.leaves_with_paths(ck)} - {"k", "v"})
            print(f"prefill {cell.arch} S={S}: recurrent state "
                  f"({', '.join(names)}) max |entry| {scale['state']:.3f}, "
                  f"kernel vs dense max |diff| {dkp['state']:.4e} (tolerance "
                  f"{cell.state_tol}); against f32 weights: kernel "
                  f"{dk32['state']:.4e}, dense {dp32['state']:.4e}")
            if not dkp["state"] <= cell.state_tol:
                raise AssertionError(f"prefill S={S}: kernel recurrent "
                                     f"states differ from dense by "
                                     f"{dkp['state']} > {cell.state_tol}")
        if not diff <= cell.logit_tol:
            raise AssertionError(f"prefill S={S}: kernel logits differ from "
                                 f"dense by {diff} > {cell.logit_tol}")
        # the kernels (f32 probabilities, f32 recurrences) add no error of
        # their own to the bf16 model: the kernel path lies no further from
        # the f32 run than twice the dense bf16 path does
        if not e_k <= 2 * e_p:
            raise AssertionError(f"prefill S={S}: kernel path {e_k} from "
                                 f"the f32 run, dense path {e_p}")
        del ck, cp, c32, ck32
    del params32
    torch.cuda.empty_cache()

    for use_kernels in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                ST.prefill(params, cfg, toks, cell.cache_len,
                           use_kernels=use_kernels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"prefill {cell.arch} {toks.shape[1]} tokens, use_kernels="
              f"{use_kernels}: {statistics.median(times) * 1e3:.1f} ms "
              f"(median of 3, host clock, synced)")
    phase_prefill_trace(params, cfg, toks, cell.cache_len)
    phase_decode_trace(dev, params, cfg, cell.cache_len)


def _union_us(spans) -> float:
    """Length of the union of (start, end) spans, in their unit."""
    busy, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy


def phase_prefill_trace(params, cfg, toks, cache_len: int,
                        **stubs) -> None:
    """Where one prefill through the kernels spends the device's time, from
    ``torch.profiler`` (printed only): the device's busy time (the union of
    its activities) and the union of each kernel family's launches, so a
    launch that starts early and waits counts once.  ``stubs``: the
    prefill's ``prefix_emb`` or ``enc_frames``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            ST.prefill(params, cfg, toks, cache_len, use_kernels=True,
                       **stubs)
        torch.cuda.synchronize()
    kern = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"prefill {cfg.name} trace: the profiler recorded no device "
              f"time")
        return
    wall = max(b for _, _, b in kern) - min(a for _, a, _ in kern)
    parts = []
    for fam in ("wkv6", "rglru", "flash"):
        spans = [(a, b) for n, a, b in kern if fam in n]
        if spans:
            parts.append(f"{fam} {_union_us(spans) / 1e3:.2f} ms "
                         f"({len(spans)} launches)")
    print(f"prefill {cfg.name} {toks.shape[1]} tokens traced: device busy "
          f"{_union_us((a, b) for _, a, b in kern) / 1e3:.2f} ms of "
          f"{wall / 1e3:.2f} ms (first to last device activity); "
          + "; ".join(parts))


def phase_decode_trace(dev, params, cfg, cache_len: int,
                       steps: int = 5) -> None:
    """Where a decode step's time goes: ``decode_step`` over full slots
    (8 slots at positions 64..1856 of the cache), timed on the host clock,
    then traced with ``torch.profiler`` (printed only).  The idle
    share is read from the trace alone: the device's busy time (the union
    of its activities) over the span from the first one's start to the
    last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    caches = ST.init_cache(cfg, SLOTS, cache_len, device=dev)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=dev)
    pos = torch.arange(SLOTS, device=dev) * 256 + 64

    def run(n):
        # an MoE model's experts route each row alone, as in the engine
        with torch.no_grad():
            for _ in range(n):
                ST.decode_step(params, cfg, caches, tok, pos,
                               route_rows=cfg.moe is not None)
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
    busy = _union_us(spans)
    wall = spans[-1][1] - spans[0][0] if spans else 0.0
    idle = f"{100 * (1 - busy / wall):.1f}%" if wall else "not measured"
    print(f"decode step {cfg.name}, {SLOTS} slots: {host_ms:.2f} ms per "
          f"step (host "
          f"clock, 10 steps, synced); traced {steps} steps: device busy "
          f"{busy / 1e3 / steps:.2f} ms of {wall / 1e3 / steps:.2f} ms per "
          f"step (first to last device activity), idle {idle}, "
          f"{len(kern) // steps} device activities (kernels, copies, "
          f"fills) per step")
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


def _cell_requests(cfg, cell: Serving) -> list:
    """The cell's traffic: its workload's requests plus the extra prompts
    of 32 new tokens each."""
    wl = cell.workload
    reqs = WL.materialize_requests(wl, cfg.vocab)
    for r in _engine_requests(cfg.vocab, 1, cell.extra_prompts, 32):
        r.rid += len(wl.requests())
        reqs.append(r)
    for r in reqs:
        if len(r.prompt) + r.max_new_tokens > cell.cache_len - 1:
            raise AssertionError(f"request {r.rid} does not fit the cache")
    return reqs


def phase_serving(dev, params, cfg, cell: Serving, plan=None) -> tuple:
    """The serving path: the cell's requests through ``ServeEngine``, all
    submitted at once; with ``plan``, the engine the serving plan sets up
    (slots, decode batch, cache length, KV layout), else the default 8
    slots.  Returns the kernels' launches of that run, the engine's
    metrics and the peak memory in bytes."""
    reqs = _cell_requests(cfg, cell)
    if plan is None:
        eng = ENG.ServeEngine(params, cfg, max_slots=SLOTS,
                              cache_len=cell.cache_len)
    else:
        eng = ENG.ServeEngine(params, cfg, plan=plan)
        if eng.kv_layout != plan.kv_layout:
            raise AssertionError(f"engine kv_layout {eng.kv_layout}, the "
                                 f"plan's {plan.kv_layout}")
        if (eng.max_slots, eng.decode_batch, eng.cache_len) != (
                plan.slots, min(plan.decode_batch, plan.slots),
                cell.cache_len):
            raise AssertionError(
                f"engine {eng.max_slots} slots, batch {eng.decode_batch}, "
                f"cache {eng.cache_len}; the plan's {plan.slots}, "
                f"{plan.decode_batch}, {plan.cache_len}")
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
    flash_tc = K.flash_attention.tc_launches
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
    # each prefill runs flash attention once per attention layer, the
    # RG-LRU kernel once per RG-LRU layer and the WKV-6 kernel once per
    # RWKV layer; nothing else launches a kernel
    kinds = [cfg.block_kind(li) for li in range(cfg.n_layers)]
    want = {name: 0 for name in REPLACES}
    # MLA never takes the flash kernel, as in the reference
    want["flash_attention"] = (0 if cfg.block == "mla"
                               else kinds.count("attn") * len(reqs))
    want["rglru_scan"] = kinds.count("rec") * len(reqs)
    want["rwkv6_wkv"] = kinds.count("rwkv") * len(reqs)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, want {want} "
                             f"(one per layer of the kernel's kind per "
                             f"prefill)")
    # the cell serves bf16: every flash launch takes the tensor cores
    if flash_tc != want["flash_attention"]:
        raise AssertionError(f"serving: {flash_tc} of "
                             f"{want['flash_attention']} flash launches on "
                             f"the tensor-core route")
    m = eng.metrics()
    plens = [len(r.prompt) for r in reqs]
    print(f"serving {cell.arch}: {len(reqs)} requests (prompts "
          f"{min(plens)}-{max(plens)} tokens, {sum(plens)} in all), "
          f"{eng.max_slots} slots (decode batch {eng.decode_batch}, kv "
          f"{eng.kv_layout}), cache {eng.cache_len}, {cfg.dtype}; "
          f"{m['tokens']} tokens in {m['decode_steps']} decode steps, "
          f"{wall:.2f} s wall")
    print(f"serving metrics: ttft p50 {m['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{m['ttft_p99_s'] * 1e3:.1f} ms; tpot p50 "
          f"{m['tpot_p50_s'] * 1e3:.2f} ms, p99 {m['tpot_p99_s'] * 1e3:.2f} "
          f"ms; latency p50 {m['latency_p50_s']:.2f} s, p99 "
          f"{m['latency_p99_s']:.2f} s; {m['tokens_per_s']:.1f} tokens/s "
          f"over the span; max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"launches on the serving path: {launches}; flash on the "
          f"tensor-core route: {flash_tc} of {launches['flash_attention']}")
    return launches, m, peak


def _describe_buckets(plan) -> str:
    """A Plan's buckets: count, then (comm kind, chunks, fused) with how
    many buckets take each and their leaves in all."""
    kinds: dict = {}
    fused = plan.bucket_fused or (0,) * len(plan.buckets)
    for b, comm, chunks, fu in zip(plan.buckets, plan.bucket_comm,
                                   plan.bucket_chunks, fused):
        key = f"{comm} x{chunks}{' fused' if fu else ''}"
        n, leaves = kinds.get(key, (0, 0))
        kinds[key] = (n + 1, leaves + len(b))
    return f"{len(plan.buckets)} buckets: " + ", ".join(
        f"{n} {key} ({leaves} leaves)" for key, (n, leaves) in kinds.items())


def _loss_and_grads(loss_fn, leaves) -> tuple[float, list, float]:
    """One loss and its gradients on the card; returns the loss, the
    gradients and the seconds from the call to a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, time.perf_counter() - t0


def _global_norm(grads) -> float:
    return float(torch.sqrt(sum(g.float().square().sum() for g in grads)))


def phase_layers(dev, params, cfg) -> int:
    """The per-layer model at full width: its step traced on meta tensors
    (``model="layers"``) at each of ``LAYERS_DEPTHS`` and searched for
    ``SEARCH_CLUSTER`` under ``H100_SXM``; one loss and its gradients on the
    card (``remat``) against the stacked model's on the same weights, and
    ``LAYERS_STEPS`` more of each timed; a 2048-token prefill through the flash
    kernel, its launches counted, against the stacked model's prefill.
    Returns the prefill's flash launches."""
    from collections import Counter

    sims = {}
    for depth in LAYERS_DEPTHS:
        t0 = time.perf_counter()
        g = RP.trace_model_graph(cfg, batch=BATCH, seq=SEQ, model="layers",
                                 n_layers=depth, reduced=False, hw=H100_SXM)
        trace_s = time.perf_counter() - t0
        cats = dict(Counter(p.category for p in g.prims))
        with torch.device("meta"):
            want_leaves = len(T.leaves(M.init_params(
                dataclasses.replace(cfg, n_layers=depth), device="meta")))
        if cats.get(OPAQUE) or len(g.grad_prim) != want_leaves:
            raise AssertionError(f"per-layer trace at {depth} layers: "
                                 f"{cats}, {len(g.grad_prim)} gradient "
                                 f"leaves, want no opaque prim and "
                                 f"{want_leaves}")
        plan = RP.compile(graph=g, cluster=SEARCH_CLUSTER, hw=H100_SXM)
        prov = plan.provenance
        search_s = prov["facade_wall_time"]
        if depth == cfg.n_layers and trace_s + search_s > SEARCH_LIMIT_S:
            raise AssertionError(f"per-layer trace {trace_s:.1f} s + search "
                                 f"{search_s:.1f} s exceed {SEARCH_LIMIT_S} s")
        if sorted(i for b in plan.buckets for i in b) != list(
                range(want_leaves)):
            raise AssertionError(f"per-layer Plan at {depth} layers does "
                                 f"not cover the {want_leaves} leaves once")
        sim = plan.simulator()
        compute = (sim.run(g).compute_time,
                   sim.run(plan.to_graph(g)).compute_time)
        sims[depth] = compute
        fused = sum(len(grp) > 1 for grp in plan.groups)
        print(f"per-layer {ARCH} at {depth} layers (batch {BATCH} x seq "
              f"{SEQ}) on {SEARCH_CLUSTER}: {len(g.prims)} prims {cats}, "
              f"{len(g.grad_prim)} gradient leaves; trace {trace_s:.2f} s, "
              f"search {search_s:.2f} s ({prov['steps']} steps, "
              f"{prov['simulations']} simulations); simulated "
              f"{prov['initial_cost'] * 1e3:.3f} -> "
              f"{prov['best_cost'] * 1e3:.3f} ms; {fused} fused op groups; "
              f"{_describe_buckets(plan)}; dp=1 compute "
              f"{compute[0] * 1e3:.1f} ms unfused, {compute[1] * 1e3:.1f} "
              f"ms with the Plan's op fusion")

    # loss and gradients on the card, the per-layer model against the
    # stacked one on the same weights (the per-layer leaves are copies)
    gen = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), device=dev,
                           generator=gen)
    batch = {"tokens": tokens}
    st_leaves = ST.leaves(params)
    st_s = []
    for i in range(LAYERS_STEPS + 1):
        st_loss, st_grads, secs = _loss_and_grads(
            lambda: ST.loss_fn(params, cfg, batch, remat=True), st_leaves)
        if i == 0:
            st_norm = _global_norm(st_grads)
        else:
            st_s.append(secs)
        del st_grads
    per_layer = M.from_stacked(params, cfg)
    per_layer["layers"] = [T.map(torch.clone, p)
                           for p in per_layer["layers"]]
    leaves = T.leaves(per_layer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(LAYERS_STEPS + 1):
        loss, grads, secs = _loss_and_grads(
            lambda: M.loss_fn(per_layer, cfg, batch, remat=True), leaves)
        if i == 0:
            norm = _global_norm(grads)
        else:
            step_s.append(secs)
        del grads
    peak = torch.cuda.max_memory_allocated()
    if not (math.isfinite(loss) and abs(loss - st_loss)
            <= LAYERS_LOSS_RTOL * abs(st_loss)):
        raise AssertionError(f"per-layer loss {loss}, stacked {st_loss}")
    if abs(norm - st_norm) > LAYERS_GNORM_RTOL * st_norm:
        raise AssertionError(f"per-layer gradient norm {norm}, stacked "
                             f"{st_norm}")
    med = statistics.median(step_s)
    depth = cfg.n_layers
    print(f"per-layer loss and gradients on the card ({BATCH} x {SEQ}, "
          f"remat, {len(leaves)} leaves): loss {loss:.6f} (stacked "
          f"{st_loss:.6f}, rel {abs(loss - st_loss) / st_loss:.2e}), "
          f"gradient norm {norm:.6f} (stacked {st_norm:.6f}, rel "
          f"{abs(norm - st_norm) / st_norm:.2e}); median of "
          f"{LAYERS_STEPS} steps {med * 1e3:.1f} ms "
          f"({med * 1e3 / depth:.2f} ms a layer; stacked "
          f"{statistics.median(st_s) * 1e3:.1f} ms), peak "
          f"{peak / 2**30:.2f} GiB; simulated dp=1 compute of the "
          f"{depth}-layer graph {sims[depth][0] * 1e3:.1f} ms unfused "
          f"({sims[depth][0] * 1e3 / depth:.2f} ms a layer), "
          f"{sims[depth][1] * 1e3:.1f} ms with the Plan's op fusion; the "
          f"trace has no remat")
    del per_layer, leaves
    torch.cuda.empty_cache()

    # prefill through the flash kernel: one launch per layer, on the
    # tensor cores; the stacked model's prefill runs the same ops
    toks = tokens[:1]
    per_layer = M.from_stacked(params, cfg)
    K.reset_launches()
    with torch.no_grad():
        logits, caches = M.prefill(per_layer, cfg, toks,
                                   TINYLLAMA.cache_len, use_kernels=True)
        torch.cuda.synchronize()
        launches = K.flash_attention.launches
        tc = K.flash_attention.tc_launches
        want, _ = ST.prefill(params, cfg, toks, TINYLLAMA.cache_len,
                             use_kernels=True)
    if launches != depth or tc != depth:
        raise AssertionError(f"per-layer prefill: {launches} flash launches "
                             f"({tc} on the tensor cores), want {depth}")
    if len(caches) != depth or not torch.equal(logits, want):
        raise AssertionError(
            f"per-layer prefill logits differ from the stacked model's by "
            f"{float((logits.float() - want.float()).abs().max())} (the "
            f"same ops: want 0)")
    print(f"per-layer prefill ({SEQ} tokens, kernels): {launches} flash "
          f"launches, all on the tensor cores; last-token logits equal to "
          f"the stacked prefill's (tolerance 0)")
    return launches


def phase_serving_plan(dev, params, cfg, default: dict, keep: str) -> tuple:
    """The serving plan on the card: ``compile_serving`` for the tinyllama
    cell's traffic on ``h100_superpod`` at one card's TP group; the saved
    plan loads bit for bit; a compile through a ``PlanCache`` repeated is a
    hit with no simulation; then the plan is enacted by ``ServeEngine`` on
    the cell's requests (``phase_serving`` with the plan).  ``default`` is
    phase (l)'s metrics and peak, printed beside the plan's; the plan is
    saved as ``serve.json`` in ``keep`` for phase (z).  Returns the plan
    run's launches."""
    wl = TINYLLAMA.workload
    kw = dict(cluster=SEARCH_CLUSTER, tp_degree=SERVE_PLAN_TP,
              cache_len=TINYLLAMA.cache_len, workload=wl)
    t0 = time.perf_counter()
    plan = SP.compile_serving(ARCH, **kw)
    search_s = time.perf_counter() - t0
    d = plan.describe()
    print(f"serving plan {ARCH} on {SEARCH_CLUSTER} (tp {SERVE_PLAN_TP}, "
          f"cache {TINYLLAMA.cache_len}): slots {d['slots']}, decode batch "
          f"{d['decode_batch']}, kv {d['kv_layout']}, algo {d['algo']}, "
          f"streams {d['streams']}; predicted "
          f"{plan.predicted_tokens_per_s:.1f} tokens/s, ttft p99 "
          f"{plan.predicted_ttft_p99_s * 1e3:.3f} ms; search {search_s:.3f} "
          f"s ({plan.provenance['steps']} steps, "
          f"{plan.provenance['simulations']} simulations)")
    plan.save(os.path.join(keep, "serve.json"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.json")
        plan.save(path)
        loaded = SP.ServingPlan.load(path)
        again = loaded.save(os.path.join(tmp, "again.json"))
        if (loaded != plan or loaded.fingerprint() != plan.fingerprint()
                or open(path).read() != open(again).read()):
            raise AssertionError("the serving plan does not round-trip")
        cache = os.path.join(tmp, "cache")
        cold = SP.compile_serving(ARCH, cache=cache, **kw)
        runs = []
        run = SP.ServingSimulator._run
        SP.ServingSimulator._run = lambda self, state: (
            runs.append(1), run(self, state))[1]
        try:
            hit = SP.compile_serving(ARCH, cache=cache, **kw)
        finally:
            SP.ServingSimulator._run = run
        if (cold.provenance["cache"]["outcome"] != "miss"
                or hit.provenance["cache"]["outcome"] != "hit" or runs
                or hit != plan):
            raise AssertionError(f"serving plan cache: cold "
                                 f"{cold.provenance['cache']}, then "
                                 f"{hit.provenance['cache']} with "
                                 f"{len(runs)} simulations")
    print(f"serving plan: saved and loaded bit for bit "
          f"[{plan.fingerprint()}]; a cached compile repeated is a hit with "
          f"0 simulations")
    launches, m, peak = phase_serving(dev, params, cfg, TINYLLAMA,
                                      plan=loaded)
    dm, dpeak = default["metrics"], default["peak"]
    print(f"serving plan against the default engine ({SLOTS} slots) and "
          f"the plan's prediction: ttft p50 {m['ttft_p50_s'] * 1e3:.1f} / "
          f"{dm['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{m['ttft_p99_s'] * 1e3:.1f} / {dm['ttft_p99_s'] * 1e3:.1f} ms "
          f"(predicted {plan.predicted_ttft_p99_s * 1e3:.3f}); tpot p50 "
          f"{m['tpot_p50_s'] * 1e3:.2f} / {dm['tpot_p50_s'] * 1e3:.2f} ms, "
          f"p99 {m['tpot_p99_s'] * 1e3:.2f} / {dm['tpot_p99_s'] * 1e3:.2f} "
          f"ms; {m['tokens_per_s']:.1f} / {dm['tokens_per_s']:.1f} tokens/s "
          f"(predicted {plan.predicted_tokens_per_s:.1f}); peak "
          f"{peak / 2**30:.2f} / {dpeak / 2**30:.2f} GiB")
    return launches


def _recording_routes(record: list):
    """``L.moe_fwd`` that also appends each call's router logits (f32) and
    top-k experts to ``record``, computed from its inputs as ``moe_fwd``
    computes them (the same ops on the same tensors)."""
    orig = L.moe_fwd

    def moe_fwd(p, cfg, x, *, route_rows=False, tp=None):
        G = x.shape[0] if route_rows else 1
        logits = (x.reshape(G, -1, x.shape[-1])
                  @ p["router"].to(x.dtype)).float()
        top = torch.sort(torch.softmax(logits, -1), dim=-1,
                         descending=True, stable=True)[1][..., :cfg.moe.top_k]
        record.append((logits, top))
        return orig(p, cfg, x, route_rows=route_rows, tp=tp)
    return orig, moe_fwd


def phase_route_rows_reduced(dev, cfg) -> None:
    """Per-row routing on the card, reduced model in f32 with capacity
    1.0 (where 16 rows routed together would drop token copies): the
    engine's greedy tokens over 16 slots equal a batch-1 prefill and
    ``decode_step`` loop per request."""
    rcfg = cfg.reduced()
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=1.0))
    params = T.map(lambda a: a.to(dev),
                   ST.init_params(rcfg, seed=0, device="cpu"))
    lens, new, cache = (1, 7, 30, 12, 5, 21) * 3, 8, 64
    eng = ENG.ServeEngine(params, rcfg, max_slots=16, cache_len=cache)
    for r in _engine_requests(rcfg.vocab, 5, lens, new):
        eng.submit(r)
    got = {r.rid: r.output for r in eng.run_to_completion()}
    for r in _engine_requests(rcfg.vocab, 5, lens, new):
        with torch.no_grad():
            lg, c = ST.prefill(params, rcfg, torch.from_numpy(
                r.prompt.astype(np.int64)).to(dev)[None], cache)
            out = [int(lg.argmax())]
            for t in range(new - 1):
                lg, c = ST.decode_step(
                    params, rcfg, c, torch.tensor([out[-1]], device=dev),
                    len(r.prompt) + t)
                out.append(int(lg.argmax()))
        if got.get(r.rid) != out:
            raise AssertionError(f"reduced {DS_ARCH} engine, request "
                                 f"{r.rid}: {got.get(r.rid)}, the batch-1 "
                                 f"loop {out}")
    print(f"reduced {DS_ARCH} (f32, capacity 1.0) engine over 16 slots, "
          f"{len(lens)} requests: greedy tokens equal a batch-1 prefill and "
          f"decode_step loop per request ({len(lens) * new} tokens)")


def phase_route_rows_full(dev, params, cfg) -> None:
    """The engine's first decode step at full width against batch-1
    ``decode_step`` calls on the same caches: each row's top-k experts in
    every MoE layer, and its logits within ``DS_ROW_LOGIT_TOL``.  An
    expert set may differ only by a swap between experts whose router
    logits, on the batch-1 step, lie closer than the two steps' router
    logits for that row differ (a near tie that the two GEMM shapes' bf16
    rounding decides)."""
    reqs = sorted(_cell_requests(cfg, DEEPSEEK),
                  key=lambda r: len(r.prompt))[:DS_ROUTE_REQUESTS]
    eng = ENG.ServeEngine(params, cfg, max_slots=SLOTS,
                          cache_len=DEEPSEEK.cache_len)
    for r in reqs:
        eng.submit(r)
    eng._admit()
    rows = [s for s, r in enumerate(eng.slot_req) if r is not None]
    snap = {s: (T.map(lambda a: a[:, s:s + 1].clone(), eng.caches),
                int(eng.slot_last[s]), int(eng.slot_pos[s])) for s in rows}
    seen = []
    decode = eng._decode
    eng._decode = lambda *a: (seen.append(decode(*a)), seen[-1])[1]
    record: list = []
    orig, L.moe_fwd = _recording_routes(record)
    try:
        eng.step()
        engine_routes = list(record)
        worst, swaps, same = 0.0, 0, 0
        for s in rows:
            caches, tok, pos = snap[s]
            record.clear()
            with torch.no_grad():
                lg, _ = ST.decode_step(params, cfg, caches,
                                       torch.tensor([tok], device=dev), pos)
            diff = float((lg[0].float() - seen[0][s].float()).abs().max())
            worst = max(worst, diff)
            for (le, te), (l1, t1) in zip(engine_routes, record):
                a, b = set(te[s, 0].tolist()), set(t1[0, 0].tolist())
                if a == b:
                    same += 1
                    continue
                drift = float((le[s, 0] - l1[0, 0]).abs().max())
                row = l1[0, 0]
                kth = float(row[t1[0, 0, -1]])
                gap = max(abs(float(row[e]) - kth) for e in a ^ b)
                if gap > drift:
                    raise AssertionError(
                        f"{DS_ARCH} slot {s}: engine experts {sorted(a)}, "
                        f"batch-1 {sorted(b)}; logit gap {gap} > the steps' "
                        f"router difference {drift}")
                swaps += 1
    finally:
        L.moe_fwd = orig
    layers = cfg.n_layers - cfg.moe.first_dense_layers
    if len(engine_routes) != layers or same + swaps != layers * len(rows):
        raise AssertionError(f"{DS_ARCH}: {len(engine_routes)} routed "
                             f"layers recorded, want {layers}")
    print(f"{DS_ARCH} engine's first decode step ({SLOTS} rows, prompts "
          f"{[len(r.prompt) for r in reqs]}) against batch-1 decode_step: "
          f"top-{cfg.moe.top_k} experts equal in {same} of "
          f"{layers * len(rows)} (row, MoE layer) pairs, {swaps} near-tie "
          f"swaps; max |logit diff| {worst:.4e} (tolerance "
          f"{DS_ROW_LOGIT_TOL}, logits up to "
          f"{float(seen[0].float().abs().max()):.3f})")
    if not worst <= DS_ROW_LOGIT_TOL:
        raise AssertionError(f"{DS_ARCH}: engine logits differ from a "
                             f"batch-1 step by {worst} > {DS_ROW_LOGIT_TOL}")
    del eng, snap
    torch.cuda.empty_cache()


def phase_deepseek_loss(dev, params, cfg) -> None:
    """Loss and gradients of every leaf at a cut depth of
    ``DS_LOSS_LAYERS`` (the dense layer and the first MoE layers, copied
    out of the full stack) at batch 1 x ``DS_LOSS_SEQ``, remat: finite,
    with the aux loss printed."""
    cut = DS_LOSS_LAYERS - cfg.moe.first_dense_layers
    cfg4 = dataclasses.replace(cfg, n_layers=DS_LOSS_LAYERS)
    p4 = dict(params, groups=[params["groups"][0],
                              T.map(lambda a: a[:cut].clone(),
                                    params["groups"][1])])
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, DS_LOSS_SEQ),
                                     device=dev, generator=gen)}
    leaves = ST.leaves(p4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss, grads, secs = _loss_and_grads(
        lambda: ST.loss_fn(p4, cfg4, batch, remat=True), leaves)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = ST.hidden_forward(p4, cfg4, batch["tokens"])
    norm = _global_norm(grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"{DS_ARCH} loss and gradients at {DS_LOSS_LAYERS} layers (1 "
          f"dense, {cut} MoE; batch 1 x {DS_LOSS_SEQ}, remat, {len(leaves)} "
          f"leaves, {sum(p.numel() for p in leaves) / 1e9:.2f}B "
          f"parameters): loss {loss:.6f} (aux {float(aux):.6f}), gradient "
          f"norm {norm:.6f}, {secs * 1e3:.1f} ms (one step, host clock, "
          f"synced), peak {peak / 2**30:.2f} GiB")
    if not (math.isfinite(loss) and math.isfinite(norm) and finite
            and float(aux) > 0):
        raise AssertionError(f"{DS_ARCH} loss {loss}, aux {float(aux)}, "
                             f"gradient norm {norm}, all finite {finite}")
    del p4, grads, leaves
    torch.cuda.empty_cache()


def phase_deepseek_search(cfg) -> None:
    """The full step traced on meta tensors (``trace_model_graph``) at
    ``BATCH`` x ``SEQ`` and searched for ``SEARCH_CLUSTER`` under
    ``H100_SXM``: prims, the DOT FLOPs of the traced graph (read from the
    fx graph before the scans collapse) beside the analytic model's
    forward-and-backward FLOPs, the Plan's buckets, the seconds."""
    from collections import Counter

    from repro_torch.core import analytic as AN
    from repro_torch.core import trace as TRACE

    graphs: list = []
    orig = TRACE.graph_from_fx
    TRACE.graph_from_fx = lambda gm, *a: (graphs.append(gm), orig(gm, *a))[1]
    try:
        t0 = time.perf_counter()
        g = RP.trace_model_graph(cfg, batch=BATCH, seq=SEQ, reduced=False,
                                 hw=H100_SXM)
        trace_s = time.perf_counter() - t0
    finally:
        TRACE.graph_from_fx = orig
    dots = sum(TRACE._dot_flops(n) for n in graphs[0].graph.nodes
               if n.op == "call_function" and TRACE._classify(n) == DOT)
    fwd = AN._per_token_forward_flops(cfg, SEQ, decode=False) * BATCH * SEQ
    n_leaves = len(ST.leaves(meta_params(cfg)))
    plan = RP.compile(graph=g, cluster=SEARCH_CLUSTER, hw=H100_SXM)
    search_s = plan.provenance["facade_wall_time"]
    if (len(g.grad_prim) != n_leaves
            or sorted(i for b in plan.buckets for i in b)
            != list(range(n_leaves))):
        raise AssertionError(f"{DS_ARCH} trace: {len(g.grad_prim)} gradient "
                             f"leaves, want {n_leaves} covered once")
    print(f"{DS_ARCH} full step (batch {BATCH} x seq {SEQ}, {cfg.n_layers} "
          f"layers) on meta tensors: {len(g.prims)} prims "
          f"{dict(Counter(p.category for p in g.prims))}, {n_leaves} "
          f"gradient leaves, DOT FLOPs {dots:.4e} (the analytic model's "
          f"forward x 3: {3 * fwd:.4e}, causal attention at S/2), trace "
          f"{trace_s:.2f} s; search on {SEARCH_CLUSTER} {search_s:.2f} s "
          f"({plan.provenance['steps']} steps, "
          f"{plan.provenance['simulations']} simulations), simulated "
          f"{plan.provenance['initial_cost'] * 1e3:.3f} -> "
          f"{plan.provenance['best_cost'] * 1e3:.3f} ms; "
          f"{_describe_buckets(plan)}; not enacted (f32 AdamW moments alone "
          f"{2 * 4 * cfg.param_count() / 1e9:.0f} GB)")


def phase_deepseek(dev, tp_checks: list) -> dict:
    """Phase (t): full deepseek-v2-lite-16b on the card, and its serving
    check under tp for phase (aa) (appended to ``tp_checks``).  Returns
    the serving run's launches."""
    cfg = get_config(DS_ARCH)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in ST.leaves(params))
    print(f"{DS_ARCH}: {n / 1e9:.4f}B parameters in "
          f"{len(ST.leaves(params))} leaves ({cfg.param_count() / 1e9:.4f}B "
          f"by param_count(), which leaves out the norms; "
          f"{cfg.active_param_count() / 1e9:.4f}B active) drawn on the card "
          f"in {time.time() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_reduced_engine(dev, cfg, DEEPSEEK)
    phase_route_rows_reduced(dev, cfg)
    phase_route_rows_full(dev, params, cfg)
    served, _, _ = phase_serving(dev, params, cfg, DEEPSEEK)
    tp_checks.append(phase_serve_tp_check(dev, params, cfg, DEEPSEEK,
                                          max(DEEPSEEK.extra_prompts)))
    phase_decode_trace(dev, params, cfg, DEEPSEEK.cache_len)
    phase_deepseek_loss(dev, params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_deepseek_search(cfg)
    return served


def phase_int8(dev) -> None:
    """Phase (u): the int8 KV cache against the bf16 one on full
    tinyllama-1.1b, ``INT8_STEPS`` decode steps from ``init_cache`` at each
    of ``INT8_ROWS`` rows (cache 4096) on the same tokens.  A run's peak
    memory holds the weights, its cache, its logits and each step's
    transients."""
    cfg = get_config(ARCH)
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    cache_len = TINYLLAMA.cache_len
    for rows in INT8_ROWS:
        gen = torch.Generator(device=dev).manual_seed(rows)
        toks = torch.randint(0, cfg.vocab, (rows, INT8_STEPS), device=dev,
                             generator=gen)
        runs = {}
        for kv in ("", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            caches = ST.init_cache(c, rows, cache_len, device=dev)
            nbytes = sum(a.numel() * a.element_size()
                         for a in T.leaves(caches))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logits = []
            t0 = time.perf_counter()
            with torch.no_grad():
                for t in range(INT8_STEPS):
                    logits.append(ST.decode_step(params, c, caches,
                                                 toks[:, t], t)[0])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / INT8_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated()
            # the run's logits to the host, so each peak holds its own run
            runs[kv or "bf16"] = (torch.stack(logits).cpu().float(), ms,
                                  peak, nbytes)
            del caches, logits
            torch.cuda.empty_cache()
        ref, ms16, peak16, b16 = runs["bf16"]
        got, ms8, peak8, b8 = runs["int8"]
        diff = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and diff < 1.0):
            raise AssertionError(f"int8 decode at {rows} rows: logits "
                                 f"{diff} from the bf16 cache's")
        print(f"int8 KV cache, {ARCH}, {rows} rows x cache {cache_len}, "
              f"{INT8_STEPS} decode steps from init_cache: bf16 cache "
              f"{b16 / 1e9:.3f} GB, {ms16:.2f} ms per step, peak "
              f"{peak16 / 2**30:.2f} GiB; int8 cache {b8 / 1e9:.3f} GB, "
              f"{ms8:.2f} ms per step, peak {peak8 / 2**30:.2f} GiB; max "
              f"|logit diff| from the bf16 run {diff:.4e} (logits up to "
              f"{float(ref.abs().max()):.3f}; host clock, synced)")
    del params
    torch.cuda.empty_cache()


def _cache_diff(a, b) -> float:
    """Largest |difference| over the leaves of two cache trees."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(T.leaves(a), T.leaves(b)))


def _mm_prefill(dev, params, cfg, toks, stubs, cache_len: int) -> int:
    """Prefill with the flash kernel against prefill without it, both
    against f32 weights, as phase (k) holds tinyllama's; the kernel's
    launches counted (one per decoder layer, on the tensor cores).  Then
    16 decode steps from each of the two caches (passing the encoder's
    output as ``memory`` where there is one), their logits within (k)'s
    tolerance; the prefill timed and traced.  Returns the counted flash
    launches."""
    tol = TINYLLAMA
    K.reset_launches()
    with torch.no_grad():
        lk, ck = ST.prefill(params, cfg, toks, cache_len, use_kernels=True,
                            **stubs)
        torch.cuda.synchronize()
        launches = K.flash_attention.launches
        tc = K.flash_attention.tc_launches
        lp, cp = ST.prefill(params, cfg, toks, cache_len, **stubs)
    if launches != cfg.n_layers or tc != cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefill: {launches} flash "
                             f"launches ({tc} on the tensor cores), want "
                             f"{cfg.n_layers}")
    if lk.shape != (1, cfg.vocab) or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"{cfg.name} prefill: logits "
                             f"{tuple(lk.shape)} not finite or misshapen")
    params32 = T.map(lambda a: a.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    stubs32 = {k: v.float() for k, v in stubs.items()}
    with torch.no_grad():
        l32, c32 = ST.prefill(params32, cfg32, toks, cache_len, **stubs32)
        lk32, ck32 = ST.prefill(params32, cfg32, toks, cache_len,
                                use_kernels=True, **stubs32)
    del params32
    diff = float((lk.float() - lp.float()).abs().max())
    dcache = _cache_diff(ck, cp)
    e_k = float((lk.float() - l32).abs().max())
    e_p = float((lp.float() - l32).abs().max())
    e32 = max(float((lk32 - l32).abs().max()), _cache_diff(ck32, c32))
    del c32, ck32
    n_text = toks.shape[1]
    what = " + ".join(f"{tuple(v.shape)} {k}" for k, v in stubs.items())
    print(f"prefill {cfg.name} {n_text} tokens + {what}: {launches} flash "
          f"launches, all on the tensor cores; max |logit| "
          f"{float(lp.abs().max()):.3f}, kernel vs dense max |diff| logits "
          f"{diff:.4e} (tolerance {tol.logit_tol}), k/v {dcache:.4e} "
          f"(tolerance {tol.cache_tol}); against f32 weights: logits kernel "
          f"{e_k:.4e}, dense {e_p:.4e}; f32 weights kernel vs dense max "
          f"|diff| {e32:.4e} (tolerance {F32_PATHS_TOL}); argmax "
          f"{int(lk.argmax())} / {int(lp.argmax())} / {int(l32.argmax())}")
    if not (diff <= tol.logit_tol and dcache <= tol.cache_tol
            and e32 <= F32_PATHS_TOL and e_k <= 2 * e_p):
        raise AssertionError(f"{cfg.name} prefill: kernel against dense "
                             f"{diff} (logits), {dcache} (k/v), f32 paths "
                             f"{e32}, from f32 {e_k} against {e_p}")

    # decode from both caches on the same tokens
    memory = None
    with torch.no_grad():
        if "enc_frames" in stubs:
            memory = ST.encode(params, cfg, stubs["enc_frames"])
        gen = torch.Generator(device=dev).manual_seed(23)
        nxt = torch.randint(0, cfg.vocab, (1, MM_DECODE_STEPS), device=dev,
                            generator=gen)
        start = cfg.vlm_prefix_len + n_text
        worst, times = 0.0, []
        for t in range(MM_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dk, ck = ST.decode_step(params, cfg, ck, nxt[:, t], start + t,
                                    memory=memory)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            dp, cp = ST.decode_step(params, cfg, cp, nxt[:, t], start + t,
                                    memory=memory)
            if not bool(torch.isfinite(dk).all()):
                raise AssertionError(f"{cfg.name} decode step {t}: logits "
                                     f"not finite")
            worst = max(worst, float((dk.float() - dp.float()).abs().max()))
    print(f"decode {cfg.name}: {MM_DECODE_STEPS} steps from each cache at "
          f"positions {start}..{start + MM_DECODE_STEPS - 1}"
          f"{' with the encoder output as memory' if memory is not None else ''}"
          f": max |logit diff| {worst:.4e} (tolerance {tol.logit_tol}); "
          f"{statistics.median(times[1:]) * 1e3:.2f} ms a step (host clock, "
          f"synced, median)")
    if not worst <= tol.logit_tol:
        raise AssertionError(f"{cfg.name} decode: the two caches' logits "
                             f"differ by {worst} > {tol.logit_tol}")
    del ck, cp, memory
    torch.cuda.empty_cache()

    for use_kernels in (True, False):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                ST.prefill(params, cfg, toks, cache_len,
                           use_kernels=use_kernels, **stubs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"prefill {cfg.name}, use_kernels={use_kernels}: "
              f"{statistics.median(ms):.1f} ms (median of 3, host clock, "
              f"synced)")
    phase_prefill_trace(params, cfg, toks, cache_len, **stubs)
    return launches


def _mm_train(cfg) -> None:
    """``train.main --strategy auto`` at batch 4 x 2048 text tokens for 4
    steps (the stubs in every batch): finite losses, the sync kernels and
    collectives the searched Plan implies, trace plus search within
    ``SEARCH_LIMIT_S``."""
    leaves = ST.leaves(meta_params(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    TS.reset_collectives()
    t0 = time.time()
    out = TRAIN.main(["--arch", cfg.name, "--strategy", "auto", "--cluster",
                      SEARCH_CLUSTER, "--batch", str(BATCH), "--seq",
                      str(SEQ), "--steps", str(STEPS), "--log-every", "1",
                      "--device", "cuda"])
    wall = time.time() - t0
    launches = {name: getattr(K, name).launches
                for name in ("bucket_pack",) + SYNC_KERNELS}
    coll = dict(TS.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    plan, losses = out["plan"], out["losses"]
    if len(losses) != STEPS or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    if sorted(i for b in plan.buckets for i in b) != list(range(len(leaves))):
        raise AssertionError(f"{cfg.name}: the Plan's buckets do not cover "
                             f"the {len(leaves)} leaves once each")
    want, calls = implied_counts(plan.grad_sync(leaves), leaves, STEPS)
    if launches != want or coll != calls:
        raise AssertionError(f"{cfg.name} training: launches {launches}, "
                             f"collectives {coll}; the Plan implies {want}, "
                             f"{calls}")
    prov = plan.provenance
    trace, search_s = prov["trace"], prov["search_wall_time"]
    if trace["wall_time"] + search_s > SEARCH_LIMIT_S:
        raise AssertionError(f"{cfg.name}: trace {trace['wall_time']:.1f} s "
                             f"+ search {search_s:.1f} s exceed "
                             f"{SEARCH_LIMIT_S} s")
    step_s = statistics.median(out["step_seconds"][1:])
    print(f"train {cfg.name} (batch {BATCH} x seq {SEQ} text tokens, "
          f"--strategy auto on {SEARCH_CLUSTER}): {trace['prims']} prims "
          f"{trace['by_category']}; trace {trace['wall_time']:.2f} s, search "
          f"{search_s:.3f} s ({prov['steps']} steps, {prov['simulations']} "
          f"simulations; simulated {prov['initial_cost'] * 1e3:.3f} -> "
          f"{prov['best_cost'] * 1e3:.3f} ms); {_describe_buckets(plan)}")
    print(f"train {cfg.name}: losses {[round(l, 4) for l in losses]}; step "
          f"{step_s * 1e3:.1f} ms (median of steps 2..{STEPS}, host clock, "
          f"synced), {BATCH * SEQ / step_s:.0f} text tokens/s, peak "
          f"{peak / 2**30:.2f} GiB; launches {launches}; collectives {coll} "
          f"(as the Plan implies); launcher wall {wall:.1f} s (weights "
          f"drawn on the host)")


def phase_multimodal(dev, arch: str) -> tuple[float, int]:
    """Phase (w) (paligemma-3b) or (x) (seamless-m4t-medium) at full
    width: flash at the arch's attention shapes, prefill with and without
    the kernel, decode from both caches, then training through the
    launcher's search.  Returns flash's largest error against its plain
    version and the checked prefill's flash launches."""
    cfg = get_config(arch)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(24)
    res = {S: _flash_path_shape(f"{arch} bf16 S={S}", *_flash_inputs(
        gen, dev, S, S, H, KV, hd, torch.bfloat16)) for S in MM_FLASH_SEQS}
    err = max(r["max_abs_err"] for r in res.values())

    t1 = time.time()
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    torch.cuda.synchronize()
    print(f"{arch}: {sum(p.numel() for p in ST.leaves(params)) / 1e9:.2f}B "
          f"parameters in {len(ST.leaves(params))} leaves drawn on the card "
          f"in {time.time() - t1:.1f} s")
    toks = torch.randint(0, cfg.vocab, (1, MM_PROMPT[arch]), device=dev,
                         generator=gen)
    stubs = {}
    if cfg.vlm_prefix_len:
        stubs["prefix_emb"] = torch.randn(
            (1, cfg.vlm_prefix_len, cfg.d_model), device=dev, generator=gen)
    if cfg.encdec is not None:
        stubs["enc_frames"] = torch.randn(
            (1, cfg.encdec.enc_seq, cfg.encdec.frontend_dim), device=dev,
            generator=gen)
    launches = _mm_prefill(dev, params, cfg, toks, stubs, TINYLLAMA.cache_len)
    del params
    torch.cuda.empty_cache()
    _mm_train(cfg)
    torch.cuda.empty_cache()
    return err, launches


def _train_blocks_run(dev, cfg, strat, layout: str, want: dict,
                      calls: dict, mode: str = "ddp_tp",
                      data_calls: Optional[dict] = None) -> dict:
    """``TRAIN_STEPS`` AdamW steps of ``cfg`` under ``mode`` and
    ``layout`` through ``strat`` on weights drawn on the card from seed 0
    and seeded batches, the counters zeroed just before and checked just
    after (under ZeRO-3 also the data group's, against ``data_calls``).
    Returns the run's losses, gradient norms, median step, peak and
    collectives."""
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    opt = adamw(linear_warmup_cosine(1e-3, warmup=20,
                                     total_steps=TRAIN_STEPS),
                weight_decay=0.01)
    mesh = make_debug_mesh((1, 1), device="cuda") if layout == "tp" else None
    step = TS.build_train_step(cfg, mode=mode, layout=layout, mesh=mesh,
                               strategy=strat, optimizer=opt, remat=True)
    if step.tp is not None:
        params = TPAR.shard_params(params, step.tp)
    state = opt[0](ST.leaves(params))
    gen = torch.Generator(device=dev).manual_seed(25)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    TS.reset_collectives()
    losses, norms, times = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH,
                                                        TRAIN_SEQ),
                                         device=dev, generator=gen)}
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: getattr(K, name).launches for name in want}
    serving = {name: getattr(K, name).launches
               for name in ("flash_attention", "rglru_scan", "rwkv6_wkv")}
    coll = dict(TS.COLLECTIVES)
    what = (f"{cfg.name} at {cfg.n_layers} layers, mode {mode!r}, layout "
            f"{layout!r}")
    if launches != want or coll != calls or any(serving.values()):
        raise AssertionError(f"{what}: launches {launches}, collectives "
                             f"{coll}, serving kernels {serving}; the Plan "
                             f"implies {want}, {calls} and none")
    got_data = getattr(step.tp, "data_calls", None)
    if got_data != data_calls:
        raise AssertionError(f"{what}: the data group's collectives "
                             f"{got_data}, want {data_calls}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{what}: losses {losses}, norms {norms}")
    run = {"losses": losses, "norms": norms, "launches": launches,
           "collectives": coll, "step_s": statistics.median(times[1:]),
           "first_s": times[0], "peak": torch.cuda.max_memory_allocated(),
           "tp_calls": None if step.tp is None else dict(step.tp.calls),
           "data_calls": got_data,
           "params": sum(p.numel() for p in ST.leaves(params))}
    del params, state, step
    torch.cuda.empty_cache()
    return run


def _wkv_op_times(dev, cfg) -> None:
    """The model's WKV-6 scan op (the training path's, in plain PyTorch) at
    one layer's shapes in phase (y): the forward and the forward with its
    backward, host clock, synced, median of 3 after a warm-up."""
    from repro_torch.models import recurrent as REC

    gen = torch.Generator(device=dev).manual_seed(26)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).mul_(0.5)
               .bfloat16().requires_grad_(True) for _ in range(3))
    w = (torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.45
         ).requires_grad_(True)
    u = (0.1 * torch.randn(shape[2:], generator=gen, device=dev)
         ).requires_grad_(True)

    def wall_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def fwd_bwd():
        out, final = REC._wkv6_scan(r, k, v, w, u)
        torch.autograd.grad(out.float().sum() + final.sum(), (r, k, v, w, u))

    with torch.no_grad():
        fwd = wall_ms(lambda: REC._wkv6_scan(r, k, v, w, u))
    both = wall_ms(fwd_bwd)
    print(f"WKV-6 scan op at {shape} (bf16 r, k, v, f32 w, u; chunks of "
          f"{REC.wkv_chunk(*shape)} steps): forward {fwd:.2f} ms, forward "
          f"and backward {both:.2f} ms (host clock, synced); a remat step "
          f"runs 2 forwards and 1 backward a layer")


def _train_blocks(dev, cfg) -> None:
    """One model of phase (y): trace, search, both layouts, the gate."""
    from collections import Counter

    from repro_torch.core import trace as TRACE

    graphs: list = []
    orig = TRACE.graph_from_fx
    TRACE.graph_from_fx = lambda gm, *a: (graphs.append(gm), orig(gm, *a))[1]
    try:
        plan = TRAIN.search_strategy(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     n_devices=1, cluster=SEARCH_CLUSTER)
    finally:
        TRACE.graph_from_fx = orig
    names = Counter(TRACE._op_name(n) for n in graphs[0].graph.nodes)
    prov = plan.provenance
    trace = prov["trace"]
    leaves = ST.leaves(meta_params(cfg))
    if sorted(i for b in plan.buckets for i in b) != list(range(len(leaves))):
        raise AssertionError(f"{cfg.name}: the Plan's buckets do not cover "
                             f"the {len(leaves)} leaves once each")
    strat = plan.grad_sync(leaves)
    want, calls = implied_counts(strat, leaves, TRAIN_STEPS)
    print(f"train {cfg.name} at {cfg.n_layers} layers (batch {TRAIN_BATCH} "
          f"x seq {TRAIN_SEQ}, {sum(p.numel() for p in leaves) / 1e9:.2f}B "
          f"parameters in {len(leaves)} leaves): {trace['prims']} prims "
          f"{trace['by_category']} from {len(graphs[0].graph.nodes)} fx "
          f"nodes, WKV ops {names['wkv6_scan']} forward and "
          f"{names['wkv6_scan_bwd']} backward; trace {trace['wall_time']:.2f} "
          f"s, search on {SEARCH_CLUSTER} {prov['search_wall_time']:.3f} s "
          f"({prov['steps']} steps, {prov['simulations']} simulations; "
          f"simulated {prov['initial_cost'] * 1e3:.3f} -> "
          f"{prov['best_cost'] * 1e3:.3f} ms); {_describe_buckets(plan)}")
    if cfg.block == "rwkv" and not (names["wkv6_scan"] == names[
            "wkv6_scan_bwd"] == cfg.n_layers):
        raise AssertionError(f"{cfg.name}: WKV ops {names['wkv6_scan']} and "
                             f"{names['wkv6_scan_bwd']}, want one each a "
                             f"layer")
    if cfg.block == "rwkv":
        _wkv_op_times(dev, cfg)
    runs = {layout: _train_blocks_run(dev, cfg, strat, layout, want, calls)
            for layout in ("dp", "tp")}
    for layout, r in runs.items():
        print(f"train {cfg.name} layout {layout!r}: losses {r['losses']}, "
              f"grad norms {r['norms']}; step {r['step_s'] * 1e3:.1f} ms "
              f"(median of steps 2..{TRAIN_STEPS}, host clock, synced; "
              f"first {r['first_s'] * 1e3:.1f} ms), "
              f"{TRAIN_BATCH * TRAIN_SEQ / r['step_s']:.0f} tokens/s, "
              f"max_memory_allocated {r['peak'] / 2**30:.2f} GiB; launches "
              f"{r['launches']}; collectives {r['collectives']} (as the Plan "
              f"implies); model group's collectives {r['tp_calls']}")
    dp, tp = runs["dp"], runs["tp"]
    gaps = {k: [abs(a - b) / abs(b) for a, b in zip(tp[k], dp[k])]
            for k in ("losses", "norms")}
    print(f"train {cfg.name}: relative gaps tp against dp, losses "
          f"{['%.2e' % g for g in gaps['losses']]}, grad norms "
          f"{['%.2e' % g for g in gaps['norms']]}; step "
          f"{tp['step_s'] / dp['step_s']:.4f}x, peak "
          f"{tp['peak'] / dp['peak']:.4f}x")
    if max(gaps["losses"]) > TP_LOSS_RTOL or \
            max(gaps["norms"]) > TP_GNORM_RTOL:
        raise AssertionError(f"{cfg.name} tp against dp: relative gaps "
                             f"{gaps} over {TP_LOSS_RTOL} / {TP_GNORM_RTOL}")


def phase_train_blocks(dev) -> None:
    """Phase (y): the RG-LRU hybrid, RWKV-6 and MLA with routed experts
    trained at full width and the depths of ``TRAIN_DEPTHS`` in a one-rank
    NCCL group, under both layouts; within ``TRAIN_BLOCKS_LIMIT_S``."""
    t0 = time.time()
    created = TRAIN.init_process_group(dev)
    try:
        for arch, depth in TRAIN_DEPTHS.items():
            _train_blocks(dev, dataclasses.replace(get_config(arch),
                                                   n_layers=depth))
    finally:
        if created:
            dist.destroy_process_group()
    wall = time.time() - t0
    print(f"phase (y): {wall:.1f} s (limit {TRAIN_BLOCKS_LIMIT_S} s); card "
          f"{card_line()}")
    if wall > TRAIN_BLOCKS_LIMIT_S:
        raise AssertionError(f"phase (y) took {wall:.1f} s, over "
                             f"{TRAIN_BLOCKS_LIMIT_S} s")


def start_dryruns(out: str) -> list:
    """Start the full-width dry runs of :data:`DRYRUNS` on the host, one
    process each (the launcher's CLI), writing their JSON and logs under
    ``out``.  Returns ``[(arch, shape, process, start)]``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))
    runs = []
    for i, (arch, shape) in enumerate(DRYRUNS):
        with open(os.path.join(out, f"{arch}.log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", out],
                env=env, stdout=log, stderr=subprocess.STDOUT)
        # one core of its own, from the last, at the lowest priority: the
        # host-timed phases beside it keep the other cores
        os.sched_setaffinity(proc.pid, {cores[-1 - i % len(cores)]})
        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
        runs.append((arch, shape, proc, time.time()))
    return runs


# the memory points' dry runs on a fake (1, 1) world, run beside the card
# phases in a process of their own (this script imported for the points'
# inputs)
_POINTS = r"""
import json, sys
import chip_smoke as CS
points = {shape: CS.DRY.dryrun_one(
    CS.ARCH, shape, verbose=False, mesh_shape={"data": 1, "model": 1},
    specs=CS._memory_point_specs(CS.get_config(CS.ARCH), shape))
    for shape in ("decode_32k", "prefill_32k")}
json.dump(points, open(sys.argv[1], "w"))
"""


def _memory_point_specs(cfg, shape: str) -> dict:
    """The inputs of a memory point: meta tensors of the decode step's
    token, position and caches, or of the prefill's prompts."""
    def meta(shape_of, dt):
        return torch.empty(shape_of, dtype=dt, device="meta")

    if shape == "decode_32k":
        return {"token": meta((MEM_DECODE_ROWS,), torch.int64),
                "pos": meta((), torch.int64),
                "caches": ST.init_cache(cfg, MEM_DECODE_ROWS, MEM_SEQ,
                                        device="meta")}
    return {"tokens": meta((MEM_PREFILL_ROWS, MEM_SEQ), torch.int64)}


def start_serving_dryruns(out: str) -> dict:
    """Start, beside the training dry runs, the sweep of the serving dry
    runs (``launch/sweep.py`` over ``SWEEP_ARCHS`` x ``SWEEP_SHAPES`` on
    the (16, 16) mesh, into ``out/sweep``) and the memory points' dry
    runs (into ``out/points.json``), each on a core of its own at the
    lowest priority.  Returns ``{"sweep": (process, start), "points":
    (process, start)}``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, here]),
               OMP_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))
    cmds = {"sweep": [sys.executable, "-m", "repro_torch.launch.sweep",
                      "--arch", ",".join(SWEEP_ARCHS),
                      "--shape", ",".join(SWEEP_SHAPES),
                      "--meshes", "single",
                      "--out", os.path.join(out, "sweep")],
            "points": [sys.executable, "-c", _POINTS,
                       os.path.join(out, "points.json")]}
    procs = {}
    for i, (name, cmd) in enumerate(cmds.items()):
        with open(os.path.join(out, f"{name}.log"), "w") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        os.sched_setaffinity(proc.pid,
                             {cores[-1 - (len(DRYRUNS) + i) % len(cores)]})
        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
        procs[name] = (proc, time.time())
    return procs


def _dryrun_results(out: str, runs: list, deadline: float) -> None:
    """Wait for the dry runs (until ``deadline``), check and print each:
    flops, collectives per op and group size, argument + temp bytes per
    device, the priced collective time and the seconds."""
    for arch, shape, proc, start in runs:
        proc.wait(timeout=max(deadline - time.time(), 1.0))
        log = open(os.path.join(out, f"{arch}.log")).read()
        if proc.returncode != 0:
            raise AssertionError(f"dry run {arch} x {shape} exited "
                                 f"{proc.returncode}:\n{log[-3000:]}")
        with open(os.path.join(out, f"{arch}__{shape}__pod16x16.json")) as f:
            res = json.load(f)
        coll, mem, cl = res["collectives"], res["memory"], res["cluster"]
        per_op = {op: {"count": d["count"], "bytes": d["bytes"],
                       "by_group": {g: b["count"]
                                    for g, b in d["by_group"].items()}}
                  for op, d in coll["per_op"].items()}
        gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
        print(f"dry run {arch} x {shape} x {res['mesh']} (rank 0 of 256, "
              f"fake backend and tensors, mode {res['mode']}, grad accum "
              f"{res['grad_accum']}): step {res['fake_step_s']} s on the "
              f"host; flops {res['flops']:.6e} (GEMMs and attention), "
              f"bytes accessed {res['bytes_accessed']:.6e}; collectives "
              f"{per_op}, ici traffic {coll['ici_traffic_bytes']:.6e} B; "
              f"argument + temp {gib:.3f} GiB per device (argument "
              f"{mem['argument_bytes'] / 2**30:.3f}, temp "
              f"{mem['temp_bytes'] / 2**30:.3f}); best_time_s "
              f"{cl['best_time_s']:.6e} ({cl['best_algo']} on "
              f"{cl['spec']['name']})")
        if not (res["flops"] > 0 and gib > 0 and coll["per_op"]):
            raise AssertionError(f"dry run {arch}: {res}")
        # the split heads' gathers over the model group; ZeRO-3's
        # scatters over the data group
        op = "reduce-scatter" if res["mode"] == "fsdp_tp" else "all-gather"
        if not per_op.get(op, {}).get("by_group", {}).get("16"):
            raise AssertionError(f"dry run {arch}: no {op} over 16 ranks")


def _price_cli(art: str) -> None:
    """``--plan`` and ``--serve-plan`` on phase (j)'s and (s)'s saved
    artifacts, in subprocesses run together: each exits 0 with the prices
    the artifacts give here; ``--plan`` with another cluster exits 1 and
    prints the differing fields."""
    plan_path = os.path.join(art, "plan.json")
    serve_path = os.path.join(art, "serve.json")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    cmds = {"plan": base + ["--plan", plan_path],
            "serve": base + ["--serve-plan", serve_path],
            "mismatch": base + ["--plan", plan_path, "--cluster",
                                "a100_nvlink_ib"]}
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {k: subprocess.Popen(c + ["--out", os.path.join(art, k)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    try:
        outs = {k: p.communicate(timeout=120) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, want in (("plan", 0), ("serve", 0), ("mismatch", 1)):
        if procs[k].returncode != want:
            raise AssertionError(f"dryrun {cmds[k][3:]} exited "
                                 f"{procs[k].returncode}, want {want}:\n"
                                 f"{outs[k][0][-2000:]}{outs[k][1][-2000:]}")

    def canon(d) -> str:
        return json.dumps(json.loads(json.dumps(d, default=repr)),
                          sort_keys=True)

    with open(os.path.join(art, "plan", "plan__plan.json")) as f:
        got = json.load(f)["pricing"]
    if canon(got) != canon(RP.Plan.load(plan_path).price()):
        raise AssertionError("--plan priced otherwise than Plan.price()")
    with open(os.path.join(art, "serve", "serve_plan__serve.json")) as f:
        sgot = json.load(f)["pricing"]
    if canon(sgot) != canon(SP.ServingPlan.load(serve_path).price()):
        raise AssertionError("--serve-plan priced otherwise than "
                             "ServingPlan.price()")
    diff = [l.strip() for l in outs["mismatch"][0].splitlines()
            if "fingerprint diff" in l or "CLUSTER MISMATCH" in l]
    if not diff:
        raise AssertionError(f"--cluster mismatch printed no diff: "
                             f"{outs['mismatch'][0][-2000:]}")
    print(f"dryrun --plan (phase (j)'s Plan): {got['buckets']} buckets, "
          f"{got['total_grad_bytes']:.6e} B, serialized comm "
          f"{got['serialized_comm_s'] * 1e3:.6f} ms, engine finish "
          f"{got['engine_finish_s'] * 1e3:.6f} ms on {got['cluster']['name']}"
          f", as Plan.price() gives; --serve-plan (phase (s)'s plan): "
          f"{sgot['tokens_per_s']:.3f} tokens/s, ttft p99 "
          f"{sgot['ttft_p99_s'] * 1e3:.6f} ms, as ServingPlan.price() "
          f"gives; --plan --cluster a100_nvlink_ib exits 1: {diff}")


def _zero3_counts(cfg) -> tuple:
    """What ``TRAIN_STEPS`` steps of ``cfg`` under ``mode="fsdp_tp"`` on
    a (1, 1) mesh launch and issue: a convert-copy per data-sharded bf16
    gradient (the clip's upcast) and an f32 all-reduce per leaf no rule
    shards over the data ranks; over the data group, per step, a
    reduce-scatter per data-sharded leaf and layer, an all-gather per
    such leaf and layer twice (remat gathers again) or once outside the
    layers, and the clip's all-reduce."""
    params = meta_params(cfg)
    specs = SH.param_specs(params, {"data": 1, "model": 1}, fsdp=True,
                           cfg=cfg)
    n = TRAIN_STEPS
    rs = ag = convert = reduce = 0
    for (path, p), sp in zip(T.leaves_with_paths(params), specs):
        if SH.spec_dim(sp, "data") is None:
            reduce += 1
            continue
        layers = p.shape[0] if path.startswith("['groups']") else 1
        rs += layers
        ag += 2 * layers if path.startswith("['groups']") else 1
        convert += p.dtype != torch.float32
    want = {"bucket_pack": 0, "convert_copy": n * convert, "fused_pack": 0,
            "fused_unpack": 0}
    calls = {"all_reduce": n * reduce, "reduce_scatter": 0, "all_gather": 0}
    data = {"all_gather": n * ag, "reduce_scatter": n * rs, "all_reduce": n}
    return want, calls, data


def _zero3_on_card(dev) -> int:
    """ZeRO-3 against ``ddp_tp`` on 4-layer deepseek-coder-33b, gated, and
    the dry run's memory beside the measured peak.  Returns the fsdp
    run's convert-copy launches."""
    cfg = dataclasses.replace(get_config(FSDP_ARCH), n_layers=FSDP_DEPTH)
    leaves = ST.leaves(meta_params(cfg))
    want, calls, data = _zero3_counts(cfg)
    strat = TS.GradSyncStrategy.per_tensor(leaves)
    created = TRAIN.init_process_group(dev)
    try:
        runs = {"fsdp_tp": _train_blocks_run(dev, cfg, None, "tp", want,
                                             calls, "fsdp_tp", data),
                "ddp_tp": _train_blocks_run(
                    dev, cfg, strat, "tp",
                    *implied_counts(strat, leaves, TRAIN_STEPS))}
        grads = _grads_memory(dev, cfg)
    finally:
        if created:
            dist.destroy_process_group()
    for mode, r in runs.items():
        print(f"train {cfg.name} at {cfg.n_layers} layers "
              f"({r['params'] / 1e9:.2f}B parameters), mode {mode!r} on a "
              f"(1, 1) mesh: losses {r['losses']}, grad norms {r['norms']}; "
              f"step {r['step_s'] * 1e3:.1f} ms (median of steps "
              f"2..{TRAIN_STEPS}, host clock, synced; first "
              f"{r['first_s'] * 1e3:.1f} ms), "
              f"{TRAIN_BATCH * TRAIN_SEQ / r['step_s']:.0f} tokens/s, "
              f"max_memory_allocated {r['peak'] / 2**30:.3f} GiB; launches "
              f"{r['launches']}; collectives {r['collectives']}; model "
              f"group's {r['tp_calls']}, data group's {r['data_calls']}")
    fs, dd = runs["fsdp_tp"], runs["ddp_tp"]
    gaps = {k: [abs(a - b) / abs(b) for a, b in zip(fs[k], dd[k])]
            for k in ("losses", "norms")}
    print(f"train {cfg.name}: relative gaps fsdp_tp against ddp_tp, losses "
          f"{['%.2e' % g for g in gaps['losses']]}, grad norms "
          f"{['%.2e' % g for g in gaps['norms']]}; step "
          f"{fs['step_s'] / dd['step_s']:.4f}x, peak "
          f"{fs['peak'] / dd['peak']:.4f}x; card {card_line()}")
    if max(gaps["losses"] + gaps["norms"]) > ZERO3_GAP:
        raise AssertionError(f"{cfg.name} fsdp_tp against ddp_tp: relative "
                             f"gaps {gaps} over {ZERO3_GAP}")
    # the dry runs of the same step and of its forward and backward at
    # MEM_BATCH rows, on a fake (1, 1) world
    def tokens(rows):
        return {"tokens": torch.empty((rows, TRAIN_SEQ), dtype=torch.int64,
                                      device="meta")}

    with DRY.fake_world(1):
        mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
        pred = DRY.dryrun_train(cfg, mesh, FSDP_ARCH,
                                specs=tokens(TRAIN_BATCH), grad_accum=1)
        pred_grads = DRY.dryrun_grads(cfg, mesh, FSDP_ARCH,
                                      specs=tokens(MEM_BATCH), grad_accum=1)
    mem = pred["memory"]
    total = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"memory of the fsdp_tp step (its peak in the update: the "
          f"parameters, moments and their updates): measured "
          f"max_memory_allocated {fs['peak'] / 2**30:.3f} GiB against the "
          f"dry run's argument + temp {total / 2**30:.3f} GiB (argument "
          f"{mem['argument_bytes'] / 2**30:.3f}, temp "
          f"{mem['temp_bytes'] / 2**30:.3f}; fake (1, 1) world, "
          f"{pred['fake_step_s']} s): the dry run is "
          f"{(total - fs['peak']) / fs['peak'] * 100:+.2f}% off the card; "
          f"flops {pred['flops']:.6e}")
    card_args, card_temp = grads
    print(f"memory of the fsdp_tp forward and backward (step.loss_and_grads"
          f", before the sync, clip and update; {MEM_BATCH} x {TRAIN_SEQ}; "
          f"its temp the gradients and activations): measured arguments "
          f"{card_args / 2**30:.3f} GiB, temp {card_temp / 2**30:.3f} GiB "
          f"(max_memory_allocated less the bytes live before it) against "
          f"the dry run's {pred_grads['argument_bytes'] / 2**30:.3f} and "
          f"{pred_grads['temp_bytes'] / 2**30:.3f} GiB: temp "
          f"{(pred_grads['temp_bytes'] - card_temp) / card_temp * 100:+.2f}"
          f"% off the card; card {card_line()}")
    return fs["launches"]["convert_copy"]


def _grads_memory(dev, cfg) -> tuple:
    """The fsdp_tp step's forward and backward alone
    (``step.loss_and_grads``, before its sync, clip and update) on
    ``MEM_BATCH`` x ``TRAIN_SEQ`` tokens on the card: the bytes its
    arguments take (parameters drawn from seed 0, the batch) and the most
    it allocates beyond them (``max_memory_allocated`` less what was live
    before: the gradients and activations)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    step = TS.build_train_step(cfg, mode="fsdp_tp", remat=True,
                               mesh=make_debug_mesh((1, 1), device="cuda"))
    params = TPAR.shard_params(
        ST.init_params(cfg, seed=0, device=dev, draw_on_device=True), step.tp)
    gen = torch.Generator(device=dev).manual_seed(27)
    batch = {"tokens": torch.randint(0, cfg.vocab, (MEM_BATCH, TRAIN_SEQ),
                                     device=dev, generator=gen)}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = step.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{cfg.name} loss_and_grads: loss {loss}")
    del params, batch, loss, grads, step
    torch.cuda.empty_cache()
    return base - before, temp


def _synced_s(fn):
    """``fn()`` and its seconds on the host clock, the card synced on
    both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve_tp_check(dev, params, cfg, cell: Serving,
                         prompt: int) -> dict:
    """Part of phase (aa), run on the full-width weights a serving phase
    holds: the ``prompt``-token prefill with ``use_kernels=True`` and
    ``tp=`` (a ``TPContext`` on a one-rank NCCL (1, 1) mesh, where a
    rank's shards are the whole leaves, so the held weights serve as
    they are), then ``SERVE_TP_STEPS`` decode steps with ``tp=``, against
    the same calls without ``tp``: logits within the cell's bf16
    tolerance, the greedy tokens and the caches equal, and the kernels'
    launches per prefill equal.  Each prefill runs twice (the first
    meets the NCCL communicator's set-up); the second is timed.  Returns
    the TP run's launches, the seconds the check took and the timings."""
    t_start = time.time()
    kernels = ("flash_attention", "rglru_scan", "rwkv6_wkv")
    created = TRAIN.init_process_group(dev)
    try:
        mesh = make_debug_mesh((1, 1), device="cuda")
        tp = TPAR.TPContext(cfg, mesh.model)
        toks = torch.from_numpy(np.random.default_rng(prompt).integers(
            0, cfg.vocab, (1, prompt))).to(dev)
        runs = {}
        for name, kw in (("dp", {}), ("tp", {"tp": tp})):
            with torch.no_grad():
                ST.prefill(params, cfg, toks, cell.cache_len,
                           use_kernels=True, **kw)
                K.reset_launches()
                (logits, caches), pre_s = _synced_s(
                    lambda: ST.prefill(params, cfg, toks, cell.cache_len,
                                       use_kernels=True, **kw))
                launches = {k: getattr(K, k).launches for k in kernels}
                first, steps, picked = logits, [], []
                want = runs["dp"]["picked"] if name == "tp" else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(SERVE_TP_STEPS):
                    nxt = logits.argmax(-1)
                    picked.append(int(nxt[0]))
                    feed = (nxt if want is None else
                            torch.full_like(nxt, want[t]))
                    logits, caches = ST.decode_step(
                        params, cfg, caches, feed, prompt + t,
                        route_rows=True, **kw)
                    steps.append(logits)
                torch.cuda.synchronize()
                dec_s = (time.perf_counter() - t0) / SERVE_TP_STEPS
            runs[name] = dict(first=first, steps=steps, caches=caches,
                              picked=picked, launches=launches,
                              prefill_s=pre_s, decode_s=dec_s)
    finally:
        if created:
            dist.destroy_process_group()
    dp, tpr = runs["dp"], runs["tp"]
    d_first = _cache_diff(dp["first"], tpr["first"])
    d_steps = max(_cache_diff(a, b)
                  for a, b in zip(dp["steps"], tpr["steps"]))
    d_cache = _cache_diff(dp["caches"], tpr["caches"])
    print(f"serving under tp, {cfg.name} (one-rank NCCL (1, 1) mesh, "
          f"prompt {prompt}, cache {cell.cache_len}, {SERVE_TP_STEPS} "
          f"decode steps): prefill {tpr['prefill_s'] * 1e3:.2f} ms "
          f"against dp's {dp['prefill_s'] * 1e3:.2f}; decode "
          f"{tpr['decode_s'] * 1e3:.2f} ms a step against "
          f"{dp['decode_s'] * 1e3:.2f} (host clock, synced); max |logit| "
          f"diff prefill {d_first:.4e}, decode {d_steps:.4e} (tolerance "
          f"{cell.logit_tol}); caches max |diff| {d_cache:.4e}; greedy "
          f"tokens equal {tpr['picked'] == dp['picked']}; launches per "
          f"prefill tp {tpr['launches']}, dp {dp['launches']}; card "
          f"{card_line()}")
    if tpr["launches"] != dp["launches"]:
        raise AssertionError(f"{cfg.name} tp prefill launched "
                             f"{tpr['launches']}, dp {dp['launches']}")
    if tpr["picked"] != dp["picked"]:
        raise AssertionError(f"{cfg.name} tp greedy tokens "
                             f"{tpr['picked']} != dp's {dp['picked']}")
    if max(d_first, d_steps) > cell.logit_tol or d_cache != 0.0 or \
            not bool(torch.isfinite(tpr["first"]).all()):
        raise AssertionError(f"{cfg.name} tp against dp: logits "
                             f"{d_first}, {d_steps}; caches {d_cache}")
    return {"arch": cfg.name, "launches": tpr["launches"],
            "seconds": time.time() - t_start,
            "prefill_ms": (tpr["prefill_s"] * 1e3, dp["prefill_s"] * 1e3),
            "decode_ms": (tpr["decode_s"] * 1e3, dp["decode_s"] * 1e3)}


def _sweep_results(art: str, sweep: tuple, deadline: float) -> list:
    """Wait for the sweep (until ``deadline``) and print each
    combination: flops, collectives per op and group size, argument +
    temp GiB per device, ``best_time_s`` and host seconds."""
    proc, start = sweep
    proc.wait(timeout=max(deadline - time.time(), 1.0))
    if proc.returncode != 0:
        log = open(os.path.join(art, "sweep.log")).read()
        raise AssertionError(f"sweep exited {proc.returncode}:\n"
                             f"{log[-3000:]}")
    rows, last = [], start
    for arch, shape in ((a, s) for a in SWEEP_ARCHS for s in SWEEP_SHAPES):
        path = os.path.join(art, "sweep", f"{arch}__{shape}__pod16x16.json")
        last = max(last, os.path.getmtime(path))
        with open(path) as f:
            res = json.load(f)
        if "error" in res:
            raise AssertionError(f"sweep {arch} x {shape}: {res['error']}")
        if not res["applicable"]:
            print(f"sweep {arch} x {shape} x pod16x16: not applicable "
                  f"({res['reason']}); host {res['host_s']} s")
            continue
        coll, mem = res["collectives"], res["memory"]
        per_op = {op: {g: b["count"] for g, b in d["by_group"].items()}
                  for op, d in coll["per_op"].items()}
        gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
        print(f"sweep {arch} x {shape} x {res['mesh']} (rank 0 of 256, "
              f"{res['kind']}, mode {res['mode']}): flops "
              f"{res['flops']:.6e}; collectives by op and group size "
              f"{per_op}; argument + temp {gib:.3f} GiB per device "
              f"(argument {mem['argument_bytes'] / 2**30:.3f}, temp "
              f"{mem['temp_bytes'] / 2**30:.3f}, donated cache "
              f"{mem['alias_bytes'] / 2**30:.3f}); best_time_s "
              f"{res['cluster']['best_time_s']:.6e} "
              f"({res['cluster']['best_algo']}); host {res['host_s']} s "
              f"(fake step {res['fake_step_s']} s)")
        if not (res["flops"] > 0 and gib > 0 and coll["per_op"]):
            raise AssertionError(f"sweep {arch} x {shape}: {res}")
        rows.append(res)
    print(f"sweep: {len(rows)} runs, the last result written "
          f"{last - start:.1f} s after the sweep started, read "
          f"{time.time() - start:.1f} s after")
    return rows


def _memory_points(dev, art: str, points: tuple, deadline: float) -> None:
    """tinyllama-1.1b's decode step at ``MEM_DECODE_ROWS`` rows over
    caches of ``MEM_SEQ`` and its kernel-free prefill of
    ``MEM_PREFILL_ROWS`` x ``MEM_SEQ``, each built by the dry run's own
    builders on the card on a one-rank NCCL (1, 1) mesh: the card's
    arguments and ``max_memory_allocated`` beside the dry run's argument
    + temp on a fake (1, 1) world, gated at ``MEM_POINT_GAP``."""
    proc, _ = points
    proc.wait(timeout=max(deadline - time.time(), 1.0))
    if proc.returncode != 0:
        raise AssertionError(
            f"memory points' dry runs exited {proc.returncode}:\n"
            f"{open(os.path.join(art, 'points.log')).read()[-3000:]}")
    with open(os.path.join(art, "points.json")) as f:
        pred = json.load(f)
    cfg = get_config(ARCH)
    created = TRAIN.init_process_group(dev)
    try:
        mesh = make_debug_mesh((1, 1), device="cuda")
        for shape in ("decode_32k", "prefill_32k"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            step, args, _ = DRY.build_dryrun_serve(
                cfg, mesh, ARCH, shape, device=dev,
                specs=_memory_point_specs(cfg, shape))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, secs = _synced_s(lambda: step(*args))
            peak = torch.cuda.max_memory_allocated()
            logits = out[0]
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"memory point {shape}: logits not "
                                     f"finite")
            del step, args, out, logits
            torch.cuda.empty_cache()
            m = pred[shape]["memory"]
            want = m["argument_bytes"] + m["temp_bytes"]
            got = peak - before
            gap = (want - got) / got
            what = (f"decode step, {MEM_DECODE_ROWS} rows over caches of "
                    f"{MEM_SEQ}" if shape == "decode_32k" else
                    f"kernel-free prefill, {MEM_PREFILL_ROWS} x {MEM_SEQ}")
            print(f"memory point, {ARCH} {what} (one-rank NCCL (1, 1) "
                  f"mesh, {secs * 1e3:.1f} ms): card arguments "
                  f"{(base - before) / 2**30:.3f} GiB, arguments + "
                  f"max_memory_allocated beyond them "
                  f"{got / 2**30:.3f} GiB (temp "
                  f"{(peak - base) / 2**30:.3f}); the dry run's argument + "
                  f"temp {want / 2**30:.3f} GiB (argument "
                  f"{m['argument_bytes'] / 2**30:.3f}, temp "
                  f"{m['temp_bytes'] / 2**30:.3f}; fake (1, 1) world, "
                  f"{pred[shape]['fake_step_s']} s): {gap * 100:+.2f}% off "
                  f"the card; card {card_line()}")
            if abs(gap) > MEM_POINT_GAP:
                raise AssertionError(f"memory point {shape}: the dry run "
                                     f"is {gap * 100:+.2f}% off the card")
    finally:
        if created:
            dist.destroy_process_group()


def phase_serve_tp(dev, art: str, bg: dict, checks: list) -> None:
    """Phase (aa): the serving sweep's dry runs read and printed, the two
    memory points on the card, and the TP-against-dp serving checks (run
    earlier on each serving phase's weights) summed; within
    ``SERVE_TP_LIMIT_S`` with the checks' seconds."""
    t0 = time.time()
    _sweep_results(art, bg["sweep"], t0 + SERVE_TP_LIMIT_S / 2)
    torch.cuda.empty_cache()
    _memory_points(dev, art, bg["points"], t0 + SERVE_TP_LIMIT_S / 2)
    checked = sum(c["seconds"] for c in checks)
    wall = time.time() - t0 + checked
    print(f"phase (aa): {wall:.1f} s (limit {SERVE_TP_LIMIT_S} s), of it "
          f"{checked:.1f} s in the serving checks under tp of "
          f"{[c['arch'] for c in checks]}; launches of their tp prefills "
          f"{[c['launches'] for c in checks]}; card {card_line()}")
    if len(checks) != 4:
        raise AssertionError(f"phase (aa): {len(checks)} serving checks")
    if wall > SERVE_TP_LIMIT_S:
        raise AssertionError(f"phase (aa) took {wall:.1f} s, over "
                             f"{SERVE_TP_LIMIT_S} s")


def phase_dryrun(dev, art: str, dry: list) -> int:
    """Phase (z): the pricing CLIs, the full-width dry runs started with
    the script, and ZeRO-3 on the card; within ``DRYRUN_LIMIT_S``.
    Returns the convert-copy launches of the fsdp_tp run."""
    t0 = time.time()
    _price_cli(art)
    _dryrun_results(art, dry, t0 + DRYRUN_LIMIT_S)
    torch.cuda.empty_cache()
    launches = _zero3_on_card(dev)
    wall = time.time() - t0
    print(f"phase (z): {wall:.1f} s (limit {DRYRUN_LIMIT_S} s); the dry "
          f"runs started {t0 - dry[0][3]:.1f} s before it; card "
          f"{card_line()}")
    if wall > DRYRUN_LIMIT_S:
        raise AssertionError(f"phase (z) took {wall:.1f} s, over "
                             f"{DRYRUN_LIMIT_S} s")
    return launches


# ------------------------------------------------------------ phase (ab)
# search_and_enact's Search Phase and collective counts at full width, run
# on the host beside the card phases in a process of their own (this
# script imported for its constants): the searched Plan saved and loaded
# back (an exact round trip), and each strategy's collectives on the fake
# (4, 2) world by group, data (4 ranks) and model (2)
_ENACT = r"""
import json, sys, time
import chip_smoke as CS
cfg = CS.get_config(CS.ENACT_ARCH)
t0 = time.time()
plan = CS.SE.search(cfg, cluster=CS.ENACT_CLUSTER, streams=CS.ENACT_STREAMS,
                    max_steps=CS.ENACT_MAX_STEPS, reduced=False)
search_s = time.time() - t0
loaded = CS.SE.save_and_load(plan, sys.argv[1] + ".plan.json")
leaves = CS.SE.meta_leaves(cfg)
counts = {}
t0 = time.time()
for name, strat in (("per-tensor", CS.TS.GradSyncStrategy.per_tensor(leaves)),
                    ("plan", loaded.grad_sync(leaves))):
    coll = CS.SE.count_collectives(cfg, strat)
    counts[name] = {g: CS.SE.by_group(coll, CS.SE.MESH[g])
                    for g in ("data", "model")}
prov = plan.provenance
json.dump({"search_s": search_s, "count_s": time.time() - t0,
           "fingerprint": loaded.fingerprint(), "steps": prov["steps"],
           "simulations": prov["simulations"],
           "cost_ms": [prov["initial_cost"] * 1e3, prov["best_cost"] * 1e3],
           "describe": {k: {str(a): b for a, b in v.items()}
                        if isinstance(v, dict) else v
                        for k, v in plan.describe().items()},
           "counts": counts}, open(sys.argv[1], "w"))
"""


def start_enact_search(out: str) -> tuple:
    """Start :data:`_ENACT` on the host beside the other host processes,
    on a core of its own at the lowest priority, writing
    ``out/enact.json`` and the Plan beside it.  Returns ``(process,
    start)``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, here]),
               OMP_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))
    with open(os.path.join(out, "enact.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _ENACT,
                                 os.path.join(out, "enact.json")],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
    os.sched_setaffinity(proc.pid, {cores[-1 - (len(DRYRUNS) + 2)
                                           % len(cores)]})
    os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
    return proc, time.time()


def _staging_checks(dev, strat, leaves) -> float:
    """Each sync kernel the enacted step runs, against its plain version,
    bitwise, bucket by bucket as ``sync_grads`` stages ``strat`` at dp=1,
    on random gradients shaped like ``leaves``: a fused bucket's pack and
    unpack, an unfused one's bucket pack and its cast back, and the
    clip's f32 upcast of each bf16 gradient.  Returns the largest
    error."""
    gen = torch.Generator(device=dev).manual_seed(28)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in leaves]
    err = 0.0
    for bi, b in enumerate(strat.buckets):
        ls = [grads[i] for i in b]
        total = sum(l.numel() for l in ls)
        k = min(strat.chunk_count(bi), total)
        if strat.is_fused(bi):
            parts = K.fused_pack(ls, total, 1, k)
            err = max(err, check_equal(f"fused_pack bucket {bi}", parts,
                                       R.fused_pack_ref(ls, total, 1, k)))
            cuts = R.chunk_cuts(total, k)
            flat = torch.cat([p[:cuts[c + 1] - cuts[c]]
                              for c, p in enumerate(parts)])
            shapes, dtypes = [l.shape for l in ls], [l.dtype for l in ls]
            err = max(err, check_equal(
                f"fused_unpack bucket {bi}",
                K.fused_unpack(parts, shapes, dtypes),
                R.fused_unpack_ref(flat, shapes, dtypes)))
            continue
        f32 = K.bucket_pack(ls, total, torch.float32)
        err = max(err, check_equal(
            f"bucket_pack bucket {bi}", [f32],
            [R.bucket_pack_ref(ls, total, torch.float32)]))
        if all(l.dtype == torch.bfloat16 for l in ls):
            err = max(err, check_equal(
                f"convert_copy bucket {bi}",
                [K.convert_copy(f32, torch.bfloat16)],
                [R.convert_copy_ref(f32, torch.bfloat16)]))
    for g in grads:
        if g.dtype == torch.bfloat16:
            err = max(err, check_equal(
                "convert_copy", [K.convert_copy(g, torch.float32)],
                [R.convert_copy_ref(g, torch.float32)]))
    del grads
    torch.cuda.empty_cache()
    return err


def _enact_full(dev, art: str, bg: tuple, deadline: float) -> dict:
    """search_and_enact at full width: the host process's searched Plan
    (waited for until ``deadline``) loaded, its collectives on the fake
    (4, 2) world against per-tensor's and what its buckets imply; the
    sync kernels of its step held to their plain versions at its shapes;
    one step of it on a one-rank NCCL (1, 1) mesh (``SE.enact``), the
    counters zeroed just before and read just after: each sync kernel and
    collective as often as the Plan implies, no serving kernel, a finite
    loss.  Returns the step's launches and the kernels' largest error."""
    proc, start = bg
    proc.wait(timeout=max(deadline - time.time(), 1.0))
    path = os.path.join(art, "enact.json")
    if proc.returncode != 0:
        log = open(os.path.join(art, "enact.log")).read()
        raise AssertionError(f"search_and_enact's search exited "
                             f"{proc.returncode}:\n{log[-3000:]}")
    res = json.load(open(path))
    cfg = get_config(ENACT_ARCH)
    loaded = RP.Plan.load(path + ".plan.json")
    if loaded.fingerprint() != res["fingerprint"]:
        raise AssertionError("search_and_enact: the saved Plan changed")
    leaves = SE.meta_leaves(cfg)
    strat = loaded.grad_sync(leaves)
    implied = SE.implied_data_counts(strat, leaves)
    counts = res["counts"]
    print(f"search_and_enact {ENACT_ARCH} at full width "
          f"({sum(p.numel() for p in leaves) / 1e9:.3f}B parameters in "
          f"{len(leaves)} leaves): searched on {ENACT_CLUSTER} with "
          f"{ENACT_STREAMS} streams for 4 devices in {res['search_s']:.1f} s "
          f"({res['steps']} steps, {res['simulations']} simulations; "
          f"simulated {res['cost_ms'][0]:.3f} -> {res['cost_ms'][1]:.3f} "
          f"ms; {res['describe']}), on a host core at nice 19 from the "
          f"script's start; the Plan round-trips [{res['fingerprint']}]")
    print(f"search_and_enact collectives of one rank's ddp_tp step on a "
          f"fake (4, 2) world at batch 8 x 64 ({res['count_s']:.1f} s on "
          f"the host for both): data group per-tensor "
          f"{counts['per-tensor']['data']}, DisCo {counts['plan']['data']} "
          f"(the Plan implies {implied}); model group per-tensor "
          f"{counts['per-tensor']['model']}, DisCo "
          f"{counts['plan']['model']}")
    if counts["plan"]["data"] != implied or \
            counts["plan"]["model"] != counts["per-tensor"]["model"] or \
            implied["all-reduce"] > counts["per-tensor"]["data"][
                "all-reduce"]:
        raise AssertionError(f"search_and_enact: collectives {counts}, the "
                             f"Plan implies {implied} on the data group")
    err = _staging_checks(dev, strat, leaves)
    want, calls = implied_counts(strat, leaves, 1)
    K.reset_launches()
    TS.reset_collectives()
    step = SE.enact(cfg, strat, dev)
    launches = {name: getattr(K, name).launches for name in want}
    serving = {name: getattr(K, name).launches
               for name in ("flash_attention", "rglru_scan", "rwkv6_wkv")}
    coll = dict(TS.COLLECTIVES)
    print(f"search_and_enact: one step of the loaded Plan on a one-rank "
          f"NCCL (1, 1) mesh, batch 8 x 64: loss {step['loss']:.4f}, grad "
          f"norm {step['grad_norm']:.4f}, {step['step_s'] * 1e3:.1f} ms "
          f"(host clock, synced; the first step); launches {launches}, "
          f"collectives {coll} (the Plan implies {want}, {calls}); the "
          f"staging kernels bitwise equal to their plain versions at its "
          f"shapes; card {card_line()}")
    if launches != want or coll != calls or any(serving.values()) or \
            not math.isfinite(step["loss"]):
        raise AssertionError(f"search_and_enact step: launches {launches}, "
                             f"collectives {coll}, serving {serving}, loss "
                             f"{step['loss']}; the Plan implies {want}, "
                             f"{calls}")
    return {"launches": launches, "err": err}


def _train_lm() -> dict:
    """The train_lm twin at its defaults (reduced qwen2-0.5b, 200 steps of
    16 x 64, ``--strategy auto``), the counters zeroed just before and
    read just after: the sync kernels as often as its Plan implies, the
    loss at the last log below the first.  Returns the launches."""
    cfg = get_config(ENACT_ARCH).reduced()
    K.reset_launches()
    TS.reset_collectives()
    t0 = time.time()
    out = TLM.main([])
    secs = time.time() - t0
    leaves = ST.leaves(meta_params(cfg))
    want, calls = implied_counts(out["plan"].grad_sync(leaves), leaves,
                                 len(out["losses"]))
    launches = {name: getattr(K, name).launches for name in want}
    coll = dict(TS.COLLECTIVES)
    losses = out["losses"]
    print(f"train_lm (reduced {ENACT_ARCH}, {len(losses)} steps of 16 x 64, "
          f"--strategy auto): {secs:.1f} s in all, step "
          f"{statistics.median(out['step_seconds'][1:]) * 1e3:.2f} ms "
          f"(median, host clock, synced); loss {losses[0]:.4f} at the "
          f"first log, {losses[-1]:.4f} at the last; launches {launches}, "
          f"collectives {coll} (the Plan implies {want}, {calls})")
    if launches != want or coll != calls or not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm: launches {launches}, collectives "
                             f"{coll}, losses {losses[0]} -> {losses[-1]}")
    return launches


def _serve_decode_cli() -> int:
    """The serve_decode twin's CLI at its defaults (reduced tinyllama-1.1b,
    8 prompts of 32, 64 new tokens; prefill through flash), the counters
    zeroed just before and read just after: one flash launch a layer.
    Returns the flash launches."""
    n = get_config(ARCH).reduced().n_layers
    K.reset_launches()
    out = SD.main([])
    flash = K.flash_attention.launches
    if flash != n or tuple(out["tokens"].shape) != (8, 65):
        raise AssertionError(f"serve_decode CLI: flash {flash} (want {n}), "
                             f"tokens {tuple(out['tokens'].shape)}")
    return flash


def phase_decode_check(dev, params, cfg, cell: Serving) -> dict:
    """Part of phase (ab), on the full-width weights a serving phase holds:
    serve_decode's loop (``SD.decode``: ``DECODE_ROWS`` prompts of
    ``DECODE_PROMPT``, ``DECODE_NEW`` greedy steps, the prefill through the
    kernels, after a warm-up prefill), the counters zeroed just before
    and read just after (one prefill: one flash, RG-LRU or WKV-6 launch a
    layer of that kind);
    then a kernel-free prefill and ``DECODE_CHECK_STEPS`` steps fed the
    kernel run's tokens: logits within the cell's bf16 tolerance at every
    step, the greedy picks counted.  Returns the launches, seconds and
    timings."""
    t_start = time.time()
    kernels = ("flash_attention", "rglru_scan", "rwkv6_wkv")
    # a prefill of the same prompts first, so the timed one meets no
    # first call's set-up
    SD.decode(cfg, dev, batch=DECODE_ROWS, prompt_len=DECODE_PROMPT,
              new_tokens=0, params=params)
    K.reset_launches()
    out = SD.decode(cfg, dev, batch=DECODE_ROWS, prompt_len=DECODE_PROMPT,
                    new_tokens=DECODE_NEW, params=params)
    launches = {k: getattr(K, k).launches for k in kernels}
    kinds = [cfg.block_kind(li) for li in range(cfg.n_layers)]
    want = {"flash_attention": kinds.count("attn"),
            "rglru_scan": kinds.count("rec"),
            "rwkv6_wkv": kinds.count("rwkv")}
    toks = out["tokens"]
    prompts = materialize_batch(cfg, DECODE_ROWS, DECODE_PROMPT,
                                device=dev)["tokens"]
    with torch.no_grad():
        lp, caches = ST.prefill(params, cfg, prompts,
                                DECODE_PROMPT + DECODE_NEW)
        plain = [lp]
        for t in range(DECODE_CHECK_STEPS):
            lp, caches = ST.decode_step(params, cfg, caches, toks[:, t],
                                        DECODE_PROMPT + t)
            plain.append(lp)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(out["logits"], plain))
    same = sum(int((toks[:, t] == p.argmax(-1)).sum())
               for t, p in enumerate(plain))
    picks = len(plain) * DECODE_ROWS
    step_ms = out["decode_s"] / DECODE_NEW * 1e3
    print(f"serve_decode {cfg.name} at full width ({DECODE_ROWS} prompts of "
          f"{DECODE_PROMPT}, {DECODE_NEW} new tokens): prefill "
          f"{out['prefill_s'] * 1e3:.2f} ms, {step_ms:.2f} ms a step, "
          f"{DECODE_ROWS * DECODE_NEW / out['decode_s']:.0f} tokens/s (host "
          f"clock, synced); launches "
          f"{launches} (one prefill implies {want}); against a kernel-free "
          f"prefill and {DECODE_CHECK_STEPS} steps fed the same tokens: max "
          f"|logit diff| {diff:.4e} (tolerance {cell.logit_tol}), greedy "
          f"picks equal {same} of {picks}; continuation of row 0 "
          f"{toks[0, :16].tolist()}; card {card_line()}")
    if launches != want or diff > cell.logit_tol or \
            not bool(torch.isfinite(out["logits"][-1]).all()):
        raise AssertionError(f"serve_decode {cfg.name}: launches {launches} "
                             f"(want {want}), logits {diff}")
    return {"arch": cfg.name, "launches": launches,
            "seconds": time.time() - t_start, "same": (same, picks),
            "prefill_ms": out["prefill_s"] * 1e3, "step_ms": step_ms}


def phase_int8_tp(dev, params, cfg) -> dict:
    """Part of phase (ab), on full tinyllama-1.1b's held weights: the int8
    KV cache under ``tp=`` (a one-rank NCCL (1, 1) mesh), ``A8_STEPS``
    decode steps from a sharded ``init_cache`` of ``A8_ROWS`` x
    ``A8_CACHE`` on seeded tokens, against the same steps without ``tp``:
    logits, int8 entries and scales bit for bit equal.  Returns the
    seconds and each run's ms a step."""
    t_start = time.time()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = torch.from_numpy(np.random.default_rng(28).integers(
        0, cfg.vocab, (A8_STEPS, A8_ROWS))).to(dev)
    created = TRAIN.init_process_group(dev)
    try:
        tp = TPAR.TPContext(cfg8, make_debug_mesh((1, 1),
                                                  device="cuda").model)
        # the model group's NCCL communicator set up before any timing
        tp.all_reduce(torch.zeros((), device=dev))
        runs = {}
        for name, kw in (("dp", {}), ("tp", {"tp": tp})):
            caches = ST.init_cache(cfg8, A8_ROWS, A8_CACHE, device=dev)
            if kw:
                caches = TPAR.shard_caches(caches, tp)
            logits = []
            with torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(A8_STEPS):
                    lg, caches = ST.decode_step(params, cfg8, caches,
                                                toks[t], t, **kw)
                    logits.append(lg)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / A8_STEPS * 1e3
            if kw:
                caches = TPAR.gather_caches(caches, tp)
            runs[name] = (logits, caches, ms)
    finally:
        if created:
            dist.destroy_process_group()
    (ld, cd, ms_dp), (lt, ct, ms_tp) = runs["dp"], runs["tp"]
    same_logits = all(torch.equal(bits(a), bits(b)) for a, b in zip(ld, lt))
    same_cache = all(torch.equal(a, b) for a, b in
                     zip(T.leaves(cd), T.leaves(ct)))
    names = sorted({p.rsplit("[", 1)[-1].strip("']")
                    for p, _ in T.leaves_with_paths(ct)})
    print(f"int8 KV cache under tp, {cfg.name} ({A8_ROWS} rows x cache "
          f"{A8_CACHE}, {A8_STEPS} decode steps from a sharded init_cache "
          f"on a one-rank NCCL (1, 1) mesh): logits bit for bit equal to "
          f"dp's {same_logits}, cache leaves {names} equal {same_cache}; "
          f"{ms_tp:.2f} ms a step against dp's {ms_dp:.2f} (host clock, "
          f"synced); card {card_line()}")
    if not (same_logits and same_cache):
        raise AssertionError(f"int8 under tp: logits equal {same_logits}, "
                             f"caches equal {same_cache}")
    return {"seconds": time.time() - t_start, "ms": (ms_tp, ms_dp)}


def phase_examples(dev, art: str, bg: tuple, checks: list) -> tuple:
    """Phase (ab): search_and_enact at full width, the train_lm twin, the
    serve_decode CLI, and the checks run earlier on held weights
    (serve_decode at full width, the int8 cache under tp) summed; within
    ``EXAMPLES_LIMIT_S``.  Returns the phase's launches by kernel and the
    sync kernels' largest error against their plain versions."""
    t0 = time.time()
    enact = _enact_full(dev, art, bg, t0 + EXAMPLES_LIMIT_S / 2)
    train = _train_lm()
    flash_cli = _serve_decode_cli()
    checked = sum(c["seconds"] for c in checks)
    wall = time.time() - t0 + checked
    launches = {k: enact["launches"].get(k, 0) + train.get(k, 0)
                for k in ("convert_copy", "bucket_pack", "fused_pack",
                          "fused_unpack")}
    for k in ("flash_attention", "rglru_scan", "rwkv6_wkv"):
        launches[k] = sum(c.get("launches", {}).get(k, 0) for c in checks)
    launches["flash_attention"] += flash_cli
    print(f"phase (ab): {wall:.1f} s (limit {EXAMPLES_LIMIT_S} s), of it "
          f"{checked:.1f} s in the checks on held weights; launches "
          f"{launches} (the enacted Plan's step {enact['launches']}, "
          f"train_lm {train}, serve_decode's CLI flash {flash_cli}, full "
          f"width {[c.get('launches') for c in checks]}); card "
          f"{card_line()}")
    if wall > EXAMPLES_LIMIT_S:
        raise AssertionError(f"phase (ab) took {wall:.1f} s, over "
                             f"{EXAMPLES_LIMIT_S} s")
    return launches, enact["err"]


def phase_flash_coder(dev) -> dict:
    """Part of phase (ac): flash attention at deepseek-coder-33b's prefill
    shape, q (1,S,56,128) over k and v (1,S,8,128), bf16, causal, at S in
    ``CODER_FLASH_SEQS`` (1 and 129 off the kernel's 128-key tiles):
    checked, timed and reported as in (c); then the head mapping at S =
    2048, with each KV head's v the KV head's index, so every query head
    h must put out h // 7 at every row (softmax weights sum to one; another
    KV head's index is at least 1 away, so within 0.25 tells them apart).
    Returns the numbers at S = 2048 with the largest error."""
    gen = torch.Generator(device=dev).manual_seed(29)
    cfg = get_config(CODER_ARCH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    res = {S: _flash_path_shape(
        f"{CODER_ARCH} bf16 S={S}",
        *_flash_inputs(gen, dev, S, S, H, KV, hd, torch.bfloat16))
        for S in CODER_FLASH_SEQS}
    q, k, _ = _flash_inputs(gen, dev, 2048, 2048, H, KV, hd, torch.bfloat16)
    v = torch.arange(KV, device=dev, dtype=torch.bfloat16)[
        None, None, :, None].expand(1, 2048, KV, hd).contiguous()
    got = K.flash_attention(q, k, v)
    want = (torch.arange(H, device=dev) // (H // KV)).float()
    off = (got.float() - want[None, None, :, None]).abs()
    wrong = int((off > 0.25).sum())
    print(f"kernel flash_attention {CODER_ARCH} head mapping (S=2048, {H} "
          f"query heads over {KV} KV heads, each KV head's v its index): "
          f"{wrong} of {got.numel()} outputs more than 0.25 from h // "
          f"{H // KV} (max |diff| {float(off.max()):.3e})")
    if wrong:
        raise AssertionError(f"flash_attention {CODER_ARCH}: {wrong} "
                             f"outputs read the wrong KV head")
    # an empty dict: the library was already built, no log to read
    if FLASH_TC_PTXAS and ("bf16", hd) not in FLASH_TC_PTXAS:
        raise AssertionError(f"no ptxas entry for the bf16 hd {hd} "
                             f"instance in this run's build log")
    out = dict(res[max(CODER_FLASH_SEQS)])
    out["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return out


def _coder_kernel_free_check(dev, params, cfg) -> dict:
    """Part of phase (ac), as (ab)'s serve_decode comparison: the 2048-token
    prompt's prefill through the kernel, then ``CODER_CHECK_STEPS`` greedy
    decode steps from its cache, against a kernel-free prefill of the same
    tokens and the same steps fed the kernel run's tokens: the largest
    |logit| difference over the prefill and every step (under the cell's
    tolerance) and the greedy picks that agree.  Returns the gap, the
    picks and the kernel prefill's flash launches."""
    S = max(CODER.extra_prompts)
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, cfg.vocab, (1, S))).to(dev)
    runs = {}
    for name, kernels in (("kernel", True), ("kernel-free", False)):
        K.reset_launches()
        with torch.no_grad():
            lg, caches = ST.prefill(params, cfg, toks, CODER.cache_len,
                                    use_kernels=kernels)
            launches = K.flash_attention.launches
            logits, picks = [lg], [lg.argmax(-1)]
            feed = runs["kernel"]["picks"] if name != "kernel" else None
            for t in range(CODER_CHECK_STEPS):
                nxt = picks[-1] if feed is None else feed[t]
                lg, caches = ST.decode_step(params, cfg, caches, nxt, S + t)
                logits.append(lg)
                picks.append(lg.argmax(-1))
        del caches
        runs[name] = {"logits": logits, "picks": picks,
                      "launches": launches}
    kr, fr = runs["kernel"], runs["kernel-free"]
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(kr["logits"], fr["logits"]))
    same = sum(int((a == b).sum()) for a, b in zip(kr["picks"],
                                                   fr["picks"]))
    scale = float(fr["logits"][0].float().abs().max())
    print(f"{CODER_ARCH} prefill of {S} tokens with flash ({kr['launches']} "
          f"launches) against without it ({fr['launches']}), then "
          f"{CODER_CHECK_STEPS} decode steps fed the kernel run's tokens: max "
          f"|logit diff| {diff:.4e} at max |logit| {scale:.3f} (tolerance "
          f"{CODER.logit_tol}), greedy picks equal {same} of "
          f"{len(kr['picks'])}; card {card_line()}")
    if (kr["launches"], fr["launches"]) != (cfg.n_layers, 0):
        raise AssertionError(f"{CODER_ARCH} check prefills launched flash "
                             f"{kr['launches']} and {fr['launches']} times")
    if not diff <= CODER.logit_tol or not all(
            bool(torch.isfinite(x).all()) for x in kr["logits"]):
        raise AssertionError(f"{CODER_ARCH}: kernel prefill differs from "
                             f"kernel-free by {diff} > {CODER.logit_tol}")
    return {"diff": diff, "same": (same, len(kr["picks"])),
            "launches": kr["launches"]}


def phase_coder(dev) -> tuple:
    """Phase (ac): full deepseek-coder-33b served on the card.  Flash at
    its prefill shape (:func:`phase_flash_coder`); the weights drawn on
    the card (seed 0, one layer at a time); the reduced model's engine on
    the card against the CPU; the kernel-free check; the 2048-token
    prefill timed with and without the kernel and traced; a decode step
    timed and traced; then the cell's 19 requests through ``ServeEngine``
    (every request in full, flash 62 times a prefill on the tensor
    cores).  Within ``CODER_SERVE_LIMIT_S``.  Returns flash's numbers at
    the prefill shape, the serving run's launches and the check's flash
    launches."""
    t0 = time.time()
    cfg = get_config(CODER_ARCH)
    flash = phase_flash_coder(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True,
                            by_layer=True)
    torch.cuda.synchronize()
    leaves = ST.leaves(params)
    nbytes = sum(p.numel() * p.element_size() for p in leaves)
    print(f"{CODER_ARCH}: {sum(p.numel() for p in leaves) / 1e9:.4f}B "
          f"parameters in {len(leaves)} leaves, {nbytes / 1e9:.3f} GB "
          f"({nbytes / 2**30:.2f} GiB; dtypes "
          f"{sorted({str(p.dtype) for p in leaves})}) drawn on the card in "
          f"{time.time() - t1:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_reduced_engine(dev, cfg, CODER)
    check = _coder_kernel_free_check(dev, params, cfg)
    toks = torch.from_numpy(np.random.default_rng(2048).integers(
        0, cfg.vocab, (1, max(CODER.extra_prompts)))).to(dev)
    for use_kernels in (True, False):
        times = []
        for _ in range(3):
            with torch.no_grad():
                _, dt = _synced_s(lambda: ST.prefill(
                    params, cfg, toks, CODER.cache_len,
                    use_kernels=use_kernels))
            times.append(dt)
        print(f"prefill {CODER_ARCH} {toks.shape[1]} tokens, use_kernels="
              f"{use_kernels}: {statistics.median(times) * 1e3:.1f} ms "
              f"(median of 3, host clock, synced)")
    phase_prefill_trace(params, cfg, toks, CODER.cache_len)
    phase_decode_trace(dev, params, cfg, CODER.cache_len)
    torch.cuda.empty_cache()
    served, _, peak = phase_serving(dev, params, cfg, CODER)
    cap = torch.cuda.get_device_properties(dev).total_memory
    del params
    torch.cuda.empty_cache()
    wall = time.time() - t0
    print(f"phase (ac): {wall:.1f} s (limit {CODER_SERVE_LIMIT_S} s); "
          f"serving peak {peak / 2**30:.2f} GiB of the card's "
          f"{cap / 2**30:.2f} GiB; card {card_line()}")
    if peak >= cap:
        raise AssertionError(f"phase (ac): peak {peak} >= {cap}")
    if wall > CODER_SERVE_LIMIT_S:
        raise AssertionError(f"phase (ac) took {wall:.1f} s, over "
                             f"{CODER_SERVE_LIMIT_S} s")
    return flash, served, check["launches"]


# phase (ad): the coder cell's training attention (B, S, H, KV, hd),
# causal; the serving shapes of the forward re-timed (name, S, H, KV, hd,
# window), B = 1 and causal as in (c); the largest share of the largest
# |gradient| the kernel's gradients may be off autograd of the plain
# version on f32 copies (tests/test_torch_cuda.py's BWD_TOL for bf16)
TRAIN_ATTN = (2, 4096, 56, 8, 128)
SERVING_FLASH_ROWS = (("tinyllama", 2048, 32, 4, 64, None),
                      ("recurrentgemma", 2048, 16, 1, 256, 2048),
                      ("paligemma", 2048, 8, 1, 256, None),
                      ("seamless", 2048, 16, 16, 64, None),
                      ("deepseek-coder", 2048, 56, 8, 128, None))
FLASH_BWD_TOL = 1e-2


def flash_bwd_bound(B, S, H, KV, hd) -> tuple[float, str]:
    """The least time for the causal backward at self-attention shape:
    five products of the forward's size (S again, dP, dV, dK, dQ) over the
    bf16 peak, against q, k, v, o, dO and the log-sum-exp read and dq, dk,
    dv written once over HBM bandwidth."""
    flops = 2.5 * flash_flops(B, S, S, H, hd, True)
    nbytes = 2 * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_flash_train(dev) -> dict:
    """Phase (ad): flash attention's forward with the log-sum-exp and its
    backward at the coder cell's training shape, checked and timed; the
    serving shapes of the forward re-timed without and with the
    log-sum-exp where the kernel stores it.  Returns the timed numbers."""
    B, S, H, KV, hd = TRAIN_ATTN
    gen = torch.Generator(device=dev).manual_seed(34)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    before = (K.flash_attention.lse_launches, K.flash_attention.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(K.flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    used = (K.flash_attention.lse_launches - before[0],
            K.flash_attention.bwd_launches - before[1])
    if used != (1, 1):
        raise AssertionError(f"flash_attention training: {used} launches of "
                             f"the forward with the log-sum-exp and the "
                             f"backward, not (1, 1)")
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(R.flash_attention_ref(*f32), f32, do.float())
    errs = {}
    for name, g, w in zip("qkv", got, want):
        scale = float(w.abs().max())
        errs[name] = float((g.float() - w).abs().max()) / scale
        if not errs[name] <= FLASH_BWD_TOL:
            raise AssertionError(f"flash_attention backward d{name}: off the "
                                 f"plain version on f32 copies by "
                                 f"{errs[name]:.3e} of its largest value")
    del got, want, f32, leaves
    torch.cuda.empty_cache()
    o, lse = K.flash_attention_lse(q, k, v)
    fwd = time_ms(lambda: K.flash_attention(q, k, v))
    fwd_lse = time_ms(lambda: K.flash_attention_lse(q, k, v))
    bwd = time_ms(lambda: K.flash_attention_bwd(q, k, v, o, lse, do))
    pl = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = time_ms(lambda: torch.autograd.grad(
        L._flash_xla(*pl, True, None), pl, do), reps=5)
    st = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    sout = F.scaled_dot_product_attention(*st, is_causal=True,
                                          enable_gqa=True)
    lib = time_ms(lambda: torch.autograd.grad(sout, st, do.transpose(1, 2),
                                              retain_graph=True))
    with torch.no_grad():
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *st, is_causal=True, enable_gqa=True))
    del pl, st, sout, o, lse
    torch.cuda.empty_cache()
    fb, fby = flash_bound(B, S, S, H, KV, hd, torch.bfloat16, True)
    bb, bby = flash_bwd_bound(B, S, H, KV, hd)
    print(f"kernel flash_attention with lse (training, q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} causal): ms={fwd_lse:.4f} (without lse "
          f"{fwd:.4f}, {100 * (fwd_lse / fwd - 1):+.2f}%) bound_ms={fb:.5f} "
          f"({fby}) library_ms={lib_fwd:.4f} "
          f"{flash_flops(B, S, S, H, hd, True) / fwd_lse / 1e9:.1f} TFLOP/s")
    print(f"kernel flash_attention_bwd (training, same shape): gradients off "
          f"the plain version on f32 copies by dq {errs['q']:.3e}, dk "
          f"{errs['k']:.3e}, dv {errs['v']:.3e} of their largest values "
          f"(limit {FLASH_BWD_TOL}); ms={bwd:.4f} bound_ms={bb:.5f} ({bby}, "
          f"{bwd / bb:.2f}x) "
          f"{2.5 * flash_flops(B, S, S, H, hd, True) / bwd / 1e9:.1f} "
          f"TFLOP/s library_ms={lib:.4f} (SDPA's backward); forward with "
          f"lse + backward {fwd_lse + bwd:.4f} ms, plain_ms={plain:.4f} (the "
          f"chunked path's forward and backward), SDPA's "
          f"{lib_fwd + lib:.4f}")
    rows = {}
    for name, S2, H2, KV2, hd2, window in SERVING_FLASH_ROWS:
        sq, sk, sv = _flash_inputs(gen, dev, S2, S2, H2, KV2, hd2,
                                   torch.bfloat16)
        t0 = time_ms(lambda: K.flash_attention(sq, sk, sv, window=window))
        with_lse = ""
        if hd2 in K.FLASH_BWD_HEAD_DIMS:
            t1 = time_ms(lambda: K.flash_attention_lse(sq, sk, sv,
                                                       window=window))
            with_lse = f", {t1:.4f} with lse ({100 * (t1 / t0 - 1):+.2f}%)"
        rows[name] = t0
        print(f"kernel flash_attention {name} serving shape q {tuple(sq.shape)}"
              f" kv {tuple(sk.shape)} window {window}: ms={t0:.4f}{with_lse}")
    print(f"phase (ad): card {card_line()}")
    return {"fwd_ms": fwd, "fwd_lse_ms": fwd_lse, "bwd_ms": bwd,
            "fwd_bound_ms": fb, "bwd_bound_ms": bb, "plain_ms": plain,
            "library_ms": lib, "library_fwd_ms": lib_fwd, "errs": errs,
            "serving": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--only", "ad"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_card_and_build()
        train_attn = phase_flash_train(dev)
        print(json.dumps({"training_attention": train_attn}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    art = tempfile.mkdtemp(prefix="chip_smoke_")
    dry = start_dryruns(art)
    bg = start_serving_dryruns(art)
    bg["enact"] = start_enact_search(art)
    try:
        return run(art, dry, bg)
    finally:
        for proc in [r[2] for r in dry] + [p for p, _ in bg.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(art, ignore_errors=True)


def run(art: str, dry: list, bg: dict) -> int:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    phase_card_and_build()
    # the main path's leaves (shapes and dtypes only) and 25 MiB buckets
    leaves = ST.leaves(meta_params(get_config(ARCH)))
    strat = TS.GradSyncStrategy.size_capped(leaves)
    res = phase_kernels(dev, strat, leaves)
    res["flash_attention"] = phase_flash(dev)
    res["rglru_scan"] = phase_rglru(dev)
    res["flash_attention"]["max_abs_err"] = max(
        res["flash_attention"]["max_abs_err"],
        phase_flash_recurrentgemma(dev))
    res["rwkv6_wkv"] = phase_wkv6(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches, plan = phase_training(dev, tmp, strat, leaves)
        phase_trace(plan)
        res["bucket_pack"], launches["bucket_pack"] = phase_unfused_buckets(
            dev, tmp, strat, leaves)
        err, step_s = phase_search(dev, tmp, leaves)
        shutil.copy(os.path.join(tmp, "searched.json"),
                    os.path.join(art, "plan.json"))
        err_gnn = phase_estimator(dev, tmp, leaves, step_s)
        phase_tensor_parallel(tmp, strat, leaves)
        res["bucket_pack"]["max_abs_err"] = max(
            res["bucket_pack"]["max_abs_err"], err, err_gnn)
    torch.cuda.empty_cache()

    cfg = get_config(ARCH)
    params = ST.init_params(cfg, seed=0, device=dev)
    phase_serving_checks(dev, params, cfg, TINYLLAMA)
    served, m, peak = phase_serving(dev, params, cfg, TINYLLAMA)
    flash_layers = phase_layers(dev, params, cfg)
    served_plan = phase_serving_plan(dev, params, cfg,
                                     {"metrics": m, "peak": peak}, art)
    tp_checks = [phase_serve_tp_check(dev, params, cfg, TINYLLAMA,
                                      max(TINYLLAMA.extra_prompts))]
    ab_checks = [phase_decode_check(dev, params, cfg, TINYLLAMA),
                 phase_int8_tp(dev, params, cfg)]
    del params
    torch.cuda.empty_cache()

    # full-size weights drawn on the card: billions of normals from a CUDA
    # generator, where the host would take minutes
    served_by = {}
    for cell in (RECURRENTGEMMA, RWKV6):
        cfg = get_config(cell.arch)
        t1 = time.time()
        params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
        torch.cuda.synchronize()
        print(f"{cell.arch}: "
              f"{sum(p.numel() for p in ST.leaves(params)) / 1e9:.2f}B "
              f"parameters in {len(ST.leaves(params))} leaves drawn on the "
              f"card in {time.time() - t1:.1f} s")
        phase_serving_checks(dev, params, cfg, cell)
        served_by[cell.arch], _, _ = phase_serving(dev, params, cfg, cell)
        tp_checks.append(phase_serve_tp_check(dev, params, cfg, cell,
                                              max(cell.extra_prompts)))
        if cell is RWKV6:
            ab_checks.append(phase_decode_check(dev, params, cfg, cell))
        del params
        torch.cuda.empty_cache()
    served_ds = phase_deepseek(dev, tp_checks)
    phase_int8(dev)
    t_mm = time.time()
    mm_launches = {}
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        err, mm_launches[arch] = phase_multimodal(dev, arch)
        res["flash_attention"]["max_abs_err"] = max(
            res["flash_attention"]["max_abs_err"], err)
    print(f"phases (w) and (x): {time.time() - t_mm:.1f} s (limit "
          f"{MM_LIMIT_S} s)")
    if time.time() - t_mm > MM_LIMIT_S:
        raise AssertionError(f"phases (w) and (x) took "
                             f"{time.time() - t_mm:.1f} s, over "
                             f"{MM_LIMIT_S} s")
    phase_train_blocks(dev)
    zero3_convert = phase_dryrun(dev, art, dry)
    launches["convert_copy"] += zero3_convert
    phase_serve_tp(dev, art, bg, tp_checks)
    ab, ab_err = phase_examples(dev, art, bg["enact"], ab_checks)
    res["bucket_pack"]["max_abs_err"] = max(
        res["bucket_pack"]["max_abs_err"], ab_err)
    coder_flash, served_coder, coder_check = phase_coder(dev)
    train_attn = phase_flash_train(dev)
    res["flash_attention"]["max_abs_err"] = max(
        res["flash_attention"]["max_abs_err"], coder_flash["max_abs_err"])
    tp_launches = {k: sum(c["launches"][k] for c in tp_checks)
                   for k in ("flash_attention", "rglru_scan", "rwkv6_wkv")}
    served_rg, served_rwkv = served_by[RG_ARCH], served_by[RWKV_ARCH]
    if any(served_ds.values()):
        raise AssertionError(f"{DS_ARCH} serving launched {served_ds}")
    launches["flash_attention"] = (served["flash_attention"]
                                   + served_rg["flash_attention"]
                                   + flash_layers
                                   + served_plan["flash_attention"]
                                   + sum(mm_launches.values())
                                   + tp_launches["flash_attention"]
                                   + served_coder["flash_attention"])
    launches["rglru_scan"] = (served_rg["rglru_scan"]
                              + tp_launches["rglru_scan"])
    launches["rwkv6_wkv"] = (served_rwkv["rwkv6_wkv"]
                             + tp_launches["rwkv6_wkv"])
    for name, n in ab.items():
        launches[name] += n
    print(f"convert_copy launches: {launches['convert_copy']} "
          f"({launches['convert_copy'] - zero3_convert - ab['convert_copy']}"
          f" on the training path of (g), {zero3_convert} by the fsdp_tp "
          f"clip of (z), {ab['convert_copy']} in (ab)); (ab)'s launches "
          f"{ab}")
    print(f"launches on the serving paths: flash_attention "
          f"{served['flash_attention']} ({ARCH}) + "
          f"{served_rg['flash_attention']} ({RG_ARCH}) + {flash_layers} "
          f"(per-layer prefill) + {served_plan['flash_attention']} "
          f"({ARCH}, serving plan) + {mm_launches[VLM_ARCH]} ({VLM_ARCH} "
          f"prefill) + {mm_launches[ENCDEC_ARCH]} ({ENCDEC_ARCH} prefill) "
          f"+ {tp_launches['flash_attention']} (tp prefills, (aa)) + "
          f"{ab['flash_attention']} (serve_decode, (ab)) + "
          f"{served_coder['flash_attention']} ({CODER_ARCH}, (ac); its "
          f"kernel-free check's prefill {coder_check} more), rglru_scan "
          f"{served_rg['rglru_scan']} ({RG_ARCH}) + "
          f"{tp_launches['rglru_scan']} (aa), rwkv6_wkv "
          f"{served_rwkv['rwkv6_wkv']} ({RWKV_ARCH}) + "
          f"{tp_launches['rwkv6_wkv']} (aa) + {ab['rwkv6_wkv']} (ab)")
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
                "bound_ms": res[name]["bound_ms"],
                "bound_by": res[name]["bound_by"],
                "library_ms": res[name]["library_ms"]}
               for name in REPLACES]
    print(f"total {time.time() - t0:.1f} s")
    # again at the end, beside the numbers, where a cut log keeps it
    print(f"card (nvidia-smi name, power.limit): {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"training_attention": train_attn}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
