"""Assigned input shapes, per-arch applicability and the dry run's
training settings (port of ``repro/launch/shapes.py``; the port's only
copy of ``SHAPES``).

Shapes:
    train_4k     seq 4096,    global_batch 256   (training)
    prefill_32k  seq 32768,   global_batch 32    (inference prefill)
    decode_32k   seq 32768,   global_batch 128   (decode: 1 new token, KV
                                                  cache of seq_len)
    long_500k    seq 524288,  global_batch 1     (long-context decode --
                                                  sub-quadratic archs only)

:func:`input_specs` gives meta tensors where the reference gives
``ShapeDtypeStruct``s; tokens are int64, as in every batch of the port.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# activation-stash budget: grad-accum factors chosen so remat-stashed layer
# inputs stay ~<=8 GB/device at single-pod local batch
GRAD_ACCUM = {
    "stablelm-1.6b": 2, "paligemma-3b": 2, "qwen2-0.5b": 1,
    "deepseek-v2-lite-16b": 4, "deepseek-v2-236b": 16,
    "deepseek-coder-33b": 16, "seamless-m4t-medium": 1,
    "recurrentgemma-9b": 8, "rwkv6-3b": 4, "tinyllama-1.1b": 2,
}  # clamped to the local batch per mesh by the dry run

# archs whose replicated weights+optimizer exceed one 16-way TP shard ->
# ZeRO-3 (mode "fsdp_tp"; no DisCo bucket enactment)
FSDP_ARCHS = {"deepseek-v2-236b", "deepseek-coder-33b"}

# large ddp_tp archs where ZeRO-1 moment sharding could apply; the dry run
# leaves it off for all of them, as the reference's does
ZERO1_ARCHS: set = set()

SW_WINDOW = 4096  # sliding-window variant for dense archs on long_500k


def applicability(cfg: ModelConfig, shape: str):
    """-> (ok, reason, cfg_variant).  Encodes the long_500k sub-quadratic
    rule and the dense sliding-window variant."""
    if shape != "long_500k":
        return True, "", cfg
    if cfg.recurrent is not None or cfg.block == "rwkv":
        return True, "native sub-quadratic (SSM/hybrid)", cfg
    if (cfg.arch_type == "dense" and cfg.block == "attn"
            and cfg.encdec is None and not cfg.vlm_prefix_len):
        return True, f"sliding-window variant (w={SW_WINDOW})", \
            dataclasses.replace(cfg, window=SW_WINDOW)
    return False, ("full softmax attention over a 524k cache is quadratic-"
                   "cost/HBM-infeasible; skipped per spec"), cfg


def cache_capacity(cfg: ModelConfig, seq: int) -> int:
    """Decode-cache length: window-capped for sliding-window archs."""
    if cfg.window:
        return min(seq, cfg.window)
    return seq


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta tensors standing in for every model input of this step kind:
    the global batch, no memory."""
    import torch

    from ..models import stacked as ST

    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    dt = getattr(torch, cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if info["kind"] in ("train", "prefill"):
        specs = {"tokens": meta((B, S), torch.int64)}
        if cfg.vlm_prefix_len:
            specs["prefix_emb"] = meta((B, cfg.vlm_prefix_len, cfg.d_model),
                                       dt)
        if cfg.encdec is not None:
            specs["enc_frames"] = meta(
                (B, cfg.encdec.enc_seq, cfg.encdec.frontend_dim), dt)
        return specs
    # decode: one token + cache + position (+ encoder memory for enc-dec)
    specs = {
        "token": meta((B,), torch.int64),
        "pos": meta((), torch.int64),
        "caches": ST.init_cache(cfg, B, cache_capacity(cfg, S),
                                device="meta"),
    }
    if cfg.encdec is not None:
        specs["memory"] = meta((B, cfg.encdec.enc_seq, cfg.d_model), dt)
    return specs
