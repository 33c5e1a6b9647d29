"""Analytic per-device FLOP / HBM-byte / ICI-byte model per (arch x shape)
(port of ``repro/core/analytic.py``, numpy only; the port's own copy of the
reference's assigned shapes, ``SHAPES``, rides along, and every default
``hw=`` is the H100, which no formula reads).

Why this exists: XLA's ``compiled.cost_analysis()`` counts ``while``-loop
bodies ONCE, not body x trip-count (verified experimentally — see
EXPERIMENTS.md "HLO cost-analysis caveat").  With scanned-layer models and
grad-accumulation scans, the raw HLO numbers undercount by the layer count.
The roofline table therefore reports *both* the raw HLO numbers and this
analytic model; the terms use the analytic values.

Conventions: "per device" divides batch over the data axes and model-width
over the ``model`` axis; remat recompute adds one forward; attention is
causal (S/2 average context; window-clamped when sliding-window).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig
from .hw import H100_SXM, Hardware

# The reference's assigned input shapes (``repro/launch/shapes.py``).
SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


@dataclasses.dataclass
class CostBreakdown:
    flops: float            # per device, per step
    hbm_bytes: float        # per device, per step
    ici_bytes: float        # per device, per step (link traffic)
    model_flops: float      # 6*N*D convention (global, for MFU-style ratio)
    notes: str = ""


def _attn_ctx(cfg: ModelConfig, S: int) -> float:
    """Average attended context per token (causal; window-clamped)."""
    if cfg.window:
        return min(S / 2.0, float(cfg.window))
    return S / 2.0


def _per_token_forward_flops(cfg: ModelConfig, S: int, decode: bool) -> float:
    """Matmul+attention forward FLOPs per token (whole model, unsharded)."""
    d = cfg.d_model
    f = 0.0
    ctx = float(S) if decode else _attn_ctx(cfg, S)
    for li in range(cfg.n_layers):
        kind = cfg.block_kind(li)
        if kind == "attn":
            if cfg.block == "mla" and cfg.mla:
                m = cfg.mla
                qdim = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                f += 2 * d * ((m.q_lora_rank or 0) + m.kv_lora_rank
                              + m.qk_rope_head_dim)
                f += 2 * (m.q_lora_rank or d) * qdim
                f += 2 * m.kv_lora_rank * cfg.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                f += 2 * cfg.n_heads * m.v_head_dim * d
                hd_eff = m.qk_nope_head_dim + m.qk_rope_head_dim
                f += 2 * cfg.n_heads * (hd_eff + m.v_head_dim) * ctx
            else:
                hd = cfg.hd
                w = (min(ctx, cfg.window) if cfg.window else ctx)
                f += 2 * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                f += 2 * cfg.n_heads * hd * d
                f += 4 * cfg.n_heads * hd * w      # qk^T + pv
        elif kind == "rec":
            L = cfg.recurrent.lru_width
            f += 2 * d * L * 2 + 2 * L * L * 2 + 2 * L * d + 10 * L
        elif kind == "rwkv":
            hd = cfg.hd
            f += 2 * d * d * 5 + 2 * d * 64 * 2   # r,k,v,g,o + decay lora
            f += 6 * cfg.n_heads * hd * hd        # wkv rank-1 recurrence
        # FFN
        if cfg.is_moe_layer(li):
            e = cfg.moe
            nff = 3 if cfg.glu else 2
            f += 2 * nff * d * e.d_expert * (e.top_k + e.n_shared)
            f += 2 * d * e.n_routed                # router
        elif kind == "rwkv":
            f += 2 * d * cfg.d_ff * 2 + 2 * d * d  # channel mix
        else:
            f += 2 * (3 if cfg.glu else 2) * d * cfg.d_ff
    f += 2 * d * cfg.vocab                          # unembed
    if cfg.encdec is not None:
        # encoder runs once per sequence; amortise per decoder token
        enc = cfg.encdec
        per_enc_tok = (2 * 4 * d * cfg.hd * cfg.n_heads
                       + 2 * (3 if cfg.glu else 2) * d * cfg.d_ff
                       + 4 * cfg.n_heads * cfg.hd * enc.enc_seq / 2)
        f += per_enc_tok * enc.n_enc_layers * (enc.enc_seq / max(S, 1))
        # cross attention per decoder layer
        f += cfg.n_layers * (2 * 2 * d * cfg.hd * cfg.n_heads
                             + 4 * cfg.n_heads * cfg.hd * enc.enc_seq)
    return f


def train_cost(cfg: ModelConfig, batch: int, S: int, mesh_shape: dict,
               hw: Hardware = H100_SXM, fsdp: bool = False,
               remat: bool = True) -> CostBreakdown:
    tp = mesh_shape.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_shape.items() if k != "model"]))
    n_dev = tp * dp
    tokens = batch * S
    tokens_local = tokens / dp
    fwd = _per_token_forward_flops(cfg, S, decode=False)
    mult = 2.0 + 2.0 * 2.0 if remat else 1.0 + 2.0   # fwd + bwd(2x) + remat
    flops_pd = fwd * mult * tokens_local / tp

    n_params = cfg.param_count()
    n_local = n_params / tp / (dp if fsdp else 1)
    dtype = 2  # bf16
    w_traffic = n_local * dtype * (3 if remat else 2)      # fwd+bwd(+remat)
    opt_traffic = n_local * 22.0                            # adam f32 m,v,p,g
    d = cfg.d_model
    act_per_tok = cfg.n_layers * (8 * d + 4 * cfg.d_ff) * dtype
    kv_traffic = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * dtype * 2
    hbm_pd = (w_traffic + opt_traffic
              + tokens_local * (act_per_tok + kv_traffic) / tp)

    # collectives (ring factors)
    gd = dp
    rf_d = 2 * (gd - 1) / gd if gd > 1 else 0.0
    rf_m = 2 * (tp - 1) / tp if tp > 1 else 0.0
    ici = 0.0
    if fsdp:
        # ZeRO-3: allgather weights fwd+bwd + reduce-scatter grads
        ici += n_params / tp * dtype * 2 * (gd - 1) / gd * 2
        ici += n_params / tp * 4 * (gd - 1) / gd
    else:
        # DisCo bucketed psum of f32 local TP shards over data axes
        ici += n_params / tp * 4 * rf_d
    # TP activation psums: ~2 per layer, fwd+bwd
    ici += cfg.n_layers * 2 * tokens_local * d * dtype * rf_m * 2
    if cfg.moe is not None:
        e = cfg.moe
        ici += tokens_local * d * dtype * e.top_k * 2   # a2a fwd+bwd approx
    model_flops = 6.0 * cfg.active_param_count() * tokens
    return CostBreakdown(flops_pd, hbm_pd, ici, model_flops, "train")


def prefill_cost(cfg: ModelConfig, batch: int, S: int, mesh_shape: dict,
                 hw: Hardware = H100_SXM) -> CostBreakdown:
    tp = mesh_shape.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_shape.items() if k != "model"]))
    tokens = batch * S
    tokens_local = tokens / dp
    fwd = _per_token_forward_flops(cfg, S, decode=False)
    flops_pd = fwd * tokens_local / tp
    n_local = cfg.param_count() / tp
    d = cfg.d_model
    act_per_tok = cfg.n_layers * (6 * d + 2 * cfg.d_ff) * 2
    hbm_pd = n_local * 2 + tokens_local * act_per_tok / tp
    rf_m = 2 * (tp - 1) / tp if tp > 1 else 0.0
    ici = cfg.n_layers * 2 * tokens_local * d * 2 * rf_m
    model_flops = 2.0 * cfg.active_param_count() * tokens
    return CostBreakdown(flops_pd, hbm_pd, ici, model_flops, "prefill")


def decode_cost(cfg: ModelConfig, batch: int, S: int, mesh_shape: dict,
                hw: Hardware = H100_SXM) -> CostBreakdown:
    """One decode step (1 new token/sequence, cache length S)."""
    tp = mesh_shape.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_shape.items() if k != "model"]))
    b_local = max(batch / dp, batch / dp)
    fwd = _per_token_forward_flops(cfg, min(S, cfg.window or S), decode=True)
    flops_pd = fwd * b_local / tp

    n_local = cfg.param_count() / tp
    # cache bytes per sequence
    if cfg.block == "mla" and cfg.mla:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        cache = cfg.n_layers * min(S, cfg.window or S) * per_tok * 2
    elif cfg.block == "rwkv":
        cache = cfg.n_layers * cfg.n_heads * cfg.hd * cfg.hd * 4
    elif cfg.recurrent is not None:
        n_att = sum(1 for i in range(cfg.n_layers)
                    if cfg.block_kind(i) == "attn")
        cache = (n_att * min(S, cfg.window or S)
                 * 2 * cfg.n_kv_heads * cfg.hd * 2
                 + (cfg.n_layers - n_att) * cfg.recurrent.lru_width * 4)
    else:
        cache = (cfg.n_layers * min(S, cfg.window or S)
                 * 2 * cfg.n_kv_heads * cfg.hd * 2)
    hbm_pd = n_local * 2 + b_local * cache / max(tp, 1) * 1.05
    rf_m = 2 * (tp - 1) / tp if tp > 1 else 0.0
    ici = cfg.n_layers * 2 * b_local * cfg.d_model * 2 * rf_m
    model_flops = 2.0 * cfg.active_param_count() * batch
    return CostBreakdown(flops_pd, hbm_pd, ici, model_flops, "decode")


def shape_cost(cfg: ModelConfig, shape: str, mesh_shape: dict,
               fsdp: bool = False) -> CostBreakdown:
    info = SHAPES[shape]
    if info["kind"] == "train":
        return train_cost(cfg, info["batch"], info["seq"], mesh_shape,
                          fsdp=fsdp)
    if info["kind"] == "prefill":
        return prefill_cost(cfg, info["batch"], info["seq"], mesh_shape)
    return decode_cost(cfg, info["batch"], info["seq"], mesh_shape)
