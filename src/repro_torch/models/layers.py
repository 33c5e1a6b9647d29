"""Transformer building blocks, dense subset (port of
``repro/models/layers.py``).

Conventions, as in the reference:
* params are nested dicts of tensors; a projection is ``x @ W`` with ``W``
  of shape (d_in, d_out), cast to the activation dtype at use;
* activations are (B, S, D); attention heads are laid out (B, S, H, hd).

Ported: the train and prefill path over a full sequence (with flash
attention through the CUDA kernel when asked for), and decode against a
bf16/f32 KV cache.  Not yet: the int8 KV cache, MLA and MoE.  Decode takes
one position per batch row, so the serving engine advances every slot in
one batched call where the reference vmaps a batch-1 step; each row
computes what the reference's step computes.

Where the reference promotes a bf16 tensor to f32 (a numpy scalar or an f32
operand in the expression), the port promotes it at the same point, so
bf16 runs round at the same places.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig

_F32_MIN = torch.finfo(torch.float32).min


# ------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_freqs(cfg: ModelConfig, rot_dim: int, device) -> torch.Tensor:
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rot_dim, 2) / rot_dim))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,), or (B, S) for one set per row.
    Rotates the first ``rope_frac`` of each head."""
    rot = int(x.shape[-1] * cfg.rope_frac)
    if rot == 0:
        return x
    inv = rope_freqs(cfg, rot, x.device)
    ang = positions[..., None].float() * inv          # (..., S, rot/2)
    ang = ang[..., None, :] if ang.dim() == 3 else ang[None, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp.to(xr.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention
def _dense(gen: torch.Generator, d_in: int, d_out: int,
           lead=()) -> torch.Tensor:
    return (torch.randn((*lead, d_in, d_out), generator=gen,
                        dtype=torch.float32) / math.sqrt(d_in))


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """f32 attention weights on the host, from ``gen``; ``lead`` prepends
    stacked dims."""
    hd = cfg.hd
    p = {
        "wq": _dense(gen, cfg.d_model, cfg.n_heads * hd, lead),
        "wk": _dense(gen, cfg.d_model, cfg.n_kv_heads * hd, lead),
        "wv": _dense(gen, cfg.d_model, cfg.n_kv_heads * hd, lead),
        "wo": _dense(gen, cfg.n_heads * hd, cfg.d_model, lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((*lead, width * hd), dtype=torch.float32)
    return p


def _sdpa_dense(q, k, v, bias):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); bias broadcastable to
    (B,KV,G,S,T).  Scores and softmax in f32, as in the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.reshape(B, S, KV, group, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def _causal_bias(S, T, causal, window, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos if causal else torch.ones((S, T), dtype=torch.bool,
                                                device=device)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, _F32_MIN))


# Above this query length attention runs query-chunked to bound the softmax
# working set, as the reference's XLA path does.
_CHUNK_THRESHOLD = 2048
_Q_BLOCK = 512


def sdpa(q, k, v, mask, use_flash: bool = False,
         window: Optional[int] = None, causal: bool = True):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask: (B,1,1|S,T) additive or None.
    GQA: query heads grouped over KV heads.  Routed as in the reference:
    ``use_flash`` with no mask takes the flash-attention kernel
    (:func:`repro_torch.kernels.ops.flash_attention`); otherwise long
    self-attention takes the query-chunked online-softmax path so the score
    matrix working set stays bounded, and the rest the dense path."""
    S, T = q.shape[1], k.shape[1]
    if use_flash and mask is None:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if mask is None:
        if S > _CHUNK_THRESHOLD and S == T:
            for blk in (_Q_BLOCK, 256, 128, 64):
                if S % blk == 0:
                    return _flash_xla(q, k, v, causal, window, qb=blk,
                                      kb=blk)
        bias = _causal_bias(S, T, causal, window, q.device)[None, None, None]
        return _sdpa_dense(q, k, v, bias)
    bias = mask[:, :, None] if mask.dim() == 4 else mask
    return _sdpa_dense(q, k, v, bias)


def _flash_xla(q, k, v, causal, window, qb: int = _Q_BLOCK,
               kb: int = _Q_BLOCK):
    """Online-softmax attention in plain PyTorch, the port of the
    reference's double ``lax.scan`` over query and KV blocks.  The working
    set per step is (B,H,qb,kb); each query block is rematerialised in the
    backward (the reference checkpoints its scan bodies).  Causality is
    enforced by masking; blocks are not skipped."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    nq, nk = S // qb, T // kb
    qs = q.reshape(B, nq, qb, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    ks = k.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    def q_step(qi, qblk):
        m = torch.full((B, KV, G, qb), _F32_MIN, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qb, hd), dtype=torch.float32,
                          device=dev)
        qpos = qi * qb + torch.arange(qb, device=dev)[:, None]
        for ki in range(nk):
            s = torch.einsum("bkgqh,bkth->bkgqt", qblk, ks[ki]).float()
            s = s * scale
            kpos = ki * kb + torch.arange(kb, device=dev)[None, :]
            ok = kpos <= qpos if causal else torch.ones(
                (qb, kb), dtype=torch.bool, device=dev)
            if window is not None:
                ok = ok & (kpos > qpos - window)
            s = torch.where(ok[None, None, None], s,
                            torch.full_like(s, _F32_MIN))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(vs.dtype), vs[ki])
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.to(q.dtype)

    outs = []
    for qi in range(nq):
        if torch.is_grad_enabled():
            outs.append(checkpoint(q_step, qi, qs[qi], use_reentrant=False))
        else:
            outs.append(q_step(qi, qs[qi]))
    # (nq, B, KV, G, qb, hd) -> (B, S, H, hd)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)


def attention_fwd(p: dict, cfg: ModelConfig, x, positions, *,
                  cache: Optional[dict] = None,
                  pos: Optional[torch.Tensor] = None,
                  window: Optional[int] = None, use_flash: bool = False,
                  return_cache: bool = False, cache_len: int = 0):
    """Self-attention.  Train/prefill when ``cache`` is None (optionally
    returning a fresh cache of length ``cache_len``); decode when ``cache``
    and ``pos`` are given (x is (B,1,D); ``pos`` a scalar or one position
    per row, and ``positions`` (1,) or (B,1) to match).  Decode writes the
    new k/v into ``cache`` in place and returns it; the reference returns an
    updated copy.  Returns ``out``, or ``(out, cache)`` when a cache is
    given or asked for."""
    B, S, D = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q.reshape(B, S, cfg.n_heads, hd), positions, cfg)
    k = apply_rope(k.reshape(B, S, cfg.n_kv_heads, hd), positions, cfg)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)

    new_cache = None
    if cache is not None:
        # decode: write k, v at each row's position (pos % size for a
        # window's ring buffer), clamped into the cache as the reference's
        # dynamic_update_slice clamps
        ck, cv = cache["k"], cache["v"]
        csize = ck.shape[1]
        pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
        slot = pos % csize if window is not None else pos
        slot = slot.clamp(0, csize - S)
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        kpos = torch.arange(csize, device=x.device)[None, :]
        if window is not None:
            # ring buffer: entry i holds an absolute position within the
            # last `csize` positions
            age = (slot[:, None] - kpos) % csize
            ok = age <= torch.clamp(pos, max=csize - 1)[:, None]
        else:
            ok = kpos <= pos[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(ok, zero, torch.full_like(zero, _F32_MIN))
        out = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask[:, None, None, :])
    else:
        out = sdpa(q, k, v, None, use_flash=use_flash, window=window)
        if return_cache:
            size = cache_len or S
            take = min(S, size)
            ck = torch.zeros((B, size, cfg.n_kv_heads, hd), dtype=x.dtype,
                             device=x.device)
            cv = torch.zeros_like(ck)
            ck[:, :take] = k[:, S - take:]
            cv[:, :take] = v[:, S - take:]
            new_cache = {"k": ck, "v": cv}
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return (out, new_cache) if (return_cache or cache is not None) else out


# --------------------------------------------------------------------- FFN
def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    p = {"w_down": _dense(gen, cfg.d_ff, cfg.d_model, lead),
         "w_up": _dense(gen, cfg.d_model, cfg.d_ff, lead)}
    if cfg.glu:
        p["w_gate"] = _dense(gen, cfg.d_model, cfg.d_ff, lead)
    return p


def _act(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.relu(x)


def mlp_fwd(p: dict, cfg: ModelConfig, x):
    up = x @ p["w_up"].to(x.dtype)
    if cfg.glu:
        h = _act(cfg, x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = _act(cfg, up)
    return h @ p["w_down"].to(x.dtype)
