"""Decoder pieces shared by the stacked model (port of
``repro/models/model.py``: ``init_layer``, ``_sinusoid``, ``_embed``,
``_unembed``, ``_layer_fwd`` and ``init_cache``, for dense attention blocks,
the RG-LRU blocks of the recurrent hybrid and RWKV-6 blocks)."""
from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from . import recurrent as R
from .config import ModelConfig


def init_layer(gen: torch.Generator, cfg: ModelConfig, li: int,
               lead=()) -> dict:
    """Block ``li``'s f32 parameters, drawn from ``gen`` (as
    ``layers._randn`` places them); ``lead`` prepends stacked dims.  An
    ``attn`` block holds ``attn``, a ``rec`` block ``rec``; both hold the
    norms and the MLP."""
    def norm():
        return {k: v.expand(*lead, -1).clone()
                for k, v in L.init_norm(cfg, cfg.d_model, "cpu").items()}

    p = {"ln1": norm()}
    if cfg.block_kind(li) == "rwkv":
        p["tmix"] = R.init_rwkv_block(gen, cfg, lead)
        p["ln2"] = norm()
        return p
    if cfg.block_kind(li) == "rec":
        p["rec"] = R.init_recurrent_block(gen, cfg, lead)
    else:
        p["attn"] = L.init_attention(gen, cfg, lead)
    p["ln2"] = norm()
    p["mlp"] = L.init_mlp(gen, cfg, lead)
    return p


def _sinusoid(S: int, D: int, dtype, device) -> torch.Tensor:
    pos = np.arange(S)[:, None]
    dim = np.arange(0, D, 2)[None, :]
    ang = pos / np.power(10000.0, dim / D)
    out = np.zeros((S, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.tie_embeddings:   # gemma-family scaling
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _layer_fwd(p, cfg: ModelConfig, x, positions, *, cache=None, pos=None,
               return_cache: bool = False, cache_len: int = 0,
               use_kernels: bool = False, li: int = 0):
    """Block ``li`` (pre-norm attention or RG-LRU block, then pre-norm
    MLP; or pre-norm RWKV time mix, then pre-norm channel mix).  Returns x,
    or (x, new_cache) when a cache is given or asked for, as
    ``attention_fwd`` does.  ``use_kernels`` runs attention through the
    flash-attention kernel and the RG-LRU and WKV-6 recurrences through
    their kernels."""
    want_cache = return_cache or cache is not None
    h = L.norm_fwd(p["ln1"], cfg, x)
    if cfg.block_kind(li) == "rwkv":
        tm_out, tnew = R.rwkv_time_mix(
            p["tmix"], cfg, h, state=cache["tmix"] if cache else None,
            use_kernel=use_kernels)
        x = x + tm_out
        h2 = L.norm_fwd(p["ln2"], cfg, x)
        cm_out, cnew = R.rwkv_channel_mix(
            p["tmix"], cfg, h2, state=cache["cmix"] if cache else None)
        x = x + cm_out
        return (x, {"tmix": tnew, "cmix": cnew}) if want_cache else x
    if cfg.block_kind(li) == "rec":
        r = R.recurrent_block_fwd(p["rec"], cfg, h, state=cache,
                                  return_state=return_cache,
                                  use_kernel=use_kernels)
    else:
        r = L.attention_fwd(p["attn"], cfg, h, positions, cache=cache,
                            pos=pos, window=cfg.window, use_flash=use_kernels,
                            return_cache=return_cache, cache_len=cache_len)
    mix_out, new_cache = r if want_cache else (r, None)
    x = x + mix_out
    h2 = L.norm_fwd(p["ln2"], cfg, x)
    x = x + L.mlp_fwd(p["mlp"], cfg, h2)
    return (x, new_cache) if want_cache else x


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Per-layer zero decode state, as in the reference: an ``attn`` block
    holds ``{"k", "v"}`` of (batch, size, KV, hd) in ``cfg.dtype``, with
    size ``min(cache_len, window)`` for a sliding window; a ``rec`` block
    holds ``{"h": (batch, L) f32, "conv": (batch, W-1, L) cfg.dtype}``; an
    ``rwkv`` block ``{"tmix": {"wkv": (batch, H, hd, hd) f32, "prev":
    (batch, D)}, "cmix": {"prev": (batch, D)}}``, ``prev`` in cfg.dtype."""
    dt = getattr(torch, cfg.dtype)
    caches = []
    for li in range(cfg.n_layers):
        if cfg.block_kind(li) == "rwkv":
            wkv = (batch, cfg.n_heads, cfg.hd, cfg.hd)
            prev = (batch, cfg.d_model)
            caches.append({
                "tmix": {"wkv": torch.zeros(wkv, dtype=torch.float32,
                                            device=device),
                         "prev": torch.zeros(prev, dtype=dt, device=device)},
                "cmix": {"prev": torch.zeros(prev, dtype=dt,
                                             device=device)}})
            continue
        if cfg.block_kind(li) == "rec":
            Lw = cfg.recurrent.lru_width
            caches.append({
                "h": torch.zeros((batch, Lw), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.recurrent.conv_width - 1, Lw),
                                    dtype=dt, device=device)})
            continue
        size = min(cache_len, cfg.window) if cfg.window else cache_len
        shape = (batch, size, cfg.n_kv_heads, cfg.hd)
        caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)})
    return caches
