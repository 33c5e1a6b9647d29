"""Dense decoder pieces shared by the stacked model (port of
``repro/models/model.py``: ``init_layer``, ``_sinusoid``, ``_embed``,
``_unembed``, ``_layer_fwd`` and ``init_cache``, dense attention blocks
only)."""
from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig


def init_layer(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """One dense block's f32 parameters on the host; ``lead`` prepends
    stacked dims."""
    def norm():
        return {k: v.expand(*lead, -1).clone()
                for k, v in L.init_norm(cfg, cfg.d_model, "cpu").items()}

    return {"ln1": norm(),
            "attn": L.init_attention(gen, cfg, lead),
            "ln2": norm(),
            "mlp": L.init_mlp(gen, cfg, lead)}


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
               use_kernels: bool = False):
    """One dense block (pre-norm attention, then pre-norm MLP).  Returns
    x, or (x, new_cache) when a cache is given or asked for, as
    ``attention_fwd`` does.  ``use_kernels`` runs attention through the
    flash-attention kernel."""
    want_cache = return_cache or cache is not None
    h = L.norm_fwd(p["ln1"], cfg, x)
    r = L.attention_fwd(p["attn"], cfg, h, positions, cache=cache, pos=pos,
                        window=cfg.window, use_flash=use_kernels,
                        return_cache=return_cache, cache_len=cache_len)
    attn_out, new_cache = r if want_cache else (r, None)
    x = x + attn_out
    h2 = L.norm_fwd(p["ln2"], cfg, x)
    x = x + L.mlp_fwd(p["mlp"], cfg, h2)
    return (x, new_cache) if want_cache else x


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Per-layer zero decode state: ``{"k", "v"}`` of (batch, size, KV, hd)
    in ``cfg.dtype``, with size ``min(cache_len, window)`` for a sliding
    window, as in the reference."""
    dt = getattr(torch, cfg.dtype)
    size = min(cache_len, cfg.window) if cfg.window else cache_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]
