"""Dense decoder pieces shared by the stacked model (port of
``repro/models/model.py``: ``init_layer``, ``_sinusoid``, ``_embed``,
``_unembed`` and ``_layer_fwd``, dense attention blocks only)."""
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


def _layer_fwd(p, cfg: ModelConfig, x, positions):
    """One dense block (pre-norm attention, then pre-norm MLP)."""
    h = L.norm_fwd(p["ln1"], cfg, x)
    x = x + L.attention_fwd(p["attn"], cfg, h, positions, window=cfg.window)
    h2 = L.norm_fwd(p["ln2"], cfg, x)
    return x + L.mlp_fwd(p["mlp"], cfg, h2)
