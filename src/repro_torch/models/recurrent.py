"""The RG-LRU recurrent block of Griffin / RecurrentGemma (port of the
RG-LRU half of ``repro/models/recurrent.py``; the RWKV-6 half is not ported
yet).

Train and prefill run over the full sequence (temporal conv with zero
history, then the linear recurrence), decode advances the
``{"h", "conv"}`` state by one token.  ``use_kernel`` runs the recurrence,
with its gate math, in the CUDA kernel (:func:`repro_torch.kernels.ops.
rglru_scan`); without it :func:`_rg_lru_scan` runs an associative scan in
plain PyTorch.  The dtypes follow the reference: the kernel-free paths
compute the gates in the activations' dtype, the kernel and its plain
version in f32; prefill returns ``h[:, -1]`` in the activations' dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig

_LRU_C = 8.0


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig,
                         lead=()) -> dict:
    """Griffin recurrent block: in-proj (+ gate branch), temporal conv,
    RG-LRU, out-proj.  f32 leaves drawn from ``gen`` (as ``layers._randn``
    places them); ``lead`` prepends stacked dims.  ``lam`` is
    linspace(2, 6, L), as in the reference."""
    r = cfg.recurrent
    Lw = r.lru_width
    w_x = L._dense(gen, cfg.d_model, Lw, lead)
    w_gate = L._dense(gen, cfg.d_model, Lw, lead)
    conv_w = L._randn(gen, (*lead, r.conv_width, Lw)) * 0.02
    w_ri = L._dense(gen, Lw, Lw, lead)
    w_ii = L._dense(gen, Lw, Lw, lead)
    w_out = L._dense(gen, Lw, cfg.d_model, lead)
    lam = torch.from_numpy(np.linspace(2.0, 6.0, Lw).astype(np.float32))
    return {
        "w_x": w_x, "w_gate": w_gate, "conv_w": conv_w,
        "conv_b": torch.zeros_like(conv_w[..., 0, :]),
        "w_ri": w_ri, "w_ii": w_ii,
        "lam": lam.to(conv_w.device).expand(*lead, Lw).clone(),
        "w_out": w_out,
    }


def _rg_lru_scan(x, r_gate, i_gate, lam):
    """x, gates: (B, S, L); returns h: (B, S, L) by an associative scan
    (log2(S) doubling steps of the combine (a1, b1), (a2, b2) -> (a1 a2,
    b1 a2 + b2)), in the inputs' dtype.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t)   (RG-LRU, arXiv:2402.19427)
    """
    log_a = -_LRU_C * F.softplus(lam)[None, None, :] * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i_gate * x)
    S = x.shape[1]
    d = 1
    while d < S:
        # element t absorbs the segment that ends at t - d
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def recurrent_block_fwd(p: dict, cfg: ModelConfig, x, *,
                        state: Optional[dict] = None,
                        return_state: bool = False,
                        use_kernel: bool = False):
    """x: (B, S, D).  ``state`` (decode, S == 1): ``{"h": (B, L), "conv":
    (B, W-1, L)}``, updated in place and returned (the reference returns a
    new state).  Returns ``out``, or ``(out, state)`` when a state is given
    or asked for."""
    r = cfg.recurrent
    B, S, D = x.shape
    W = r.conv_width
    gate = L._act(cfg, x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_x"].to(x.dtype)                             # (B,S,L)
    conv_w = p["conv_w"].to(u.dtype)
    conv_b = p["conv_b"].to(u.dtype)

    if state is not None:
        hist = torch.cat([state["conv"].to(u.dtype), u], dim=1)
        conv = torch.einsum("bwl,wl->bl", hist[:, -W:], conv_w)
        conv = (conv + conv_b)[:, None]
    else:
        pad = torch.zeros((B, W - 1, u.shape[-1]), dtype=u.dtype,
                          device=u.device)
        hist = torch.cat([pad, u], dim=1)
        frames = torch.stack([hist[:, i:i + S] for i in range(W)], dim=2)
        conv = (torch.einsum("bswl,wl->bsl", frames, conv_w)
                + conv_b).contiguous()
    new_conv = hist[:, -(W - 1):]

    r_gate = torch.sigmoid(conv @ p["w_ri"].to(u.dtype))
    i_gate = torch.sigmoid(conv @ p["w_ii"].to(u.dtype))
    if state is not None:
        log_a = -_LRU_C * F.softplus(p["lam"])[None, None] * r_gate
        a = torch.exp(log_a)
        gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a),
                                       min=1e-12)) * (i_gate * conv)
        h = a * state["h"].to(u.dtype)[:, None] + gated      # (B,1,L)
        state["h"].copy_(h[:, 0])
        state["conv"].copy_(new_conv)
        new_state = state
    else:
        if use_kernel:
            from ..kernels import ops as kops
            h = kops.rglru_scan(conv, r_gate, i_gate, p["lam"])
        else:
            h = _rg_lru_scan(conv, r_gate, i_gate, p["lam"])
        new_state = {"h": h[:, -1], "conv": new_conv}
    out = (h * gate) @ p["w_out"].to(x.dtype)
    if return_state or state is not None:
        return out, new_state
    return out
