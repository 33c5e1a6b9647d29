"""The recurrent blocks (port of ``repro/models/recurrent.py``): the RG-LRU
block of Griffin / RecurrentGemma and the RWKV-6 time-mix and channel-mix
blocks.

Train and prefill run over the full sequence, decode advances the state by
one token and writes it in place (the reference returns a new state).

RG-LRU: a temporal conv with zero history, then the linear recurrence, with
state ``{"h", "conv"}``.  ``use_kernel`` runs the recurrence, with its gate
math, in the CUDA kernel (:func:`repro_torch.kernels.ops.rglru_scan`);
without it :func:`_rg_lru_scan` runs an associative scan in plain PyTorch.
The dtypes follow the reference: the kernel-free paths compute the gates in
the activations' dtype, the kernel and its plain version in f32; prefill
returns ``h[:, -1]`` in the activations' dtype.

RWKV-6: token shift, projections and a data-dependent decay, then the WKV
recurrence with an f32 (B, H, hd, hd) state ``wkv`` and the last token's
input ``prev``.  ``use_kernel`` runs the recurrence in the CUDA kernel
(:func:`repro_torch.kernels.ops.rwkv6_wkv`), which also returns the final
state, so a prefill through it seeds a decode; the reference's kernel path
returns no state there.  Without it :func:`_wkv6_scan` runs the sequential
recurrence in f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ref import rwkv6_ref
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


# ================================================================ RWKV-6 block
_RWKV_LORA = 64


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """RWKV-6 time-mix and channel-mix weights (the channel mix's live in
    the same subtree, as in the reference): token-shift mixes at 0.5,
    projections, the decay's base ``w0`` = -2 and low-rank ``wA``/``wB``,
    the per-head bonus ``u``, the output group norm ``ln_x``.  f32 leaves
    drawn from ``gen``; ``lead`` prepends stacked dims."""
    D, HD = cfg.d_model, cfg.n_heads * cfg.hd
    p = {name: L._dense(gen, D, HD, lead)
         for name in ("w_r", "w_k", "w_v", "w_g")}
    dev = p["w_r"].device

    def full(n, value):
        return torch.full((*lead, n), value, dtype=torch.float32, device=dev)

    p.update({f"mu_{n}": full(D, 0.5) for n in "rkvwg"})
    p["w_o"] = L._dense(gen, HD, D, lead)
    p["w0"] = full(HD, -2.0)
    p["wA"] = L._randn(gen, (*lead, D, _RWKV_LORA)) * 0.01
    p["wB"] = L._randn(gen, (*lead, _RWKV_LORA, HD)) * 0.01
    p["bonus"] = L._randn(gen, (*lead, cfg.n_heads, cfg.hd)) * 0.1
    p["ln_x"] = {"scale": full(HD, 1.0), "bias": full(HD, 0.0)}
    p["cmu_k"], p["cmu_r"] = full(D, 0.5), full(D, 0.5)
    p["c_k"] = L._dense(gen, D, cfg.d_ff, lead)
    p["c_v"] = L._dense(gen, cfg.d_ff, D, lead)
    p["c_r"] = L._dense(gen, D, D, lead)
    return p


def _token_shift(x, mu, prev=None):
    """Lerp between each token and the one before it (zero, or ``prev``
    (B, D), before the first)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    shifted = torch.cat([first, x[:, :-1]], dim=1)
    return x + (shifted - x) * mu.to(x.dtype)


# The kernel-free recurrence: (out in r's dtype, final f32 state), the
# reference's ``_wkv6_scan``, which is the kernel's plain version.
_wkv6_scan = rwkv6_ref


def rwkv_time_mix(p: dict, cfg: ModelConfig, x, *,
                  state: Optional[dict] = None, use_kernel: bool = False):
    """RWKV-6 time mix over x (B, S, D).  ``state`` (decode, S == 1):
    ``{"wkv": (B, H, hd, hd) f32, "prev": (B, D)}``, updated in place and
    returned.  Returns ``(out, state)``; without a state, the new one holds
    the final WKV state, from the kernel too, and the last token."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    prev = state["prev"] if state is not None else None
    xr, xk, xv, xw, xg = (_token_shift(x, p[f"mu_{n}"], prev)
                          for n in "rkvwg")
    r = (xr @ p["w_r"].to(x.dtype)).reshape(B, S, H, hd)
    k = (xk @ p["w_k"].to(x.dtype)).reshape(B, S, H, hd)
    v = (xv @ p["w_v"].to(x.dtype)).reshape(B, S, H, hd)
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    dd = torch.tanh(xw @ p["wA"].to(x.dtype)) @ p["wB"].to(x.dtype)
    # decay in (0, 1), kept in f32
    w = torch.exp(-torch.exp(p["w0"].float() + dd.float())).reshape(
        B, S, H, hd)
    u = p["bonus"].float()

    if state is not None:
        rt, kt, vt, wt = (a[:, 0].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        s_prev = state["wkv"].float()
        out = torch.einsum("bhk,bhkv->bhv", rt,
                           s_prev + u[None, :, :, None] * kv)
        state["wkv"].copy_(wt[..., None] * s_prev + kv)
        state["prev"].copy_(x[:, -1])
        out = out[:, None].to(x.dtype)
        new_state = state
    else:
        if use_kernel:
            from ..kernels import ops as kops
            out, final = kops.rwkv6_wkv(r, k, v, w, u)
        else:
            out, final = _wkv6_scan(r, k, v, w, u)
        new_state = {"wkv": final, "prev": x[:, -1]}
    # group norm over each head (ln_x), in f32
    of = out.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    of = ((of - mu) * torch.rsqrt(var + 1e-5)).reshape(B, -1, H * hd)
    out = (of * p["ln_x"]["scale"] + p["ln_x"]["bias"]).to(x.dtype)
    return (out * g) @ p["w_o"].to(x.dtype), new_state


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x, *,
                     state: Optional[dict] = None):
    """RWKV channel mix (squared-ReLU key, sigmoid receptance) over x (B,
    S, D).  ``state`` (decode): ``{"prev": (B, D)}``, updated in place.
    Returns ``(out, state)``."""
    prev = state["prev"] if state is not None else None
    xk = _token_shift(x, p["cmu_k"], prev)
    xr = _token_shift(x, p["cmu_r"], prev)
    k = torch.square(F.relu(xk @ p["c_k"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["c_r"].to(x.dtype))
    out = r * (k @ p["c_v"].to(x.dtype))
    if state is None:
        return out, {"prev": x[:, -1]}
    state["prev"].copy_(x[:, -1])
    return out, state
