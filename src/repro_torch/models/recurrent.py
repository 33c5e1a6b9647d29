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
recurrence in f32, as one custom op forward and backward (the kernel's
plain version, :func:`repro_torch.kernels.ref.rwkv6_ref`, is a loop over
time that the tracer would record step by step).
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
                        use_kernel: bool = False, tp=None):
    """x: (B, S, D).  ``state`` (decode, S == 1): ``{"h": (B, L), "conv":
    (B, W-1, L)}``, updated in place and returned (the reference returns a
    new state).  Returns ``out``, or ``(out, state)`` when a state is given
    or asked for.

    Under a tensor-parallel context ``tp`` whose rules shard the block,
    this rank computes its slice of the L channels: ``w_x`` and
    ``w_gate`` are column-sharded; the conv and the recurrence are per
    channel, on this rank's slices of the replicated ``conv_w``, ``conv_b``
    and ``lam`` (each through ``copy``); the gates' ``w_ri`` and ``w_ii``
    are column-sharded over an input of all L channels, so the conv output
    is gathered and, since each rank's gates give only part of its
    gradient, passed through ``copy``; ``w_out`` is row-sharded, its
    partial sums reduced.  The state holds the same slice of ``h`` and
    ``conv``, as the rules' ``cache_specs`` shard them; a prefill through
    the kernel runs it on this rank's channels."""
    r = cfg.recurrent
    B, S, D = x.shape
    W = r.conv_width
    sharded = tp is not None and tp.dim("rec", "w_x") is not None
    conv_w, conv_b, lam = p["conv_w"], p["conv_b"], p["lam"]
    if sharded:
        x = tp.copy(x)
        conv_w, conv_b, lam = (tp.local(tp.copy(t), -1)
                               for t in (conv_w, conv_b, lam))
    gate = L._act(cfg, x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_x"].to(x.dtype)                             # (B,S,L)
    conv_w = conv_w.to(u.dtype)
    conv_b = conv_b.to(u.dtype)

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

    conv_all = tp.copy(tp.gather(conv, -1)) if sharded else conv
    r_gate = torch.sigmoid(conv_all @ p["w_ri"].to(u.dtype))
    i_gate = torch.sigmoid(conv_all @ p["w_ii"].to(u.dtype))
    if state is not None:
        log_a = -_LRU_C * F.softplus(lam)[None, None] * r_gate
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
            h = kops.rglru_scan(conv, r_gate, i_gate, lam)
        else:
            h = _rg_lru_scan(conv, r_gate, i_gate, lam)
        # copies: a view would keep the whole sequence's h and conv input
        # alive as long as the cache
        new_state = {"h": h[:, -1].clone(), "conv": new_conv.clone()}
    out = (h * gate) @ p["w_out"].to(x.dtype)
    if sharded:
        out = tp.reduce(out)
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


# ----------------------------------------------------------- the WKV-6 scan
# The most bytes of f32 (hd, hd) states one chunk of the scan keeps: the
# forward keeps a chunk's states to read its outputs in one batched
# product, the backward a chunk's states and their gradients.
_WKV_CHUNK_BYTES = 256 << 20


def wkv_chunk(B: int, S: int, H: int, hd: int) -> int:
    """Steps of one chunk of :func:`_wkv6_scan` at these shapes."""
    return max(1, min(S, _WKV_CHUNK_BYTES // (B * H * hd * hd * 4)))


def _recur(a, p, q, x0, keep: bool = True):
    """The WKV recurrence's linear step over one chunk, x <- diag(a_c) x +
    p_c q_c^T for c = 0..C-1: time-major f32 a, p, q (C, B, H, hd) and
    the (B, H, hd, hd) x before the chunk.  The forward's states are
    (a, p, q) = (w, k, v), the backward's state gradients, back in time,
    (w, r, g).  With ``keep``, (C + 1, B, H, hd, hd): x before each step,
    then after the last; else only the last.  Two launches a step, on
    views taken before the loop."""
    a_, p_ = a.unsqueeze(-1).unbind(0), p.unsqueeze(-1).unbind(0)
    q_ = q.unsqueeze(-2).unbind(0)
    if not keep:
        x = x0
        for t in range(len(a_)):
            x = torch.addcmul(x * a_[t], p_[t], q_[t])
        return x
    out = x0.new_empty((len(a_) + 1, *x0.shape))
    xs = out.unbind(0)
    xs[0].copy_(x0)
    for t in range(len(a_)):
        torch.mul(xs[t], a_[t], out=xs[t + 1])
        xs[t + 1].addcmul_(p_[t], q_[t])
    return out


def _time_major(*ts):
    return [t.float().transpose(0, 1) for t in ts]


@torch.library.custom_op("repro_torch::wkv6_scan", mutates_args=())
def _wkv6_scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, H, hd = r.shape
    rf, kf, vf, wf = _time_major(r, k, v, w)
    uf = u.float()
    out = torch.empty((S, B, H, hd), dtype=torch.float32, device=r.device)
    s = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        st = _recur(wf[sl], kf[sl], vf[sl], s)
        # out_t = r_t^T S_{t-1} + (r_t . u k_t) v_t
        out[sl] = (torch.einsum("cbhi,cbhij->cbhj", rf[sl], st[:-1])
                   + (rf[sl] * uf * kf[sl]).sum(-1, keepdim=True) * vf[sl])
        s = st[-1].clone()
    return out.transpose(0, 1).to(r.dtype).contiguous(), s


@_wkv6_scan_op.register_fake
def _(r, k, v, w, u, chunk):
    B, S, H, hd = r.shape
    return torch.empty_like(r), r.new_empty((B, H, hd, hd),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::wkv6_scan_bwd", mutates_args=())
def _wkv6_scan_bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, g_out: torch.Tensor,
                      g_final: torch.Tensor, chunk: int) -> tuple[
                          torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor]:
    B, S, H, hd = r.shape
    rf, kf, vf, wf, gf = _time_major(r, k, v, w, g_out)
    uf = u.float()
    # the state before each chunk, from a forward pass
    starts = [torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=r.device)]
    for c0 in range(chunk, S, chunk):
        sl = slice(c0 - chunk, c0)
        starts.append(_recur(wf[sl], kf[sl], vf[sl], starts[-1], False))
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    d_s = g_final.float()         # the gradient of the state after a step
    for ci in reversed(range(len(starts))):
        sl = slice(ci * chunk, min((ci + 1) * chunk, S))
        r_, k_, v_, w_, g_ = rf[sl], kf[sl], vf[sl], wf[sl], gf[sl]
        prev = _recur(w_, k_, v_, starts[ci])[:-1]
        # the state gradients back in time, dS_{t-1} = w_t dS_t + r_t g_t^T;
        # dn[c] is the gradient of the state after step c
        back = _recur(w_.flip(0), r_.flip(0), g_.flip(0), d_s)
        dn, d_s = back[:-1].flip(0), back[-1]
        vg = (v_ * g_).sum(-1, keepdim=True)
        dr[sl] = torch.einsum("cbhij,cbhj->cbhi", prev, g_) + uf * k_ * vg
        dk[sl] = torch.einsum("cbhij,cbhj->cbhi", dn, v_) + r_ * uf * vg
        dv[sl] = (torch.einsum("cbhij,cbhi->cbhj", dn, k_)
                  + (r_ * uf * k_).sum(-1, keepdim=True) * g_)
        dw[sl] = (dn * prev).sum(-1)
        du += (r_ * k_ * vg).sum((0, 1))
    return (*(d.transpose(0, 1).to(t.dtype).contiguous()
              for d, t in ((dr, r), (dk, k), (dv, v), (dw, w))),
            du.to(u.dtype))


@_wkv6_scan_bwd_op.register_fake
def _(r, k, v, w, u, g_out, g_final, chunk):
    return tuple(torch.empty_like(t) for t in (r, k, v, w, u))


def _wkv6_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.chunk = inputs[5]


def _wkv6_backward(ctx, g_out, g_final):
    r, k, v, w, u = ctx.saved_tensors
    B, S, H, hd = r.shape
    if g_out is None:
        g_out = torch.zeros_like(r)
    if g_final is None:
        g_final = r.new_zeros((B, H, hd, hd), dtype=torch.float32)
    return (*torch.ops.repro_torch.wkv6_scan_bwd(r, k, v, w, u, g_out,
                                                 g_final, ctx.chunk), None)


torch.library.register_autograd("repro_torch::wkv6_scan", _wkv6_backward,
                                setup_context=_wkv6_setup)


def _wkv6_scan(r, k, v, w, u, chunk: Optional[int] = None):
    """The model's kernel-free WKV-6 recurrence, the reference's
    ``_wkv6_scan``: r, k, v, w (B, S, H, hd), u (H, hd); returns (out in
    r's dtype, final state (B, H, hd, hd) f32), computed in f32.  One
    custom op forward and one backward, so the tracer sees one node each
    whatever S (the reference's tracer keeps its scan as one node), priced
    as the reference's scan body times S.  Both run in chunks of
    ``chunk`` steps (:func:`wkv_chunk` by default): the forward keeps one
    chunk's states; the backward runs the recurrence forward to each
    chunk's start state, then, chunk by chunk from the last, recomputes
    the chunk's states and takes their gradients back in time."""
    B, S, H, hd = r.shape
    return torch.ops.repro_torch.wkv6_scan(
        r, k, v, w, u, chunk or wkv_chunk(B, S, H, hd))


def _prev_whole(tp, name: str, state):
    """A state's ``prev`` (B, D) whole, gathered over ``tp``'s group where
    the cache holds this rank's slice of it; None without a state."""
    if state is None:
        return None
    if tp is not None and tp.cache_dim(name, "prev") is not None:
        return tp.gather(state["prev"], -1)
    return state["prev"]


def _prev_shard(tp, name: str, last):
    """The ``prev`` the cache keeps of ``last`` (B, D): this rank's slice
    where the rules shard it."""
    if tp is not None and tp.cache_dim(name, "prev") is not None:
        return tp.local(last, -1)
    return last


def rwkv_time_mix(p: dict, cfg: ModelConfig, x, *,
                  state: Optional[dict] = None, use_kernel: bool = False,
                  tp=None, serve: bool = False):
    """RWKV-6 time mix over x (B, S, D).  ``state`` (decode, S == 1):
    ``{"wkv": (B, H, hd, hd) f32, "prev": (B, D)}``, updated in place and
    returned.  Returns ``(out, state)``; without a state, the new one holds
    the final WKV state, from the kernel too, and the last token.
    ``serve`` says the returned state is kept (a prefill's cache).

    Under a tensor-parallel context ``tp`` whose rules shard the
    block, ``w_r``, ``w_k``, ``w_v`` and ``w_g`` are column-sharded (their
    token-shifted inputs through ``copy``) and ``w_o`` is row-sharded, its
    partial sums reduced.  Where this rank's ``D / m`` columns are whole
    heads, it computes those ``H / m`` heads; the decay, computed whole
    from replicated leaves, ``bonus`` and ``ln_x`` are sliced to them after
    ``copy``.  Where the columns split a head (rwkv6-3b's 40 heads over 16
    ranks), the rank computes the whole heads its columns cover: ``r``,
    ``k`` and ``v`` are gathered over the group and passed through
    ``copy`` (each rank reads the gathered columns differently, so every
    rank's gradient terms must be summed), the scan and the per-head group
    norm run on the covering heads, and the rank keeps its own columns
    before ``* g`` and ``w_o``.

    The state under ``tp`` is this rank's shard by the rules'
    ``cache_specs``: ``prev`` its slice of the width where the group
    divides it (gathered before the token shift, each new one stored
    sliced), ``wkv`` its heads where the group divides them.  Where the
    columns split a head the rules keep ``wkv`` whole on every rank, so a
    prefill or decode step with a state runs every head, not just the
    covering ones (ROADMAP C24)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    sharded = tp is not None and tp.dim("tmix", "w_r") is not None
    prev = _prev_whole(tp, "tmix", state)
    xr, xk, xv, xw, xg = (_token_shift(x, p[f"mu_{n}"], prev)
                          for n in "rkvwg")
    dd = torch.tanh(xw @ p["wA"].to(x.dtype)) @ p["wB"].to(x.dtype)
    # decay in (0, 1), kept in f32
    w = torch.exp(-torch.exp(p["w0"].float() + dd.float()))
    u = p["bonus"].float()
    ln_x = p["ln_x"]
    split = sharded and (D // tp.size) % hd != 0
    if sharded:
        xr, xk, xv, xg = (tp.copy(t) for t in (xr, xk, xv, xg))
        ln_x = {n: tp.local(tp.copy(t), -1) for n, t in ln_x.items()}
    r, k, v = (xt @ p[n].to(x.dtype)
               for xt, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    if split:
        # this rank's columns [c0, c0 + D/m) and the heads [h0, h1) they
        # cover; `own` is where its columns start within those heads
        c0 = tp.rank * (D // tp.size)
        h0, h1 = c0 // hd, -(-(c0 + D // tp.size) // hd)
        if serve or state is not None:
            h0, h1 = 0, H
        own = c0 - h0 * hd
        r, k, v = (tp.copy(tp.gather(t, -1))[..., h0 * hd:h1 * hd]
                   for t in (r, k, v))
        w = tp.copy(w)[..., h0 * hd:h1 * hd]
        u = tp.copy(u)[h0:h1]
        H = h1 - h0
    elif sharded:
        H //= tp.size
        w = tp.local(tp.copy(w), -1)
        u = tp.local(tp.copy(u), 0)
    r, k, v, w = (t.reshape(B, S, H, hd) for t in (r, k, v, w))

    if state is not None:
        rt, kt, vt, wt = (a[:, 0].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        s_prev = state["wkv"].float()
        out = torch.einsum("bhk,bhkv->bhv", rt,
                           s_prev + u[None, :, :, None] * kv)
        state["wkv"].copy_(wt[..., None] * s_prev + kv)
        state["prev"].copy_(_prev_shard(tp, "tmix", x[:, -1]))
        out = out[:, None].to(x.dtype)
        new_state = state
    else:
        if use_kernel:
            from ..kernels import ops as kops
            out, final = kops.rwkv6_wkv(r, k, v, w, u)
        else:
            out, final = _wkv6_scan(r, k, v, w, u)
        new_state = {"wkv": final,
                     "prev": _prev_shard(tp, "tmix", x[:, -1]).clone()}
    # group norm over each head (ln_x), in f32
    of = out.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    of = ((of - mu) * torch.rsqrt(var + 1e-5)).reshape(B, -1, H * hd)
    if split:
        of = of[..., own:own + D // tp.size]
    out = (of * ln_x["scale"] + ln_x["bias"]).to(x.dtype)
    out = (out * g) @ p["w_o"].to(x.dtype)
    return (tp.reduce(out) if sharded else out), new_state


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x, *,
                     state: Optional[dict] = None, tp=None):
    """RWKV channel mix (squared-ReLU key, sigmoid receptance) over x (B,
    S, D).  ``state`` (decode): ``{"prev": (B, D)}``, updated in place.
    Returns ``(out, state)``.

    Under a tensor-parallel context ``tp``: ``c_k`` column- and ``c_v``
    row-sharded, their partial sums reduced; ``c_r`` is column-sharded,
    but the receptance multiplies the whole value, so its columns are
    gathered first.  ``prev`` is kept as :func:`rwkv_time_mix` keeps
    its own."""
    prev = _prev_whole(tp, "cmix", state)
    xk = _token_shift(x, p["cmu_k"], prev)
    xr = _token_shift(x, p["cmu_r"], prev)
    k_sharded = tp is not None and tp.dim("tmix", "c_k") is not None
    r_sharded = tp is not None and tp.dim("tmix", "c_r") is not None
    k = torch.square(F.relu((tp.copy(xk) if k_sharded else xk)
                            @ p["c_k"].to(x.dtype)))
    kv = k @ p["c_v"].to(x.dtype)
    r = torch.sigmoid((tp.copy(xr) if r_sharded else xr)
                      @ p["c_r"].to(x.dtype))
    out = ((tp.gather(r, -1) if r_sharded else r)
           * (tp.reduce(kv) if k_sharded else kv))
    last = _prev_shard(tp, "cmix", x[:, -1])
    if state is None:
        return out, {"prev": last.clone()}
    state["prev"].copy_(last)
    return out, state
