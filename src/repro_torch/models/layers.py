"""Transformer building blocks (port of ``repro/models/layers.py``): norms,
rope, GQA attention, DeepSeek-V2's Multi-head Latent Attention, the FFN and
the routed-expert FFN.

Conventions, as in the reference:
* params are nested dicts of tensors; a projection is ``x @ W`` with ``W``
  of shape (d_in, d_out), cast to the activation dtype at use;
* activations are (B, S, D); attention heads are laid out (B, S, H, hd).

Ported: the train and prefill path over a full sequence (with flash
attention through the CUDA kernel when asked for; MLA never takes it, as in
the reference), and decode against a bf16/f32 KV cache, an int8 KV cache
with bf16 scales, or MLA's compressed latent cache; and the plain,
non-causal attention of the encoder and of the decoder's cross-attention.
Decode takes one position per batch row, so the serving
engine advances every slot in one batched call where the reference vmaps a
batch-1 step; each row computes what the reference's step computes
(``moe_fwd(route_rows=True)`` routes each row as a batch of its own).

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
               cfg: ModelConfig, rot_dim: Optional[int] = None
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,), or (B, S) for one set per row.
    Rotates the first ``rot_dim`` dims of each head (default: the first
    ``rope_frac`` of it)."""
    rot = rot_dim if rot_dim is not None else int(x.shape[-1] * cfg.rope_frac)
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
def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    """f32 normals from ``gen``, on its device; a CPU generator draws on
    the default device (the host, or nothing at all under
    ``torch.device("meta")``)."""
    dev = None if gen.device.type == "cpu" else gen.device
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)


def _dense(gen: torch.Generator, d_in: int, d_out: int,
           lead=()) -> torch.Tensor:
    return _randn(gen, (*lead, d_in, d_out)) / math.sqrt(d_in)


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """f32 attention weights drawn from ``gen`` on its device; ``lead``
    prepends stacked dims."""
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


def _causal_bias(S, T, causal, window, device, q0: int = 0):
    """Additive (S, T) mask of query rows q0..q0+S-1 over keys 0..T-1."""
    qpos = q0 + torch.arange(S, device=device)[:, None]
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
    self-attention takes the query-chunked path so the score matrix
    working set stays bounded, and the rest the dense path."""
    S, T = q.shape[1], k.shape[1]
    if use_flash and mask is None:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if mask is None:
        if S > _CHUNK_THRESHOLD and S == T:
            for blk in (_Q_BLOCK, 256, 128, 64):
                if S % blk == 0:
                    return _flash_xla(q, k, v, causal, window, qb=blk)
        bias = _causal_bias(S, T, causal, window, q.device)[None, None, None]
        return _sdpa_dense(q, k, v, bias)
    bias = mask[:, :, None] if mask.dim() == 4 else mask
    return _sdpa_dense(q, k, v, bias)


def _flash_xla(q, k, v, causal, window, qb: int = _Q_BLOCK):
    """Query-chunked attention in plain PyTorch, the port of the
    reference's long-sequence path (its double ``lax.scan``).  Each block
    of ``qb`` query rows attends over all T keys in one f32 softmax
    (:func:`_sdpa_dense` on its rows) and is rematerialised in the
    backward, so forward and backward hold one block's (B,H,qb,T) scores
    at a time.  The reference also splits the keys into blocks under an
    online softmax, holding (B,H,qb,kb); unrolled in Python that inner
    loop costs (S/qb) x (T/kb) steps a layer in every step and trace, so
    the port takes each block's softmax in one pass (equal to rounding).
    Causality is enforced by masking; blocks are not skipped."""
    S, T = q.shape[1], k.shape[1]
    if S % qb:
        raise ValueError(f"blocks of {qb} rows do not tile {S}")

    def block(qblk, i):
        bias = _causal_bias(qb, T, causal, window, q.device, q0=i * qb)
        return _sdpa_dense(qblk, k, v, bias[None, None, None])

    outs = []
    for i in range(S // qb):
        qblk = q[:, i * qb:(i + 1) * qb]
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, qblk, i, use_reentrant=False))
        else:
            outs.append(block(qblk, i))
    return torch.cat(outs, 1)


def attention_fwd(p: dict, cfg: ModelConfig, x, positions, *,
                  cache: Optional[dict] = None,
                  pos: Optional[torch.Tensor] = None,
                  window: Optional[int] = None, use_flash: bool = False,
                  return_cache: bool = False, cache_len: int = 0, tp=None):
    """Self-attention.  Train/prefill when ``cache`` is None (optionally
    returning a fresh cache of length ``cache_len``); decode when ``cache``
    and ``pos`` are given (x is (B,1,D); ``pos`` a scalar or one position
    per row, and ``positions`` (1,) or (B,1) to match).  Decode writes the
    new k/v into ``cache`` in place and returns it; the reference returns an
    updated copy.  Returns ``out``, or ``(out, cache)`` when a cache is
    given or asked for.  With a tensor-parallel context ``tp`` ``p`` holds
    this rank's slices and the cache this rank's shard: see
    :func:`_attention_tp`."""
    if tp is not None and tp.dim("attn", "wq") is not None:
        return _attention_tp(p, cfg, x, positions, tp, window, cache=cache,
                             pos=pos, use_flash=use_flash,
                             return_cache=return_cache, cache_len=cache_len)
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
        mask, new_cache = _write_cache(cache, k, v, pos, window)
        kd, vd = _cache_kv(cache, q.dtype)
        out = sdpa(q, kd, vd, mask[:, None, None, :])
    else:
        out = sdpa(q, k, v, None, use_flash=use_flash, window=window)
        if return_cache:
            new_cache = _fresh_cache(k, v, cache_len)
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return (out, new_cache) if (return_cache or cache is not None) else out


def _fresh_cache(k, v, cache_len: int) -> dict:
    """A prefill's cache of ``cache_len`` (S by default) positions holding
    the last of the prompt's k and v (B, S, KV, hd) from slot 0."""
    B, S = k.shape[:2]
    size = cache_len or S
    take = min(S, size)
    ck = k.new_zeros((B, size, *k.shape[2:]))
    cv = v.new_zeros((B, size, *v.shape[2:]))
    ck[:, :take] = k[:, S - take:]
    cv[:, :take] = v[:, S - take:]
    return {"k": ck, "v": cv}


def _cache_kv(cache: dict, dt) -> tuple:
    """The cache's k and v in ``dt``: an int8 cache's entries times their
    scales, the whole cache dequantised every step, as in the
    reference."""
    if "k_scale" not in cache:
        return cache["k"].to(dt), cache["v"].to(dt)
    return tuple(cache[n].to(dt) * cache[n + "_scale"][..., None].to(dt)
                 for n in ("k", "v"))


def _write_cache(cache: dict, k, v, pos, window, head_max=None):
    """Decode: write each row's new k and v (B, 1, KV, hd) at its position
    (``pos % size`` in a window's ring buffer), clamped into the cache as
    the reference's ``dynamic_update_slice`` clamps, in place; an int8
    cache gets the entries quantised with symmetric scales per (row,
    slot, KV head), stored in bf16.  Where k and v are this rank's slices
    of ``head_dim``, ``head_max`` (the model group's max) gives each
    head's whole max, so every rank stores the scale the whole head has.
    Returns the additive f32 mask (B, size) of the entries each row
    reads, and the cache."""
    ck, cv = cache["k"], cache["v"]
    B, S = k.shape[:2]
    csize = ck.shape[1]
    pos = _row_positions(pos, B, k.device)
    slot = pos % csize if window is not None else pos
    slot = slot.clamp(0, csize - S)
    rows = torch.arange(B, device=k.device)
    if "k_scale" in cache:
        kq, ks = _quantize_int8(k[:, 0], head_max)
        vq, vs = _quantize_int8(v[:, 0], head_max)
        ck[rows, slot] = kq
        cv[rows, slot] = vq
        cache["k_scale"][rows, slot] = ks.to(cache["k_scale"].dtype)
        cache["v_scale"][rows, slot] = vs.to(cache["v_scale"].dtype)
    else:
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
    kpos = torch.arange(csize, device=k.device)[None, :]
    if window is not None:
        # ring buffer: entry i holds an absolute position within the last
        # `csize` positions
        age = (slot[:, None] - kpos) % csize
        ok = age <= torch.clamp(pos, max=csize - 1)[:, None]
    else:
        ok = kpos <= pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=k.device)
    mask = torch.where(ok, zero, torch.full_like(zero, _F32_MIN))
    return mask, {n: cache[n] for n in ("k", "v", "k_scale", "v_scale")
                  if n in cache}


def _attention_tp(p: dict, cfg: ModelConfig, x, positions, tp, window, *,
                  memory=None, plain: bool = False, scope=("attn",),
                  cache: Optional[dict] = None, pos=None,
                  use_flash: bool = False, return_cache: bool = False,
                  cache_len: int = 0):
    """Tensor-parallel attention over the ``model`` group of ``tp``, by the
    reference's sharding rules (``distributed/sharding.py``).

    Aligned query heads (``n_heads % m == 0``): ``wq`` is column-sharded,
    so this rank computes its ``n_heads / m`` heads and ``wo``,
    row-sharded, gives partial sums that ``reduce`` adds up.  Its heads
    read their own KV heads: local ones when ``wk``/``wv`` are
    column-sharded too, else those they map to in the replicated k and v.
    Unaligned heads: ``wq`` is sharded on its input dim (a partial q,
    reduced), k and v are replicated, every rank attends with all heads,
    and ``wo``, sharded on its output dim, gives output columns that
    ``gather`` joins.  Biases are replicated: a rank adds its heads' slice.
    ``use_flash`` runs the rank's heads through the flash kernel, as
    :func:`sdpa` routes it.

    The cache holds this rank's shard by the rules' ``cache_specs``
    (``tp.cache_dim("k")``): its KV heads where they divide the group
    (then ``wk`` and ``wv`` are column-sharded), else its slice of
    ``head_dim`` of every KV head.  A prefill stores the slice of the
    whole k and v.  Against a ``head_dim``-sliced cache a decode step
    gathers every query head (the unaligned layout has them all), takes
    the partial scores of its slice in f32, sums them over the group,
    weights its slice of v and gathers the heads' outputs back; the
    layout's output projection follows (ROADMAP C28).  An int8 cache is
    dequantised by its scales before the scores in both layouts; on a
    ``head_dim`` slice each new entry is quantised with its whole head's
    scale, the slices' max taken over the group (one MAX all-reduce for
    k and one for v a step), so every rank stores the entries and
    scales a single device would.

    ``plain`` is the attention of the encoder and of the decoder's
    cross-attention (:func:`cross_attention_fwd`): no rope, no bias, no
    mask.  k and v come from ``memory`` (replicated, through ``copy``)
    where it is given, else from ``x``.  ``scope`` names the block's
    subtree in the layer (``attn``, ``xattn``, or ``encoder`` and ``attn``
    for an encoder layer), where ``tp`` finds its specs."""
    B, S, D = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    kv_in = x if memory is None else memory
    T = kv_in.shape[1]

    def proj(inp, name, bias_slice):
        out = inp @ p[name].to(dt)
        if cfg.qkv_bias and not plain:
            b = p["b" + name[1]]
            out = out + (tp.local(tp.copy(b), -1) if bias_slice else b).to(dt)
        return out

    def rope(t):
        return t if plain else apply_rope(t, positions, cfg)

    unaligned = tp.dim(*scope, "wq") == 0
    kv_local = False
    if unaligned:
        # q from this rank's slice of the input dim, summed
        Hl = H
        xq = tp.local(tp.copy(x), -1)
        q = tp.reduce(xq @ p["wq"].to(dt))
        if cfg.qkv_bias and not plain:
            q = q + p["bq"].to(dt)
        k, v = proj(kv_in, "wk", False), proj(kv_in, "wv", False)
    else:
        Hl = H // tp.size
        xs = tp.copy(x)
        kvs = xs if memory is None else tp.copy(memory)
        q = proj(xs, "wq", True)
        kv_local = tp.dim(*scope, "wk") is not None
        if kv_local:
            k, v = proj(kvs, "wk", True), proj(kvs, "wv", True)
        else:
            # replicated k and v: this rank's heads read the KV heads they
            # map to, and only those get a gradient here
            k = tp.copy(proj(kv_in, "wk", False))
            v = tp.copy(proj(kv_in, "wv", False))
    KVc = k.shape[-1] // hd                  # the KV heads this rank holds
    q = rope(q.reshape(B, S, Hl, hd))
    k = rope(k.reshape(B, T, KVc, hd))
    v = v.reshape(B, T, KVc, hd)

    def mine(t):
        """The KV heads this rank's query heads read, of ``t``."""
        if unaligned or kv_local:
            return t
        G = H // KV
        first = tp.rank * Hl
        if Hl % G == 0:
            return t[:, :, first // G:first // G + Hl // G].contiguous()
        idx = torch.arange(first, first + Hl, device=t.device) // G
        return t[:, :, idx]

    def out_proj(o):
        o = o.reshape(B, S, Hl * hd)
        if unaligned:
            return tp.gather(tp.copy(o) @ p["wo"].to(dt), -1)
        return tp.reduce(o @ p["wo"].to(dt))

    if cache is None:
        out = out_proj(sdpa(q, mine(k), mine(v), None, use_flash=use_flash,
                            window=window, causal=not plain))
        if not return_cache:
            return out
        if tp.cache_dim("k") == 3:
            k, v = tp.local(k, -1), tp.local(v, -1)
        return out, _fresh_cache(k, v, cache_len)
    sliced = tp.cache_dim("k") == 3
    mask, new_cache = _write_cache(
        cache, *((tp.local(t, -1) if sliced else t) for t in (k, v)), pos,
        window, head_max=tp.max if sliced else None)
    kd, vd = _cache_kv(cache, dt)
    if not sliced:
        return out_proj(sdpa(q, mine(kd), mine(vd),
                             mask[:, None, None, :])), new_cache
    # this rank's slice of head_dim: partial scores of every query head
    qa = q if unaligned else tp.gather(q, 2)
    qg = tp.local(qa, -1).reshape(B, S, KV, H // KV, -1)
    scores = tp.reduce(torch.einsum("bskgh,btkh->bkgst", qg.float(),
                                    kd.float())) / math.sqrt(hd)
    w = torch.softmax(scores + mask[:, None, None, None, :], dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", w.to(vd.dtype), vd)
    o = tp.gather(o.reshape(B, S, H, -1), -1)
    return out_proj(o if unaligned else tp.local(o, 2)), new_cache


def cross_attention_fwd(p: dict, cfg: ModelConfig, x, memory, tp=None,
                        scope=("xattn",)):
    """Attention of ``x``'s queries over ``memory``'s keys and values with
    no rope, bias or mask, through the plain :func:`sdpa` (never the flash
    kernel), as the reference computes the decoder's cross-attention over
    the encoder's output (B, T, D) and, with ``memory`` the normed input
    itself, the encoder's self-attention.  With a tensor-parallel context ``tp`` whose
    rules shard the block (its specs found under ``scope``), this rank's
    heads (:func:`_attention_tp`)."""
    if tp is not None and tp.dim(*scope, "wq") is not None:
        return _attention_tp(p, cfg, x, None, tp, None, memory=memory,
                             plain=True, scope=scope)
    B, S, D = x.shape
    T, hd = memory.shape[1], cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (memory @ p["wk"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    v = (memory @ p["wv"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    out = sdpa(q, k, v, None, causal=False)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def _row_positions(pos, B: int, device) -> torch.Tensor:
    """A decode step's write position per row, (B,), from a scalar or (B,)
    ``pos``."""
    return torch.as_tensor(pos, device=device).reshape(-1).expand(B)


def _quantize_int8(t: torch.Tensor,
                   head_max=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last dim: (entries, f32 scales), the scale
    max|t| / 127 and each entry ``t / scale`` rounded half to even.  With
    ``head_max``, ``t`` is a slice of the last dim and the max is
    ``head_max`` of the slice's (the whole dim's, the same bits on every
    slice)."""
    tf = t.float()
    amax = tf.abs().amax(-1)
    scale = (amax if head_max is None else head_max(amax)) / 127.0
    q = torch.round(tf / torch.clamp(scale[..., None], min=1e-8))
    return q.to(torch.int8), scale


# --------------------------------------------------------------------- MLA
def init_mla(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """f32 MLA weights drawn from ``gen``: the query projection (low-rank
    ``w_dq``, ``q_norm``, ``w_uq`` when ``q_lora_rank`` is set, else
    ``wq``), the latent's down projection ``w_dkv`` and ``kv_norm``, the
    shared rope key ``w_kr``, the up projections ``w_uk`` and ``w_uv``, and
    ``wo``."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qdim = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)

    def ones(n):
        return {"scale": torch.ones((*lead, n), dtype=torch.float32)}

    p: dict = {}
    if m.q_lora_rank:
        p["w_dq"] = _dense(gen, d, m.q_lora_rank, lead)
        p["w_uq"] = _dense(gen, m.q_lora_rank, qdim, lead)
        p["q_norm"] = ones(m.q_lora_rank)
    else:
        p["wq"] = _dense(gen, d, qdim, lead)
    p["w_dkv"] = _dense(gen, d, m.kv_lora_rank, lead)
    p["w_kr"] = _dense(gen, d, m.qk_rope_head_dim, lead)
    p["kv_norm"] = ones(m.kv_lora_rank)
    p["w_uk"] = _dense(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, lead)
    p["w_uv"] = _dense(gen, m.kv_lora_rank, H * m.v_head_dim, lead)
    p["wo"] = _dense(gen, H * m.v_head_dim, d, lead)
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    ms = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def mla_fwd(p: dict, cfg: ModelConfig, x, positions, *,
            cache: Optional[dict] = None, pos=None,
            return_cache: bool = False, cache_len: int = 0, tp=None):
    """Multi-head Latent Attention (DeepSeek-V2).  The decode cache holds
    only the compressed latent ``c_kv`` (B, T, kv_lora_rank) and the shared
    rope key ``k_rope`` (B, T, qk_rope_head_dim).  Train/prefill (``cache``
    None) folds (nope ++ rope) into one head dim through :func:`sdpa`,
    never the flash kernel, as the reference does; decode writes each row's
    latent at its own position in place (clamped, as the reference's
    ``dynamic_update_slice``) and attends over the whole cache, masked.

    Under a tensor-parallel context ``tp`` whose rules shard the heads,
    this rank computes its ``H / m`` heads: ``wq`` (or ``w_uq`` after the
    replicated ``w_dq`` and ``q_norm``), ``w_uk`` and ``w_uv`` are
    column-sharded over whole heads (their head-major columns); the latent
    and the shared rope key, computed whole from replicated leaves, reach
    the local heads through ``copy``; ``wo`` is row-sharded, its partial
    sums reduced.  The cache holds this rank's slice of the last dim of
    ``c_kv`` and of ``k_rope`` where the rules shard them
    (``tp.cache_dim``): a prefill stores its slice of the whole latent,
    and a decode step writes its slice and all-gathers the whole cache
    over the group before the up projections (ROADMAP C28)."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    sharded = tp is not None and tp.dim(
        "attn", "w_uq" if m.q_lora_rank else "wq") is not None

    def heads(t):                   # a replicated input of local heads
        return tp.copy(t) if sharded else t

    if m.q_lora_rank:
        q = _rms(x @ p["w_dq"].to(x.dtype), p["q_norm"]["scale"])
        q = heads(q) @ p["w_uq"].to(x.dtype)
    else:
        q = heads(x) @ p["wq"].to(x.dtype)
    if sharded:
        H //= tp.size
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg, rot_dim=dr)

    c_kv = _rms(x @ p["w_dkv"].to(x.dtype), p["kv_norm"]["scale"])
    k_rope = apply_rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :],
                        positions, cfg, rot_dim=dr)         # (B, S, 1, dr)
    c_kv, k_rope = heads(c_kv), heads(k_rope)

    new_cache = None
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        T = cc.shape[1]
        pos = _row_positions(pos, B, x.device)
        slot = pos.clamp(0, T - S)
        rows = torch.arange(B, device=x.device)
        cd, rd = (tp.cache_dim(n) if tp is not None else None
                  for n in ("c_kv", "k_rope"))
        cc[rows, slot] = (c_kv[:, 0] if cd is None else
                          tp.local(c_kv[:, 0], -1)).to(cc.dtype)
        cr[rows, slot] = (k_rope[:, 0, 0] if rd is None else
                          tp.local(k_rope[:, 0, 0], -1)).to(cr.dtype)
        new_cache = {"c_kv": cc, "k_rope": cr}
        c_kv_all = (cc if cd is None else tp.gather(cc, -1)).to(x.dtype)
        k_rope_all = (cr if rd is None else
                      tp.gather(cr, -1)).to(x.dtype)[:, :, None]
        ok = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        bias = torch.where(ok, zero, torch.full_like(zero, _F32_MIN))
        bias = bias[:, None, None, :]                       # (B, 1, 1, T)
    else:
        c_kv_all, k_rope_all = c_kv, k_rope
        T = S
        if return_cache:
            size = cache_len or S
            take = min(S, size)
            c_new, r_new = c_kv, k_rope[:, :, 0]
            if tp is not None and tp.cache_dim("c_kv") is not None:
                c_new = tp.local(c_new, -1)
            if tp is not None and tp.cache_dim("k_rope") is not None:
                r_new = tp.local(r_new, -1)
            cc = c_new.new_zeros((B, size, c_new.shape[-1]))
            cr = r_new.new_zeros((B, size, r_new.shape[-1]))
            cc[:, :take] = c_new[:, :take]
            cr[:, :take] = r_new[:, :take]
            new_cache = {"c_kv": cc, "k_rope": cr}

    # the latent's up projections: k_nope (B, T, H, dn), v (B, T, H, dv)
    k_nope = (c_kv_all @ p["w_uk"].to(x.dtype)).reshape(B, T, H, dn)
    vv = (c_kv_all @ p["w_uv"].to(x.dtype)).reshape(B, T, H, m.v_head_dim)
    if cache is None:
        # scores = q_nope.k_nope + q_rope.k_rope as one head of dn + dr;
        # sdpa's 1/sqrt(hd) is MLA's 1/sqrt(dn + dr)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, k_rope_all.expand(B, T, H, dr)], dim=-1)
        v_pad = F.pad(vv, (0, q_eff.shape[-1] - m.v_head_dim))
        out = sdpa(q_eff, k_eff, v_pad, None, causal=True)[..., :m.v_head_dim]
        out = out.reshape(B, S, -1) @ p["wo"].to(x.dtype)
        if sharded:
            out = tp.reduce(out)
        return (out, new_cache) if return_cache else out
    scale = 1.0 / np.sqrt(dn + dr)
    s_nope = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    s_rope = torch.einsum("bshd,btxd->bhst", q_rope,
                          k_rope_all.expand(B, T, 1, dr))
    scores = (s_nope + s_rope).float() * scale + bias
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, vv).reshape(B, S, -1)
    out = out @ p["wo"].to(x.dtype)
    return (tp.reduce(out) if sharded else out), new_cache


# --------------------------------------------------------------------- FFN
def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead=(),
             d_ff: Optional[int] = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {"w_down": _dense(gen, d_ff, cfg.d_model, lead),
         "w_up": _dense(gen, cfg.d_model, d_ff, lead)}
    if cfg.glu:
        p["w_gate"] = _dense(gen, cfg.d_model, d_ff, lead)
    return p


def _act(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.relu(x)


def mlp_fwd(p: dict, cfg: ModelConfig, x, tp=None, scope=("mlp",)):
    """The FFN.  With a tensor-parallel context ``tp`` whose rules shard
    it (its specs under ``scope``), ``w_up``/``w_gate`` are
    column-sharded and ``w_down`` row-sharded: this rank's FFN columns
    give partial sums that ``tp.reduce`` adds."""
    sharded = tp is not None and tp.dim(*scope, "w_up") is not None
    if sharded:
        x = tp.copy(x)
    up = x @ p["w_up"].to(x.dtype)
    if cfg.glu:
        h = _act(cfg, x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = _act(cfg, up)
    out = h @ p["w_down"].to(x.dtype)
    return tp.reduce(out) if sharded else out


# --------------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, cfg: ModelConfig, lead, cast) -> dict:
    """Routed experts: the router (d, E) at scale 0.02, the experts'
    stacked FFN weights (E, d, de) and (E, de, d), and the shared experts
    as one FFN of width ``n_shared * d_expert``.  ``cast`` is applied to
    each expert stack as soon as it is drawn, so only one f32 stack is
    alive at a time."""
    e = cfg.moe
    d, de, E = cfg.d_model, e.d_expert, e.n_routed
    p = {
        "router": _randn(gen, (*lead, d, E)) * 0.02,
        "w_up": cast(_dense(gen, d, de, (*lead, E))),
        "w_down": cast(_dense(gen, de, d, (*lead, E))),
    }
    if cfg.glu:
        p["w_gate"] = cast(_dense(gen, d, de, (*lead, E)))
    if e.n_shared:
        p["shared"] = init_mlp(gen, cfg, lead, d_ff=e.n_shared * de)
    return p


def moe_fwd(p: dict, cfg: ModelConfig, x, *, route_rows: bool = False,
            tp=None):
    """Top-k routed experts with sort-based dispatch, as the reference's
    ``moe_fwd``: a softmax router, the top k with ties to the lower index,
    renormalised weights and the Switch load-balance aux loss; the token
    copies sorted stably by expert, each expert keeping its first C in that
    order (C from the token count T), packed into an (E, C, D) buffer; the
    experts as batched GEMMs over E; the weighted outputs added back in
    token order (each token's in ascending expert order, as the sorted
    scatter-add adds them); then the shared experts.  Returns (out,
    aux_loss).

    ``route_rows`` routes each batch row as a batch of its own (T = S per
    row), as the reference engine's vmap over batch-1 decode steps does;
    the aux loss is then the rows' mean.  Counts use a static-shape
    scatter-add, so the function traces on meta tensors.

    Under a tensor-parallel context ``tp`` (training) whose rules shard the
    expert stacks, expert parallelism: every rank routes all tokens with
    the replicated router (the same routing and capacity everywhere) and
    runs its ``E / m`` experts' slots of the buffer; their weighted
    outputs are partial sums, reduced, and the tokens reach the local
    experts through ``copy``.  The router's gradient has two parts: the
    aux loss's, whole on every rank, and the combine weights', the local
    experts' share only, so the weights (and only they) pass through
    ``copy``.  Where the rules' ZeRO-3 specs lay the experts out instead
    (all of them on every rank once gathered over the data ranks, each
    expert's ``w_up``/``w_gate`` sharded on its FFN dim and ``w_down`` on
    its output dim), every rank runs every expert's slots: the tokens
    reach the column-sharded projections through ``copy``, the hidden
    columns are gathered (and passed through ``copy``, since each rank
    reads them with other ``w_down`` columns), and the output columns are
    gathered, so the output and the combine weights are whole on every
    rank.  The shared experts follow :func:`mlp_fwd`'s rule."""
    e = cfg.moe
    B, S, D = x.shape
    G, T = (B, S) if route_rows else (1, B * S)
    k, E = e.top_k, e.n_routed
    C = max(int(np.ceil(e.capacity_factor * k * T / E)), min(8, T * k))
    dev, dt = x.device, x.dtype
    dim = tp.dim("moe", "w_up") if tp is not None else None
    sharded = dim == 0                       # experts over the model ranks
    ffn_sharded = dim is not None and dim != 0
    xt = x.reshape(G, T, D)
    logits = (xt @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                   # (G, T, E)
    # a stable descending sort: equal probabilities keep ascending index
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    density = F.one_hot(topi[..., 0], E).float().mean(-2)   # (G, E)
    router_prob = probs.mean(-2)
    aux = (e.aux_loss_coef * E * (density * router_prob).sum(-1)).mean()

    flat_e = topi.reshape(G, T * k)
    flat_w = (tp.copy(topv) if sharded else topv).reshape(G, T * k).to(dt)
    n = T * k
    flat_tok = torch.arange(n, device=dev) // k
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        -1, sorted_e, torch.ones_like(sorted_e))
    offsets = torch.cumsum(counts, -1) - counts
    pos_in_e = torch.arange(n, device=dev) - offsets.gather(-1, sorted_e)
    keep = (pos_in_e < C).to(dt)
    slot = sorted_e * C + torch.clamp(pos_in_e, max=C - 1)
    tok_sorted = flat_tok[order]                            # (G, n)
    rows = (tp.copy(xt) if sharded or ffn_sharded else xt).gather(
        1, tok_sorted[..., None].expand(G, n, D))
    buf = torch.zeros((G, E * C, D), dtype=dt, device=dev).scatter_add_(
        1, slot[..., None].expand(G, n, D), rows * keep[..., None])
    w_sorted = flat_w.gather(-1, order) * keep
    El, e0 = E, 0
    if sharded:
        # this rank's experts' slots; the copies routed elsewhere add 0
        El = E // tp.size
        e0 = tp.rank * El
        buf = buf[:, e0 * C:(e0 + El) * C]
        mine = (sorted_e >= e0) & (sorted_e < e0 + El)
        w_sorted = w_sorted * mine.to(dt)
        slot = torch.where(mine, slot - e0 * C, 0)
    # experts as one batched GEMM over E, the G groups' slots side by side
    xe = buf.reshape(G, El, C, D).transpose(0, 1).reshape(El, G * C, D)
    up = torch.bmm(xe, p["w_up"].to(dt))
    if cfg.glu:
        h = _act(cfg, torch.bmm(xe, p["w_gate"].to(dt))) * up
    else:
        h = _act(cfg, up)
    if ffn_sharded:
        h = tp.copy(tp.gather(h, -1))
    out_e = torch.bmm(h, p["w_down"].to(dt))
    if ffn_sharded:
        out_e = tp.gather(out_e, -1)
    out_e = out_e.reshape(El, G, C, D).transpose(0, 1).reshape(G, El * C, D)
    contrib = out_e.gather(1, slot[..., None].expand(G, n, D)) \
        * w_sorted[..., None]
    # back into token order: unsort, then each token's k contributions in
    # ascending expert order, added one at a time
    by_tok = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(G, n, D), contrib).reshape(G, T, k, D)
    asc = topi.argsort(-1)                   # a token's experts are distinct
    by_tok = by_tok.gather(2, asc[..., None].expand(G, T, k, D))
    out = torch.zeros((G, T, D), dtype=dt, device=dev)
    for j in range(k):
        out = out + by_tok[:, :, j]
    if sharded:
        out = tp.reduce(out)
    if e.n_shared:
        out = out + mlp_fwd(p["shared"], cfg, xt, tp, scope=("moe", "shared"))
    return out.reshape(B, S, D), aux
