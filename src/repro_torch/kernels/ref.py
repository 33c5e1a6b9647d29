"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in ``repro/kernels/ref.py`` and of ``chunk_cuts`` in
``repro/kernels/fused_grad_sync.py``).

The CPU path of every kernel wrapper in :mod:`.ops` is one of these.  On
the card the gradient-sync kernels are held bitwise equal to them, and the
flash-attention, RG-LRU and WKV-6 kernels within the tolerances of
``tests/test_kernels.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def chunk_cuts(total: int, chunks: int) -> list[int]:
    """Even element-range chunk boundaries: chunk ``c`` covers
    ``[total*c//k, total*(c+1)//k)`` — the split convention of the pricing
    layer and of ``sync_grads``."""
    k = max(int(chunks), 1)
    return [total * c // k for c in range(k + 1)]


def convert_copy_ref(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """A copy of ``x`` in ``out_dtype`` (round to nearest even)."""
    return x.to(out_dtype, copy=True)


def bucket_pack_ref(leaves: list, total: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unfused-bucket staging: each leaf flattened and converted to
    ``out_dtype`` (round to nearest even), concatenated and zero-padded to
    ``total``."""
    buf = torch.cat([l.reshape(-1).to(out_dtype) for l in leaves])
    return F.pad(buf, (0, total - buf.numel()))


def fused_pack_ref(leaves: list, total: int, dp: int,
                   chunks: int = 1) -> list:
    """Reduce-scatter-ready staging: the leaves cast to f32, concatenated,
    zero-padded to ``total``, cut at :func:`chunk_cuts` into ``chunks``
    ranges, each zero-padded to a multiple of ``dp``."""
    buf = torch.cat([l.reshape(-1).float() for l in leaves])
    buf = F.pad(buf, (0, total - buf.numel()))
    cuts = chunk_cuts(total, chunks)
    out = []
    for c in range(len(cuts) - 1):
        part = buf[cuts[c]:cuts[c + 1]]
        out.append(F.pad(part, (0, (-part.numel()) % max(int(dp), 1))))
    return out


def fused_unpack_ref(buf: torch.Tensor, shapes, dtypes) -> list:
    """All-gather epilogue: slice the flat f32 bucket per leaf, cast each
    slice to its gradient dtype and reshape."""
    out = []
    off = 0
    for shape, dt in zip(shapes, dtypes):
        n = math.prod(shape)
        out.append(buf[off:off + n].reshape(shape).to(dt))
        off += n
    return out


def _attention_mask(rows: torch.Tensor, keys: torch.Tensor, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """(len(rows), len(keys)) bool: which keys each query row sees."""
    ok = torch.ones((rows.numel(), keys.numel()), dtype=torch.bool,
                    device=rows.device)
    if causal:
        ok = ok & (keys[None, :] <= rows[:, None])
    if window is not None:
        ok = ok & (keys[None, :] > rows[:, None] - window)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        return_lse: bool = False):
    """q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd).  Dense softmax
    attention with GQA head grouping (head h reads KV head h // (H/KV)) and
    an optional causal and sliding-window mask, positions counted from 0.
    Scores and softmax in f32 (f64 for f64 inputs); the probabilities are
    cast to v's dtype before the PV product, as in the reference.  With
    ``return_lse`` also each row's log-sum-exp of the masked scaled scores
    (natural log), (B,H,S) in the scores' dtype, what the kernel's forward
    saves for its backward."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).to(acc) / math.sqrt(hd)
    ok = _attention_mask(torch.arange(S, device=q.device),
                         torch.arange(T, device=q.device), causal, window)
    s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    out = out.reshape(B, S, H, hd)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return out


# The backward kernel's tiles (csrc/flash_attention.cu, BwdTile): keys per
# block and query rows per step.
BWD_KEYS, BWD_ROWS = 128, 64


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_ref` at output
    ``o`` with upstream gradient ``do`` (both (B,S,H,hd)), recomputed from
    the forward's log-sum-exp ``lse`` (B,H,S) as the backward kernel does:
    D = rowsum(do * o); for each block of :data:`BWD_KEYS` keys and each
    tile of :data:`BWD_ROWS` query rows that some key of the block sees,
    P = exp(scale q.k - lse) under the masks, dP = do.v, dS = P (dP - D),
    dV += P^T.do and dK += dS^T.q summed over the G query heads of each KV
    head, dQ += dS.k; dq and dk times the scale.  Sums in f32 (f64 for f64
    inputs), P and dS rounded to v's dtype before their products, the
    results in the inputs' dtypes.  A row the masks leave no key (a window
    that ends before the keys do, without causality) has no gradient
    here."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(hd)

    def heads(t):                                  # (B,S,H,hd) -> (B,KV,G,S,hd)
        return t.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4).to(acc)

    qg, og, dog = heads(q), heads(o), heads(do)
    kf, vf = (t.permute(0, 2, 1, 3).to(acc) for t in (k, v))   # (B,KV,T,hd)
    lg = lse.reshape(B, KV, G, S).to(acc)
    dvec = (dog * og).sum(-1)                                  # D
    dq = torch.zeros_like(qg)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rnd = v.dtype
    for n0 in range(0, T, BWD_KEYS):
        n1 = min(n0 + BWD_KEYS, T)
        m_lo = n0 if causal else 0
        m_hi = min(S, n1 - 1 + window) if window is not None else S
        for q0 in range(m_lo // BWD_ROWS * BWD_ROWS, m_hi, BWD_ROWS):
            q1 = min(q0 + BWD_ROWS, S)
            ok = _attention_mask(torch.arange(q0, q1, device=q.device),
                                 torch.arange(n0, n1, device=q.device),
                                 causal, window)
            kt, vt = kf[:, :, n0:n1], vf[:, :, n0:n1]
            s = torch.einsum("bkgqd,bktd->bkgqt", qg[..., q0:q1, :], kt)
            p = torch.exp(s * scale - lg[..., q0:q1, None])
            p = p.masked_fill(~ok, 0.0)
            dp = torch.einsum("bkgqd,bktd->bkgqt", dog[..., q0:q1, :], vt)
            ds = p * (dp - dvec[..., q0:q1, None])
            p, ds = p.to(rnd).to(acc), ds.to(rnd).to(acc)
            dv[:, :, n0:n1] += torch.einsum("bkgqt,bkgqd->bktd", p,
                                            dog[..., q0:q1, :])
            dk[:, :, n0:n1] += torch.einsum("bkgqt,bkgqd->bktd", ds,
                                            qg[..., q0:q1, :])
            dq[..., q0:q1, :] += torch.einsum("bkgqt,bktd->bkgqd", ds, kt)
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    dk = (dk * scale).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def rglru_ref(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
              lam: torch.Tensor) -> torch.Tensor:
    """RG-LRU linear recurrence, sequential.  x, r_gate, i_gate: (B,S,L);
    lam: (L,).  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) with
    a_t = exp(-8 softplus(lam) r_t), h from zero.  As in the reference's
    oracle, ``-8 * softplus(lam)`` is taken in lam's dtype and the rest of
    the gate math and the state in f32; the output is in x's dtype."""
    coef = (-8.0 * F.softplus(lam)).float()
    log_a = coef[None, None, :] * r_gate.float()
    a = torch.exp(log_a)
    g = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i_gate.float() * x.float())
    h = torch.zeros_like(g[:, 0])
    out = torch.empty_like(g)
    for t in range(g.shape[1]):
        h = a[:, t] * h + g[:, t]
        out[:, t] = h
    return out.to(x.dtype)


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """WKV-6 recurrence, sequential, in f32.  r, k, v, w: (B,S,H,hd); u:
    (H,hd).  Per (batch, head) an (hd, hd) state S from zero, indexed
    [key i, value j]:

        out_t = r_t^T (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T

    Returns ``(out, final)``: out (B,S,H,hd) in r's dtype and the final
    state (B,H,hd,hd) in f32, as the reference's ``_wkv6_scan`` returns
    them."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    ub = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], state + ub * kv)
        state = wf[:, t, :, :, None] * state + kv
    return out.to(r.dtype), state
