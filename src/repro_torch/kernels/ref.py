"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in ``repro/kernels/ref.py`` and of ``chunk_cuts`` in
``repro/kernels/fused_grad_sync.py``).

The CPU path of every kernel wrapper in :mod:`.ops` is one of these.  On
the card the gradient-sync kernels are held bitwise equal to them, and the
flash-attention kernel within the tolerances of ``tests/test_kernels.py``.
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd).  Dense softmax
    attention with GQA head grouping (head h reads KV head h // (H/KV)) and
    an optional causal and sliding-window mask, positions counted from 0.
    Scores and softmax in f32; the probabilities are cast to v's dtype
    before the PV product, as in the reference."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = (kpos <= qpos if causal
          else torch.ones((S, T), dtype=torch.bool, device=q.device))
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd)
