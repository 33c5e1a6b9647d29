"""Plain PyTorch versions of the gradient-sync staging kernels (port of the
matching oracles in ``repro/kernels/ref.py`` and of ``chunk_cuts`` in
``repro/kernels/fused_grad_sync.py``).

The CPU path of every kernel wrapper in :mod:`.ops` is one of these, and on
the card each kernel is held bitwise equal to them.
"""
from __future__ import annotations

import math

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
