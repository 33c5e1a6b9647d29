"""Megatron-style vocab-parallel embedding and cross-entropy (port of
``repro/models/vocab_parallel.py``).

The embedding table and the LM head keep their vocab dim sharded over a
``model`` group (``tp``, a :class:`repro_torch.distributed.
tensor_parallel.ModelGroup` of ``m`` ranks); rank ``r`` holds vocab rows
``[r * V/m, (r + 1) * V/m)``.

* lookup: each rank gathers only its vocab slice (masked), then one
  all-reduce of the (B, S, D) result, in f32, combines;
* CE: each rank computes logits against its vocab slice; the max, the sum
  of exponentials and the gold logit are combined over the group, so the
  (B, S, V) logits only ever exist vocab-sharded.

Both are differentiable: the all-reduces are the group's ``reduce``
(identity backward), the input of the local logits passes through its
``copy`` (all-reduce backward), and the max, a constant shift, takes no
gradient.
"""
from __future__ import annotations

import torch


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, tp
                 ) -> torch.Tensor:
    """embed: this rank's (V/m, D) rows; tokens: (B, S) ints."""
    vshard = embed.shape[0]
    loc = tokens - tp.rank * vshard
    ok = (loc >= 0) & (loc < vshard)
    x = embed[loc.clamp(0, vshard - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    # combine in f32, as the reference does
    return tp.reduce(x.float()).to(x.dtype)


def ce_chunk(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
             weights: torch.Tensor, tp, *, transpose_head: bool):
    """Vocab-parallel CE over one sequence chunk.

    x: (B, c, D), f32 as the reference passes it; head: this rank's (D,
    V/m) columns of the LM head or, tied (``transpose_head``), its (V/m,
    D) rows of the embedding; targets and weights: (B, c).  Returns
    (ce_sum, weight_sum), equal on every rank of the group."""
    w = head.T if transpose_head else head                   # (D, V/m)
    logits = (tp.copy(x) @ w.to(x.dtype)).float()            # (B, c, V/m)
    vshard = logits.shape[-1]
    m = tp.max(logits.amax(-1))
    z = tp.reduce(torch.exp(logits - m[..., None]).sum(-1))
    logz = m + torch.log(z)
    loc = targets - tp.rank * vshard
    ok = (loc >= 0) & (loc < vshard)
    picked = torch.gather(logits, -1, loc.clamp(0, vshard - 1)[..., None])
    gold = tp.reduce(torch.where(ok, picked[..., 0],
                                 torch.zeros((), device=x.device)))
    return ((logz - gold) * weights).sum(), weights.sum()
