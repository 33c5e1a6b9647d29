"""Stacked-parameter dense decoder (port of ``repro/models/stacked.py``).

Parameters keep the reference's layout: homogeneous layers are stacked
along a leading layer dim in ``params["groups"][0]``, and leaves are
ordered as ``jax.tree.leaves`` orders them (:func:`leaves`), so a Plan's
bucket indices name the same tensors in both packages.  For tinyllama that
is 12 leaves: ``embed``, ``final_norm.scale``,
``groups[0].attn.{wk,wo,wq,wv}``, ``groups[0].{ln1,ln2}.scale``,
``groups[0].mlp.{w_down,w_gate,w_up}`` and ``lm_head``.

Where the reference scans the layer group, the port loops over the layers;
``remat`` rematerialises each layer (and each cross-entropy chunk) in the
backward through ``torch.utils.checkpoint``, as ``jax.checkpoint`` does in
the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..device import resolve_device
from . import layers as L
from . import model as M
from .config import ModelConfig

leaves = T.leaves


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters from a CPU ``torch.Generator(seed)`` (so a seed
    gives the same weights on every device), in the reference's shapes and
    dtypes: layer weights and norms in ``cfg.dtype``, the final norm in f32
    (the reference leaves it uncast).  Each leaf is drawn in f32 on the
    host, cast, and moved to ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(seed)
    params: dict = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen)
                  * 0.02).to(device=dev, dtype=dt),
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
        "groups": [T.map(lambda a: a.to(device=dev, dtype=dt),
                         M.init_layer(gen, cfg, (cfg.n_layers,)))],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab),
                                         generator=gen)
                             * 0.02).to(device=dev, dtype=dt)
    return params


def hidden_forward(params, cfg: ModelConfig, tokens, *, remat: bool = False):
    """Everything before the unembed: (B, S) tokens -> (B, S, D) normed
    hidden states."""
    x = M._embed(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.rope_frac == 0.0:
        x = x + M._sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    group = params["groups"][0]
    # unbind once: each layer reads views of the stacked leaves, and the
    # backward stacks the per-layer gradients once per leaf
    per_leaf = [leaf.unbind(0) for leaf in T.leaves(group)]
    for li in range(cfg.n_layers):
        p = T.unflatten(group, [u[li] for u in per_leaf])
        if remat and torch.is_grad_enabled():
            x = checkpoint(M._layer_fwd, p, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = M._layer_fwd(p, cfg, x, positions)
    return L.norm_fwd(params["final_norm"], cfg, x)


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = False):
    """Full-sequence logits (B, S, vocab)."""
    x = hidden_forward(params, cfg, tokens, remat=remat)
    return M._unembed(params, cfg, x)


_CE_CHUNK = 512


def _ce_chunk(params, cfg: ModelConfig, xc, tc, wc):
    """Summed f32 cross-entropy and weight of one sequence chunk."""
    logits = M._unembed(params, cfg, xc).float()
    m = logits.amax(-1)
    logz = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return ((logz - gold) * wc).sum(), wc.sum()


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """Next-token CE computed in sequence chunks with an f32 logsumexp —
    the full (B, S, V) logits tensor is never materialised."""
    tokens = batch["tokens"]
    x = hidden_forward(params, cfg, tokens, remat=remat)
    B, S, D = x.shape
    dev = x.device
    targets = torch.cat(
        [tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype, device=dev)],
        dim=1)
    weights = torch.cat(
        [torch.ones((B, S - 1), dtype=torch.float32, device=dev),
         torch.zeros((B, 1), dtype=torch.float32, device=dev)], dim=1)
    chunk = min(_CE_CHUNK, S)
    while S % chunk:
        chunk -= 1
    ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (params, cfg, x[:, sl], targets[:, sl], weights[:, sl])
        if remat and torch.is_grad_enabled():
            ce, n = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            ce, n = _ce_chunk(*args)
        ce_sum = ce_sum + ce
        cnt = cnt + n
    return ce_sum / torch.clamp(cnt, min=1.0)
