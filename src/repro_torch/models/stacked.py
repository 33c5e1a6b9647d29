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

Serving: :func:`init_cache` keeps the reference's stacked cache layout (a
list per layer group of ``{"k", "v"}``, each (n_layers, B, size, KV, hd)),
:func:`prefill` returns the last position's logits and fresh caches, and
:func:`decode_step` advances one token per row.  ``use_kernels=True`` runs
attention through the flash-attention kernel, as the reference's
``use_kernels`` runs its Pallas kernel; the train step never sets it.
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


def _layers(params, cfg: ModelConfig):
    """Each layer's parameters: views of the stacked leaves (unbound once,
    so the backward stacks the per-layer gradients once per leaf)."""
    group = params["groups"][0]
    per_leaf = [leaf.unbind(0) for leaf in T.leaves(group)]
    return [T.unflatten(group, [u[li] for u in per_leaf])
            for li in range(cfg.n_layers)]


def _embed_positions(params, cfg: ModelConfig, tokens):
    """Embedded tokens (B, S, D), with the sinusoid added for
    ``rope_frac == 0``, and the positions (S,)."""
    x = M._embed(params, cfg, tokens)
    S = x.shape[1]
    if cfg.rope_frac == 0.0:
        x = x + M._sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    return x, torch.arange(S, device=x.device)


def hidden_forward(params, cfg: ModelConfig, tokens, *,
                   use_kernels: bool = False, remat: bool = False):
    """Everything before the unembed: (B, S) tokens -> (B, S, D) normed
    hidden states."""
    x, positions = _embed_positions(params, cfg, tokens)

    def block(p, x):
        return M._layer_fwd(p, cfg, x, positions, use_kernels=use_kernels)

    for p in _layers(params, cfg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, p, x, use_reentrant=False)
        else:
            x = block(p, x)
    return L.norm_fwd(params["final_norm"], cfg, x)


def forward(params, cfg: ModelConfig, tokens, *, use_kernels: bool = False,
            remat: bool = False):
    """Full-sequence logits (B, S, vocab)."""
    x = hidden_forward(params, cfg, tokens, use_kernels=use_kernels,
                       remat=remat)
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


# ------------------------------------------------------------------- decode
def _stack_caches(per_layer: list) -> list:
    """Per-layer ``{"k", "v"}`` caches into the stacked layout: one group
    of (n_layers, B, size, KV, hd) leaves."""
    return [{name: torch.stack([c[name] for c in per_layer])
             for name in ("k", "v")}]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Zero decode caches in the reference's stacked layout."""
    dev = resolve_device(device)
    return _stack_caches(M.init_cache(cfg, batch, cache_len, device=dev))


def decode_step(params, cfg: ModelConfig, caches, token, pos):
    """One serving step.  ``token`` (B,) int; ``pos`` the position each row
    writes: a scalar, as in the reference, or (B,) for one per row.
    Writes the new k/v into ``caches`` in place.  Returns (logits (B,
    vocab), caches)."""
    x = M._embed(params, cfg, token[:, None])
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    if cfg.rope_frac == 0.0:
        D = cfg.d_model
        dim = torch.arange(0, D, 2, device=x.device).float() / D
        ang = pos.float()[:, None] / torch.pow(10000.0, dim)
        pe = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        pe[:, 0::2] = torch.sin(ang).to(x.dtype)
        pe[:, 1::2] = torch.cos(ang).to(x.dtype)
        x = x + pe[:, None]
    positions = pos[:, None]
    group = caches[0]
    for li, p in enumerate(_layers(params, cfg)):
        x, _ = M._layer_fwd(p, cfg, x, positions,
                            cache={"k": group["k"][li], "v": group["v"][li]},
                            pos=pos)
    x = L.norm_fwd(params["final_norm"], cfg, x)
    return M._unembed(params, cfg, x)[:, 0], caches


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            use_kernels: bool = False):
    """Run a (B, S) prompt; returns the last position's logits (B, vocab)
    and fresh caches of length ``cache_len`` holding the prompt's k/v."""
    x, positions = _embed_positions(params, cfg, tokens)
    per_layer = []
    for p in _layers(params, cfg):
        x, c = M._layer_fwd(p, cfg, x, positions, return_cache=True,
                            cache_len=cache_len, use_kernels=use_kernels)
        per_layer.append(c)
    x = L.norm_fwd(params["final_norm"], cfg, x[:, -1:])
    return M._unembed(params, cfg, x)[:, 0], _stack_caches(per_layer)
