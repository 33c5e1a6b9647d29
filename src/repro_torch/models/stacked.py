"""Stacked-parameter decoder (port of ``repro/models/stacked.py``).

Parameters keep the reference's layout: layers are split into homogeneous
groups (:func:`layer_groups`), each stacked along a leading dim in
``params["groups"]``, and leaves are ordered as ``jax.tree.leaves`` orders
them (:func:`leaves`), so a Plan's bucket indices name the same tensors in
both packages.  A dense model is one ``plain`` group of ``n_layers``; for
tinyllama that is 12 leaves: ``embed``, ``final_norm.scale``,
``groups[0].attn.{wk,wo,wq,wv}``, ``groups[0].{ln1,ln2}.scale``,
``groups[0].mlp.{w_down,w_gate,w_up}`` and ``lm_head``.  RWKV-6 is one
``plain`` group too, its blocks holding ``ln1``, ``ln2`` and ``tmix`` (time
mix and channel mix).  A recurrent hybrid is a ``cycle`` group of whole
pattern cycles plus a ``tail`` group of the layers left over, each holding
one subtree ``b{j}`` per position of the cycle (recurrentgemma-9b: 12 x
(rec, rec, attn) and a tail of (rec, rec), 63 leaves).

Where the reference scans a layer group, the port loops over the layers;
``remat`` rematerialises each layer (and each cross-entropy chunk) in the
backward through ``torch.utils.checkpoint``, as ``jax.checkpoint`` does in
the reference.

Serving: :func:`init_cache` keeps the reference's stacked cache layout (a
list per layer group, stacked like the parameters: ``{"k", "v"}`` of
(count, B, size, KV, hd) for attention, ``{"h", "conv"}`` for RG-LRU
blocks, under ``b{j}`` in a cycle, ``{"cmix": {"prev"}, "tmix": {"prev",
"wkv"}}`` for RWKV blocks), :func:`prefill` returns the last position's
logits and fresh caches, and :func:`decode_step` advances one token per
row, writing the caches in place.  ``use_kernels=True`` runs attention
through the flash-attention kernel and the RG-LRU and WKV-6 recurrences
through their kernels, as the reference's ``use_kernels`` runs its Pallas
kernels; the train step never sets it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..device import resolve_device
from . import layers as L
from . import model as M
from .config import ModelConfig
from .regions import scan_region

leaves = T.leaves


def layer_groups(cfg: ModelConfig) -> list[dict]:
    """Segments of homogeneous layers: ``[{"kind", "count", "start",
    "cycle"}]``; a ``cycle`` or ``tail`` group holds ``count`` repeats of
    ``cycle`` consecutive layers."""
    if cfg.recurrent is not None:
        cyc = len(cfg.recurrent.pattern)
        n_cycles = cfg.n_layers // cyc
        groups = []
        if n_cycles:
            groups.append({"kind": "cycle", "count": n_cycles, "start": 0,
                           "cycle": cyc})
        rem = cfg.n_layers - n_cycles * cyc
        if rem:
            groups.append({"kind": "tail", "count": 1,
                           "start": n_cycles * cyc, "cycle": rem})
        return groups
    return [{"kind": "plain", "count": cfg.n_layers, "start": 0, "cycle": 1}]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                draw_on_device: bool = False) -> dict:
    """Random parameters in the reference's shapes and dtypes: layer
    weights and norms in ``cfg.dtype``, the final norm in f32 (the
    reference leaves it uncast).  Each leaf is drawn in f32 from a
    ``torch.Generator(seed)``, cast, and moved to ``device``.  The generator
    is on the CPU, so a seed gives the same weights on every device;
    ``draw_on_device`` draws on ``device`` instead (other numbers, no host
    round trip)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev if draw_on_device else "cpu")
    gen.manual_seed(seed)

    def cast(tree):
        return T.map(lambda a: a.to(device=dev, dtype=dt), tree)

    params: dict = {
        "embed": cast(L._randn(gen, (cfg.vocab, cfg.d_model)) * 0.02),
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
        "groups": [],
    }
    for g in layer_groups(cfg):
        lead = (g["count"],)
        if g["kind"] == "plain":
            params["groups"].append(cast(M.init_layer(gen, cfg, g["start"],
                                                      lead)))
        else:
            params["groups"].append(
                {f"b{j}": cast(M.init_layer(gen, cfg, g["start"] + j, lead))
                 for j in range(g["cycle"])})
    if not cfg.tie_embeddings:
        params["lm_head"] = cast(L._randn(gen, (cfg.d_model, cfg.vocab))
                                 * 0.02)
    return params


def _group_layers(tree, g: dict) -> list:
    """Each layer's subtree of one stacked group ``tree`` (parameters or
    caches), in layer order: views of the stacked leaves, so an in-place
    write lands in the stack (each leaf is unbound once, so the backward
    stacks the per-layer gradients once per leaf)."""
    out = []
    per_leaf = [leaf.unbind(0) for leaf in T.leaves(tree)]
    for c in range(g["count"]):
        one = T.unflatten(tree, [u[c] for u in per_leaf])
        if g["kind"] == "plain":
            out.append(one)
        else:
            out += [one[f"b{j}"] for j in range(g["cycle"])]
    return out


def _per_layer(groups: list, cfg: ModelConfig) -> list:
    """Each layer's subtree of stacked ``groups``, in layer order."""
    return [one for g, tree in zip(layer_groups(cfg), groups)
            for one in _group_layers(tree, g)]


def _layers(params, cfg: ModelConfig):
    """Each layer's parameters, in layer order."""
    return _per_layer(params["groups"], cfg)


def _sinusoid_positions(cfg: ModelConfig) -> bool:
    """Whether the embedding gets sinusoidal positions: a model with no
    rotary positions, unless it is recurrent (RG-LRU or RWKV), as in the
    reference."""
    return (cfg.rope_frac == 0.0 and cfg.block != "rwkv"
            and cfg.recurrent is None)


def _embed_positions(params, cfg: ModelConfig, tokens):
    """Embedded tokens (B, S, D), with the sinusoid added where
    :func:`_sinusoid_positions` says, and the positions (S,)."""
    x = M._embed(params, cfg, tokens)
    S = x.shape[1]
    if _sinusoid_positions(cfg):
        x = x + M._sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    return x, torch.arange(S, device=x.device)


def hidden_forward(params, cfg: ModelConfig, tokens, *,
                   use_kernels: bool = False, remat: bool = False):
    """Everything before the unembed: (B, S) tokens -> (B, S, D) normed
    hidden states."""
    x, positions = _embed_positions(params, cfg, tokens)

    def block(p, x, li):
        return M._layer_fwd(p, cfg, x, positions, use_kernels=use_kernels,
                            li=li)

    li = 0
    for g, tree in zip(layer_groups(cfg), params["groups"]):
        # the reference scans each group; the tracer collapses the loop
        with scan_region():
            for p in _group_layers(tree, g):
                if remat and torch.is_grad_enabled():
                    x = checkpoint(block, p, x, li, use_reentrant=False)
                else:
                    x = block(p, x, li)
                li += 1
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
    with scan_region():    # one scan in the reference
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
def _stack_caches(cfg: ModelConfig, per_layer: list) -> list:
    """Per-layer caches into the stacked layout of :func:`layer_groups`:
    each group's layers stacked along a new leading dim, under ``b{j}`` in
    a cycle or tail group."""
    out = []
    for g in layer_groups(cfg):
        if g["kind"] == "plain":
            seg = per_layer[g["start"]:g["start"] + g["count"]]
            out.append(T.map(lambda *a: torch.stack(a), *seg))
            continue
        group = {}
        for j in range(g["cycle"]):
            seg = [per_layer[g["start"] + c * g["cycle"] + j]
                   for c in range(g["count"])]
            group[f"b{j}"] = T.map(lambda *a: torch.stack(a), *seg)
        out.append(group)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Zero decode caches in the reference's stacked layout."""
    dev = resolve_device(device)
    return _stack_caches(cfg, M.init_cache(cfg, batch, cache_len, device=dev))


def decode_step(params, cfg: ModelConfig, caches, token, pos):
    """One serving step.  ``token`` (B,) int; ``pos`` the position each row
    writes: a scalar, as in the reference, or (B,) for one per row.
    Writes the new k/v and recurrent states into ``caches`` in place.
    Returns (logits (B, vocab), caches)."""
    x = M._embed(params, cfg, token[:, None])
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    if _sinusoid_positions(cfg):
        D = cfg.d_model
        dim = torch.arange(0, D, 2, device=x.device).float() / D
        ang = pos.float()[:, None] / torch.pow(10000.0, dim)
        pe = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        pe[:, 0::2] = torch.sin(ang).to(x.dtype)
        pe[:, 1::2] = torch.cos(ang).to(x.dtype)
        x = x + pe[:, None]
    positions = pos[:, None]
    for li, (p, c) in enumerate(zip(_layers(params, cfg),
                                    _per_layer(caches, cfg))):
        x, _ = M._layer_fwd(p, cfg, x, positions, cache=c, pos=pos, li=li)
    x = L.norm_fwd(params["final_norm"], cfg, x)
    return M._unembed(params, cfg, x)[:, 0], caches


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            use_kernels: bool = False):
    """Run a (B, S) prompt; returns the last position's logits (B, vocab)
    and fresh caches: the prompt's k/v in caches of length ``cache_len``,
    and each recurrent block's last state."""
    x, positions = _embed_positions(params, cfg, tokens)
    per_layer = []
    for li, p in enumerate(_layers(params, cfg)):
        x, c = M._layer_fwd(p, cfg, x, positions, return_cache=True,
                            cache_len=cache_len, use_kernels=use_kernels,
                            li=li)
        per_layer.append(c)
    x = L.norm_fwd(params["final_norm"], cfg, x[:, -1:])
    return M._unembed(params, cfg, x)[:, 0], _stack_caches(cfg, per_layer)
