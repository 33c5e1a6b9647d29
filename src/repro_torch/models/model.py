"""The per-layer model, and the pieces the stacked model shares with it
(port of ``repro/models/model.py``), for dense attention blocks (with a
bf16/f32 or int8 KV cache), MLA blocks with routed experts (DeepSeek-V2),
the RG-LRU blocks of the recurrent hybrid, RWKV-6 blocks, the
encoder-decoder (SeamlessM4T: an encoder over stub frame embeddings and
cross-attention in every decoder layer) and the VLM prefix decoder
(PaliGemma: stub patch embeddings through ``vision_proj`` before the text
tokens, whose logits are sliced off).

Entry points, as in the reference:
    init_params(cfg, seed=, device=)           {"embed", "encoder"?,
                                               "final_norm", "layers": [...],
                                               "lm_head"?, "vision_proj"?}
    forward(params, cfg, tokens, prefix_emb=, enc_frames=) (logits, aux)
    loss_fn(params, cfg, batch)                mean next-token CE + MoE aux
    encode(params, cfg, frames)                the encoder's output (memory)
    init_cache(cfg, batch, cache_len)          per-layer decode state
    prefill(params, cfg, tokens, cache_len, prefix_emb=, enc_frames=, tp=)
                                               (last logits, caches)
    decode_step(params, cfg, caches, token, pos, memory=, tp=)
                                               (logits, caches)

The per-layer tree's leaves come in the reference's ``jax.tree.leaves``
order (sorted keys: ``embed``, ``encoder``, ``final_norm``, each layer's,
``lm_head``, ``vision_proj``), so a Plan's bucket indices name the same
tensors in both packages.  The per-layer model has no loop for the tracer
to collapse: its trace shows every layer's ops.  As in the reference,
``prefill`` does not return the encoder's output and no cache holds cross
k and v: a decode step attends over the ``memory`` its caller passes.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..spans import span
from . import layers as L
from . import recurrent as R
from . import vocab_parallel as VP
from .config import ModelConfig


def init_layer(gen: torch.Generator, cfg: ModelConfig, li: int, lead,
               cast) -> dict:
    """Block ``li``'s f32 parameters, drawn from ``gen`` (as
    ``layers._randn`` places them); ``lead`` prepends stacked dims.  An
    ``attn`` block holds ``attn`` (MLA's weights when ``cfg.block ==
    "mla"``), a ``rec`` block ``rec``; both hold the norms and the MLP, or
    ``moe`` in an MoE layer, whose expert stacks are passed through
    ``cast`` as each is drawn."""
    def norm():
        return _norm(cfg, lead)

    p = {"ln1": norm()}
    if cfg.block_kind(li) == "rwkv":
        p["tmix"] = R.init_rwkv_block(gen, cfg, lead)
        p["ln2"] = norm()
        return p
    if cfg.block_kind(li) == "rec":
        p["rec"] = R.init_recurrent_block(gen, cfg, lead)
    elif cfg.block == "mla":
        p["attn"] = L.init_mla(gen, cfg, lead)
    else:
        p["attn"] = L.init_attention(gen, cfg, lead)
    p["ln2"] = norm()
    if cfg.is_moe_layer(li):
        p["moe"] = L.init_moe(gen, cfg, lead, cast=cast)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, lead)
    if cfg.encdec is not None:
        p["ln_x"] = norm()
        p["xattn"] = L.init_attention(gen, cfg, lead)
    return p


def _norm(cfg: ModelConfig, lead) -> dict:
    """A norm's f32 parameters with ``lead`` stacked dims, on the default
    device."""
    return {k: v.expand(*lead, -1).clone()
            for k, v in L.init_norm(cfg, cfg.d_model, "cpu").items()}


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig, lead) -> dict:
    """An encoder layer's f32 parameters: pre-norm self-attention and
    MLP."""
    return {"ln1": _norm(cfg, lead), "attn": L.init_attention(gen, cfg, lead),
            "ln2": _norm(cfg, lead), "mlp": L.init_mlp(gen, cfg, lead)}


def init_encoder(gen: torch.Generator, cfg: ModelConfig, cast,
                 device) -> dict:
    """The encoder's parameters, stacked over its layers: the frames' input
    projection and the layers in ``cfg.dtype`` (through ``cast``), the
    final norm in f32, as in the reference."""
    e = cfg.encdec
    return {"in_proj": cast(L._randn(gen, (e.frontend_dim, cfg.d_model))
                            / math.sqrt(e.frontend_dim)),
            "layers": cast(init_enc_layer(gen, cfg, (e.n_enc_layers,))),
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def _sinusoid(S: int, D: int, dtype, device) -> torch.Tensor:
    pos = np.arange(S)[:, None]
    dim = np.arange(0, D, 2)[None, :]
    ang = pos / np.power(10000.0, dim / D)
    out = np.zeros((S, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def _embed(params, cfg: ModelConfig, tokens, tp=None):
    """The token embedding; with a tensor-parallel context ``tp`` whose
    rules shard the vocab, the vocab-parallel lookup over this rank's
    rows."""
    if tp is not None and tp.dim("embed") is not None:
        x = VP.embed_lookup(params["embed"], tokens, tp)
    else:
        x = params["embed"][tokens]
    if cfg.tie_embeddings:   # gemma-family scaling
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _head_dim(cfg: ModelConfig, tp):
    """The model-sharded dim of the LM head (the embedding when tied)
    under ``tp``, or None."""
    if tp is None:
        return None
    return tp.dim("embed" if cfg.tie_embeddings else "lm_head")


def _unembed(params, cfg: ModelConfig, x, tp=None):
    """Logits; under a ``tp`` that shards the head, this rank's vocab
    columns joined over the group."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if _head_dim(cfg, tp) is not None:
        return tp.gather(tp.copy(x) @ head, -1)
    return x @ head


def _sinusoid_positions(cfg: ModelConfig) -> bool:
    """Whether the embedding gets sinusoidal positions: a model with no
    rotary positions, unless it is recurrent (RG-LRU or RWKV), as in the
    reference."""
    return (cfg.rope_frac == 0.0 and cfg.block != "rwkv"
            and cfg.recurrent is None)


def _embed_positions(params, cfg: ModelConfig, tokens, tp=None,
                     prefix_emb=None):
    """Embedded tokens (B, P + S, D), after the VLM prefix's patch
    embeddings projected by ``vision_proj`` when the config has a prefix
    and ``prefix_emb`` (B, P, D) is given (the prefix takes positions
    0..P-1; P = 0 otherwise), with the sinusoid added where
    :func:`_sinusoid_positions` says; and the positions (P + S,)."""
    x = _embed(params, cfg, tokens, tp)
    if cfg.vlm_prefix_len and prefix_emb is not None:
        pre = prefix_emb.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([pre, x], dim=1)
    S = x.shape[1]
    if _sinusoid_positions(cfg):
        x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    return x, torch.arange(S, device=x.device)


def _decode_embed(params, cfg: ModelConfig, token, pos, tp=None):
    """A decode step's input: the embedded tokens (B, 1, D) with the
    sinusoid at each row's position where :func:`_sinusoid_positions`
    says, the positions (B, 1), and ``pos`` as (B,)."""
    x = _embed(params, cfg, token[:, None], tp)
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
    return x, pos[:, None], pos


def _layer_fwd(p, cfg: ModelConfig, x, positions, *, cache=None, pos=None,
               return_cache: bool = False, cache_len: int = 0,
               use_kernels: bool = False, li: int = 0,
               with_aux: bool = False, route_rows: bool = False, tp=None,
               memory=None):
    """Block ``li`` (pre-norm attention, MLA or RG-LRU block, then, given
    the encoder's output ``memory``, pre-norm cross-attention over it, then
    pre-norm MLP or routed experts; or pre-norm RWKV time mix, then
    pre-norm channel mix).  Returns x, or (x, new_cache) when a cache is
    given or asked for, as ``attention_fwd`` does; with ``with_aux``, (x,
    aux, new_cache) as the reference's ``_layer_fwd`` (aux the experts'
    load-balance loss, 0 elsewhere).  ``use_kernels`` runs attention
    through the flash-attention kernel (never MLA, nor cross-attention, as
    in the reference) and the RG-LRU and WKV-6 recurrences through their
    kernels; ``route_rows`` routes each batch row's tokens through the
    experts as a batch of their own.  ``tp``, a tensor-parallel context,
    runs the block on this rank's slices, with the leaves' specs of layer
    ``li`` (``tp.layer(li)``), and its cache on this rank's shard."""
    want_cache = return_cache or cache is not None
    if tp is not None:
        tp = tp.layer(li)

    def done(x, new_cache, aux=None):
        if with_aux:
            if aux is None:
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return x, aux, new_cache
        return (x, new_cache) if want_cache else x

    if cfg.block_kind(li) == "rwkv":
        with span("model.attn"):
            h = L.norm_fwd(p["ln1"], cfg, x)
            tm_out, tnew = R.rwkv_time_mix(
                p["tmix"], cfg, h, state=cache["tmix"] if cache else None,
                use_kernel=use_kernels, tp=tp, serve=want_cache)
            x = x + tm_out
        with span("model.ffn"):
            h2 = L.norm_fwd(p["ln2"], cfg, x)
            cm_out, cnew = R.rwkv_channel_mix(
                p["tmix"], cfg, h2, state=cache["cmix"] if cache else None,
                tp=tp)
            x = x + cm_out
            return done(x, {"tmix": tnew, "cmix": cnew} if want_cache
                        else None)
    with span("model.attn"):
        h = L.norm_fwd(p["ln1"], cfg, x)
        if cfg.block_kind(li) == "rec":
            r = R.recurrent_block_fwd(p["rec"], cfg, h, state=cache,
                                      return_state=return_cache,
                                      use_kernel=use_kernels, tp=tp)
        elif cfg.block == "mla":
            r = L.mla_fwd(p["attn"], cfg, h, positions, cache=cache,
                          pos=pos, return_cache=return_cache,
                          cache_len=cache_len, tp=tp)
        else:
            r = L.attention_fwd(p["attn"], cfg, h, positions, cache=cache,
                                pos=pos, window=cfg.window,
                                use_flash=use_kernels,
                                return_cache=return_cache,
                                cache_len=cache_len, tp=tp)
        mix_out, new_cache = r if want_cache else (r, None)
        x = x + mix_out
        if memory is not None:
            hx = L.norm_fwd(p["ln_x"], cfg, x)
            x = x + L.cross_attention_fwd(p["xattn"], cfg, hx, memory, tp)
    with span("model.ffn"):
        h2 = L.norm_fwd(p["ln2"], cfg, x)
        aux = None
        if cfg.is_moe_layer(li):
            ff, aux = L.moe_fwd(p["moe"], cfg, h2, route_rows=route_rows,
                                tp=tp)
        else:
            ff = L.mlp_fwd(p["mlp"], cfg, h2, tp)
        return done(x + ff, new_cache, aux)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Per-layer zero decode state, as in the reference: one
    :func:`init_layer_cache` per layer."""
    return [init_layer_cache(cfg, li, batch, cache_len, device)
            for li in range(cfg.n_layers)]


def init_layer_cache(cfg: ModelConfig, li: int, batch: int, cache_len: int,
                     device="cuda") -> dict:
    """Layer ``li``'s zero decode state: an ``attn`` block holds ``{"k",
    "v"}`` of (batch, size, KV, hd) in ``cfg.dtype``, with size
    ``min(cache_len, window)`` for a sliding window; with
    ``kv_cache_dtype == "int8"``, int8 ``k`` and ``v`` and bf16 ``k_scale``
    and ``v_scale`` of (batch, size, KV); an MLA block ``{"c_kv": (batch,
    cache_len, kv_lora_rank), "k_rope": (batch, cache_len,
    qk_rope_head_dim)}`` in ``cfg.dtype``; a ``rec`` block
    holds ``{"h": (batch, L) f32, "conv": (batch, W-1, L) cfg.dtype}``; an
    ``rwkv`` block ``{"tmix": {"wkv": (batch, H, hd, hd) f32, "prev":
    (batch, D)}, "cmix": {"prev": (batch, D)}}``, ``prev`` in cfg.dtype."""
    dt = getattr(torch, cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.block_kind(li) == "rwkv":
        prev = (batch, cfg.d_model)
        return {"tmix": {"wkv": zeros((batch, cfg.n_heads, cfg.hd, cfg.hd),
                                      torch.float32),
                         "prev": zeros(prev)},
                "cmix": {"prev": zeros(prev)}}
    if cfg.block_kind(li) == "rec":
        Lw = cfg.recurrent.lru_width
        return {"h": zeros((batch, Lw), torch.float32),
                "conv": zeros((batch, cfg.recurrent.conv_width - 1, Lw))}
    if cfg.block == "mla":
        m = cfg.mla
        return {"c_kv": zeros((batch, cache_len, m.kv_lora_rank)),
                "k_rope": zeros((batch, cache_len, m.qk_rope_head_dim))}
    size = min(cache_len, cfg.window) if cfg.window else cache_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:-1], torch.bfloat16),
                "v_scale": zeros(shape[:-1], torch.bfloat16)}
    return {"k": zeros(shape), "v": zeros(shape)}


# ------------------------------------------------------------------ encoder
def _enc_layer_fwd(lp, cfg: ModelConfig, x, tp=None):
    """One encoder layer: pre-norm non-causal self-attention, then pre-norm
    MLP.  Under ``tp`` its specs are found under ``encoder``."""
    with span("model.attn"):
        h = L.norm_fwd(lp["ln1"], cfg, x)
        x = x + L.cross_attention_fwd(lp["attn"], cfg, h, h, tp,
                                      scope=("encoder", "attn"))
    with span("model.ffn"):
        h2 = L.norm_fwd(lp["ln2"], cfg, x)
        return x + L.mlp_fwd(lp["mlp"], cfg, h2, tp,
                             scope=("encoder", "mlp"))


def _encode(enc: dict, cfg: ModelConfig, frames, tp=None, layers=list,
            region=contextlib.nullcontext):
    """The encoder over (B, T, F) frame embeddings: the input projection in
    ``cfg.dtype``, the sinusoid, the layers inside ``region`` (each
    layer's parameters, in order, from ``layers(enc["layers"])``, also
    called inside it), the final norm."""
    x = frames.to(getattr(torch, cfg.dtype)) @ enc["in_proj"]
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    with region():
        for lp in layers(enc["layers"]):
            x = _enc_layer_fwd(lp, cfg, x, tp)
    return L.norm_fwd(enc["final_norm"], cfg, x)


def encode(params, cfg: ModelConfig, frames, tp=None):
    """The encoder's output (B, T, D) over precomputed frontend frame
    embeddings (B, T, F): the ``memory`` of cross-attention."""
    return _encode(params["encoder"], cfg, frames, tp)


# ---------------------------------------------------------- per-layer model
def from_stacked(params, cfg: ModelConfig) -> dict:
    """The per-layer tree over a stacked model's parameters; each layer's
    leaves, the encoder's too, are views of the stacked leaves (no
    copy)."""
    from . import stacked as ST

    out = {k: v for k, v in params.items() if k != "groups"}
    out["layers"] = ST._layers(params, cfg)
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              layers=ST._enc_layers(params, cfg))
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random per-layer parameters: the weights that the stacked model's
    ``init_params`` draws for the same seed, each layer's copied out of the
    stack.  Dtypes as in the reference: ``final_norm`` (and the encoder's)
    f32, the rest ``cfg.dtype``."""
    from . import stacked as ST

    out = from_stacked(ST.init_params(cfg, seed=seed, device=device), cfg)
    out["layers"] = [T.map(torch.clone, p) for p in out["layers"]]
    if "encoder" in out:
        out["encoder"]["layers"] = [T.map(torch.clone, p)
                                    for p in out["encoder"]["layers"]]
    return out


def _inputs(params, cfg: ModelConfig, tokens, prefix_emb, enc_frames,
            tp=None):
    """The decoder's input (B, P + S, D), its positions, the prefix length
    P (0 without a prefix) and the encoder's output (None without
    frames)."""
    x, positions = _embed_positions(params, cfg, tokens, tp,
                                    prefix_emb=prefix_emb)
    memory = (encode(params, cfg, enc_frames, tp) if enc_frames is not None
              else None)
    return x, positions, x.shape[1] - tokens.shape[1], memory


def forward(params, cfg: ModelConfig, tokens, *, prefix_emb=None,
            enc_frames=None, use_kernels: bool = False, remat: bool = False):
    """Full-sequence logits (B, S, vocab) of the text tokens and the summed
    auxiliary loss of the MoE layers (0 without MoE).  ``prefix_emb``:
    (B, P, D) VLM patch embeddings (stub frontend), whose positions' logits
    are sliced off; ``enc_frames``: (B, T, F) audio frame embeddings, the
    encoder's input.  ``remat`` recomputes each decoder layer in the
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint``."""
    x, positions, offset, memory = _inputs(params, cfg, tokens, prefix_emb,
                                           enc_frames)
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, p in enumerate(params["layers"]):
        kw = dict(use_kernels=use_kernels, li=li, with_aux=True,
                  memory=memory)
        if remat and torch.is_grad_enabled():
            x, aux, _ = checkpoint(_layer_fwd, p, cfg, x, positions,
                                   use_reentrant=False, **kw)
        else:
            x, aux, _ = _layer_fwd(p, cfg, x, positions, **kw)
        total_aux = total_aux + aux
    x = L.norm_fwd(params["final_norm"], cfg, x)
    logits = _unembed(params, cfg, x)
    return (logits[:, offset:] if offset else logits), total_aux


def loss_fn(params, cfg: ModelConfig, batch, *, use_kernels: bool = False,
            remat: bool = False):
    """Mean next-token cross-entropy over the text tokens' full f32 logits,
    plus the MoE aux loss (the reference's ``model.loss_fn``; the stacked
    model chunks it).  ``batch`` may carry ``prefix_emb`` and
    ``enc_frames``."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens,
                          prefix_emb=batch.get("prefix_emb"),
                          enc_frames=batch.get("enc_frames"),
                          use_kernels=use_kernels, remat=remat)
    logits = logits[:, :-1].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tokens[:, 1:, None])[..., 0]
    return (logz - gold).mean() + aux


def _layer_params(p, li: int, tp):
    """Layer ``li``'s parameters whole over the data ranks under a ZeRO-3
    ``tp`` (gathered here), else as they are."""
    return p if tp is None else tp.layer(li).unshard(p)


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            prefix_emb=None, enc_frames=None, use_kernels: bool = False,
            tp=None, sink=None):
    """Run a (B, S) prompt, after its (B, P, D) ``prefix_emb`` where the
    config has a prefix, and with cross-attention over the encoder's output
    of ``enc_frames`` where given; returns the last position's logits (B,
    vocab) and one fresh cache per layer (``init_cache``'s layout, k/v of
    length ``cache_len``, the prefix's at positions 0..P-1).  Where given,
    ``sink(li, cache)`` takes each layer's cache as the layer finishes, in
    place of the returned list (then empty): the stacked model copies it
    into its stacked caches, so one layer's fresh cache, not every
    layer's, lives beside them.

    With a tensor-parallel context ``tp``, ``params`` holds this rank's
    slices (the leaves outside the layers already whole over the data
    ranks under ZeRO-3: the stacked model's :func:`..stacked.prefill`
    gathers them), the embedding is the vocab-parallel lookup, each layer
    runs on this rank's slices (under ZeRO-3 gathered first, as in
    training), the logits come out whole on every rank of the group and
    each cache is this rank's shard (``tp.cache_dim``)."""
    x, positions, _, memory = _inputs(params, cfg, tokens, prefix_emb,
                                      enc_frames, tp)
    caches = []
    for li, p in enumerate(params["layers"]):
        x, c = _layer_fwd(_layer_params(p, li, tp), cfg, x, positions,
                          return_cache=True, cache_len=cache_len,
                          use_kernels=use_kernels, li=li, memory=memory,
                          tp=tp)
        if sink is None:
            caches.append(c)
        else:
            sink(li, c)
            del c      # kept only as the sink's copy
    x = L.norm_fwd(params["final_norm"], cfg, x[:, -1:])
    return _unembed(params, cfg, x, tp)[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, token, pos, *,
                memory=None, route_rows: bool = False, tp=None):
    """One serving step over per-layer ``caches``.  ``token`` (B,) int;
    ``pos`` the position each row writes, a scalar or (B,).  Writes the
    caches in place (the reference returns updated copies) and returns
    (logits (B, vocab), caches).  ``memory``, the encoder's output (B, T,
    D), adds cross-attention over it, as in the reference, which caches no
    cross k and v.  The experts route the B rows together, as the
    reference's ``decode_step`` at batch B, unless ``route_rows`` routes
    each row as a batch of one, as the reference engine's vmapped batch-1
    step does (the capacity then drops no token).  ``tp`` as in
    :func:`prefill`: ``caches`` hold this rank's shards, an int8 cache's
    (``init_cache`` under ``kv_cache_dtype="int8"``) too, whose entries
    and scales each rank writes as a single device would."""
    x, positions, pos = _decode_embed(params, cfg, token, pos, tp)
    out = []
    for li, (p, c) in enumerate(zip(params["layers"], caches)):
        x, c = _layer_fwd(_layer_params(p, li, tp), cfg, x, positions,
                          cache=c, pos=pos, li=li, route_rows=route_rows,
                          memory=memory, tp=tp)
        out.append(c)
    x = L.norm_fwd(params["final_norm"], cfg, x)
    return _unembed(params, cfg, x, tp)[:, 0], out
