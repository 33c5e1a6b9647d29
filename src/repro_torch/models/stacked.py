"""Stacked-parameter decoder (port of ``repro/models/stacked.py``).

Parameters keep the reference's layout: layers are split into homogeneous
groups (:func:`layer_groups`), each stacked along a leading dim in
``params["groups"]``, and leaves are ordered as ``jax.tree.leaves`` orders
them (:func:`leaves`), so a Plan's bucket indices name the same tensors in
both packages.  A dense model is one ``plain`` group of ``n_layers``; for
tinyllama that is 12 leaves: ``embed``, ``final_norm.scale``,
``groups[0].attn.{wk,wo,wq,wv}``, ``groups[0].{ln1,ln2}.scale``,
``groups[0].mlp.{w_down,w_gate,w_up}`` and ``lm_head``.  A DeepSeek-V2
model is a ``plain`` group of its ``first_dense_layers`` (MLA and a dense
MLP) and a ``plain`` group of its MoE layers (MLA and ``moe``: the router,
the (count, E, ...) expert stacks and the ``shared`` experts' MLP); the
aux loss of the experts is summed over the layers into the loss.  RWKV-6
is one ``plain`` group too, its blocks holding ``ln1``, ``ln2`` and
``tmix`` (time mix and channel mix).  A recurrent hybrid is a ``cycle`` group of whole
pattern cycles plus a ``tail`` group of the layers left over, each holding
one subtree ``b{j}`` per position of the cycle (recurrentgemma-9b: 12 x
(rec, rec, attn) and a tail of (rec, rec), 63 leaves).  An
encoder-decoder (seamless-m4t-medium) adds ``encoder``: ``in_proj``, the
encoder's layers stacked into one subtree (``ln1``, ``attn``, ``ln2``,
``mlp``) and its ``final_norm``; its decoder layers also hold ``ln_x`` and
the cross-attention ``xattn``.  A VLM prefix decoder (paligemma-3b) adds
``vision_proj``, the stub projector (an identity), whose output precedes
the text tokens; the loss covers the text tokens only.

Where the reference scans a layer group (or the encoder's layers), the
port loops over the layers;
``remat`` rematerialises each layer (and each cross-entropy chunk) in the
backward through ``torch.utils.checkpoint``, as ``jax.checkpoint`` does in
the reference.

Serving: :func:`init_cache` keeps the reference's stacked cache layout (a
list per layer group, stacked like the parameters: ``{"k", "v"}`` of
(count, B, size, KV, hd) for attention, with ``{"k_scale", "v_scale"}``
beside int8 ``k`` and ``v`` for ``kv_cache_dtype == "int8"``, ``{"c_kv",
"k_rope"}`` for MLA, ``{"h", "conv"}`` for RG-LRU
blocks, under ``b{j}`` in a cycle, ``{"cmix": {"prev"}, "tmix": {"prev",
"wkv"}}`` for RWKV blocks), :func:`prefill` returns the last position's
logits and fresh caches, and :func:`decode_step` advances one token per
row, writing the caches in place; its experts route the batch's rows
together, or each row alone with ``route_rows=True``.
``use_kernels=True`` runs attention through the flash-attention kernel
and the RG-LRU and WKV-6 recurrences through their kernels, as the reference's ``use_kernels`` runs its Pallas
kernels; the train step never sets it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..device import resolve_device
from ..spans import span
from . import layers as L
from . import model as M
from . import vocab_parallel as VP
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
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return [{"kind": "plain", "count": fd, "start": 0, "cycle": 1},
                {"kind": "plain", "count": cfg.n_layers - fd, "start": fd,
                 "cycle": 1}]
    return [{"kind": "plain", "count": cfg.n_layers, "start": 0, "cycle": 1}]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                draw_on_device: bool = False, by_layer: bool = False) -> dict:
    """Random parameters in the reference's shapes and dtypes: layer
    weights and norms in ``cfg.dtype``, the final norms in f32 (the
    reference leaves them uncast), the stub ``vision_proj`` an identity in
    ``cfg.dtype``.  Each leaf is drawn in f32 from a
    ``torch.Generator(seed)``, cast, and moved to ``device``.  The generator
    is on the CPU, so a seed gives the same weights on every device;
    ``draw_on_device`` draws on ``device`` instead (other numbers, no host
    round trip).  Expert stacks are cast as each is drawn, so a full-width
    MoE model holds one f32 stack at a time.

    ``by_layer`` draws a layer at a time (other numbers at the same
    scales): each layer's leaves are drawn in f32, cast and copied into
    their slot of the stacked leaves, so no f32 copy of a stack exists.
    Drawn whole, a stack is f32 first: full-width deepseek-coder-33b's
    (62, 7168, 19200) FFN stacks take 34 GB each that way, and its 66.7
    GB of bf16 weights fit on an 80 GB card only beside one layer's 2.1 GB
    of f32."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev if draw_on_device else "cpu")
    gen.manual_seed(seed)

    def cast(tree):
        return T.map(lambda a: a.to(device=dev, dtype=dt), tree)

    def init_layer(li, lead):
        return cast(M.init_layer(gen, cfg, li, lead, cast=cast))

    params: dict = {
        "embed": cast(L._randn(gen, (cfg.vocab, cfg.d_model)) * 0.02),
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
        "groups": [],
    }
    if by_layer:
        put, stacked = _stacker(cfg)
        for li in range(cfg.n_layers):
            put(li, init_layer(li, ()))
        params["groups"] = stacked()
    else:
        for g in layer_groups(cfg):
            lead = (g["count"],)
            if g["kind"] == "plain":
                params["groups"].append(init_layer(g["start"], lead))
            else:
                params["groups"].append(
                    {f"b{j}": init_layer(g["start"] + j, lead)
                     for j in range(g["cycle"])})
    if not cfg.tie_embeddings:
        params["lm_head"] = cast(L._randn(gen, (cfg.d_model, cfg.vocab))
                                 * 0.02)
    if cfg.encdec is not None:
        params["encoder"] = M.init_encoder(gen, cfg, cast, dev)
    if cfg.vlm_prefix_len:
        params["vision_proj"] = torch.eye(cfg.d_model, dtype=dt, device=dev)
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


def _enc_layers(params, cfg: ModelConfig):
    """Each encoder layer's parameters, in layer order."""
    return _group_layers(params["encoder"]["layers"],
                         {"kind": "plain", "count": cfg.encdec.n_enc_layers})


_embed_positions = M._embed_positions


def encode(params, cfg: ModelConfig, frames, tp=None):
    """The encoder's output (B, T, D) over (B, T, F) frame embeddings; its
    layer loop is one ``lax.scan`` in the reference, marked for the
    tracer."""
    return M._encode(params["encoder"], cfg, frames, tp,
                     layers=lambda _: _enc_layers(params, cfg),
                     region=scan_region)


def hidden_forward(params, cfg: ModelConfig, tokens, *, prefix_emb=None,
                   enc_frames=None, use_kernels: bool = False,
                   remat: bool = False, tp=None):
    """Everything before the unembed: (B, S) tokens -> (B, S, D) normed
    hidden states of the text tokens, and the layers' summed MoE aux loss
    (0 without MoE).  ``prefix_emb`` (B, P, D) runs before the tokens and
    is sliced off after the final norm; ``enc_frames`` (B, T, F) gives the
    encoder's output, which every decoder layer cross-attends.  With a
    tensor-parallel context ``tp``, ``params`` holds this rank's slices
    (:mod:`repro_torch.distributed.tensor_parallel`) and the hidden states
    come out whole on every rank of its group; under ZeRO-3 the leaves
    outside the layers are gathered over the data ranks here, and each
    layer's inside the block that ``remat`` checkpoints, so the recompute
    gathers them again and at most one layer's whole weights are live
    beyond the shards."""
    with span("model.io"):
        if tp is not None:
            params = tp.unshard(params)
        x, positions = _embed_positions(params, cfg, tokens, tp, prefix_emb)
        offset = x.shape[1] - tokens.shape[1]
        memory = (encode(params, cfg, enc_frames, tp)
                  if enc_frames is not None else None)
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(p, x, li):
        if tp is not None:
            p = tp.layer(li).unshard(p)
        x, aux, _ = M._layer_fwd(p, cfg, x, positions,
                                 use_kernels=use_kernels, li=li,
                                 with_aux=True, tp=tp, memory=memory)
        return x, aux

    li = 0
    for g, tree in zip(layer_groups(cfg), params["groups"]):
        # the reference scans each group; the tracer collapses the loop
        with scan_region():
            with span("model.io"):
                layers = _group_layers(tree, g)
            for p in layers:
                if remat and torch.is_grad_enabled():
                    x, aux = checkpoint(block, p, x, li, use_reentrant=False)
                else:
                    x, aux = block(p, x, li)
                with span("model.ffn"):   # the experts' load-balance loss
                    total_aux = total_aux + aux
                li += 1
    with span("model.io"):
        x = L.norm_fwd(params["final_norm"], cfg, x)
        return (x[:, offset:] if offset else x), total_aux


def forward(params, cfg: ModelConfig, tokens, *, prefix_emb=None,
            enc_frames=None, use_kernels: bool = False, remat: bool = False,
            tp=None):
    """Full-sequence logits (B, S, vocab) of the text tokens; under a
    tensor-parallel context ``tp``, whole on every rank of its group."""
    x, _ = hidden_forward(params, cfg, tokens, prefix_emb=prefix_emb,
                          enc_frames=enc_frames, use_kernels=use_kernels,
                          remat=remat, tp=tp)
    return M._unembed(params, cfg, x, tp)


_CE_CHUNK = 512


def _ce_chunk(params, cfg: ModelConfig, xc, tc, wc):
    """Summed f32 cross-entropy and weight of one sequence chunk."""
    logits = M._unembed(params, cfg, xc).float()
    m = logits.amax(-1)
    logz = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return ((logz - gold) * wc).sum(), wc.sum()


def _ce_chunk_vp(head, cfg: ModelConfig, tp, xc, tc, wc):
    """:func:`_ce_chunk` vocab-parallel over ``tp``'s group, on f32 input
    as the reference passes it (its head GEMM runs in f32)."""
    return VP.ce_chunk(xc.float(), head, tc, wc, tp,
                       transpose_head=cfg.tie_embeddings)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = False,
            tp=None):
    """Next-token CE computed in sequence chunks with an f32 logsumexp —
    the full (B, S, V) logits tensor is never materialised — plus the MoE
    aux loss, added after the chunks as in the reference.  With a
    tensor-parallel context ``tp`` whose rules shard the vocab, the chunks
    run vocab-parallel over its group, as the reference's do whenever its
    mesh has a ``model`` dim, even of size 1.  ``batch`` may carry the
    stub frontends' ``prefix_emb`` and ``enc_frames``; the loss covers the
    text tokens only."""
    tokens = batch["tokens"]
    x, aux = hidden_forward(params, cfg, tokens,
                            prefix_emb=batch.get("prefix_emb"),
                            enc_frames=batch.get("enc_frames"), remat=remat,
                            tp=tp)
    with span("model.io"):
        B, S, D = x.shape
        dev = x.device
        targets = torch.cat(
            [tokens[:, 1:],
             torch.zeros((B, 1), dtype=tokens.dtype, device=dev)], dim=1)
        weights = torch.cat(
            [torch.ones((B, S - 1), dtype=torch.float32, device=dev),
             torch.zeros((B, 1), dtype=torch.float32, device=dev)], dim=1)
        chunk = min(_CE_CHUNK, S)
        while S % chunk:
            chunk -= 1
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = torch.zeros((), dtype=torch.float32, device=dev)
        if M._head_dim(cfg, tp) is not None:
            fn = _ce_chunk_vp
            head = (params["embed"] if cfg.tie_embeddings
                    else params["lm_head"])
            lead = (head, cfg, tp)
        else:
            fn, lead = _ce_chunk, (params, cfg)
        with scan_region():    # one scan in the reference
            for c in range(S // chunk):
                sl = slice(c * chunk, (c + 1) * chunk)
                args = (*lead, x[:, sl], targets[:, sl], weights[:, sl])
                if remat and torch.is_grad_enabled():
                    ce, n = checkpoint(fn, *args, use_reentrant=False)
                else:
                    ce, n = fn(*args)
                ce_sum = ce_sum + ce
                cnt = cnt + n
        return ce_sum / torch.clamp(cnt, min=1.0) + aux


# ------------------------------------------------------------------- decode
def _stacker(cfg: ModelConfig):
    """``(put, stacked)``: ``put(li, tree)`` copies layer ``li``'s tree
    (its parameters or its cache) into its slot of the stacked layout of
    :func:`layer_groups` (each group's layers stacked along a new leading
    dim, under ``b{j}`` in a cycle or tail group; a stack is allocated
    from the first layer put into it), and ``stacked()`` returns that
    layout once every layer has been put.  Stacking each layer as it comes
    holds one layer's tree beside the stacks, where ``torch.stack`` over
    the finished layers holds all of them: a second copy of the whole
    cache, or of the weights."""
    groups = layer_groups(cfg)
    out: list = [{} for _ in groups]
    place = {g["start"] + c * g["cycle"] + j: (gi, c, f"b{j}")
             for gi, g in enumerate(groups) for c in range(g["count"])
             for j in range(g["cycle"])}

    def put(li: int, tree) -> None:
        gi, c, key = place[li]
        if key not in out[gi]:
            count = groups[gi]["count"]
            out[gi][key] = T.map(lambda a: a.new_empty((count, *a.shape)),
                                 tree)
        for s, a in zip(T.leaves(out[gi][key]), T.leaves(tree)):
            s[c].copy_(a)

    def stacked() -> list:
        return [o["b0"] if g["kind"] == "plain" else o
                for g, o in zip(groups, out)]

    return put, stacked


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> list:
    """Zero decode caches in the reference's stacked layout."""
    dev = resolve_device(device)
    put, stacked = _stacker(cfg)
    for li in range(cfg.n_layers):
        put(li, M.init_layer_cache(cfg, li, batch, cache_len, dev))
    return stacked()


def decode_step(params, cfg: ModelConfig, caches, token, pos, *,
                memory=None, route_rows: bool = False, tp=None):
    """One serving step.  ``token`` (B,) int; ``pos`` the position each row
    writes: a scalar, as in the reference, or (B,) for one per row.
    Writes the new k/v, latents and recurrent states into ``caches`` in
    place.  Returns (logits (B, vocab), caches).  ``memory``, the
    encoder's output (:func:`encode`), adds cross-attention over it.  The
    experts route the B rows together, as the reference's ``decode_step``
    does (its capacity from T = B may drop tokens); ``route_rows`` routes
    each row as a batch of one, as the reference engine's vmap over
    batch-1 steps does.

    With a tensor-parallel context ``tp``, ``params`` holds this rank's
    slices and ``caches`` its shards (``distributed.tensor_parallel.
    shard_caches``), the rows are this data rank's, and the logits come
    out whole on every rank of the model group; under ZeRO-3 the leaves
    outside the layers are gathered over the data ranks here and each
    layer's where it runs, as :func:`hidden_forward` does."""
    if tp is not None:
        params = tp.unshard(params)
    logits, _ = M.decode_step(M.from_stacked(params, cfg), cfg,
                              _per_layer(caches, cfg), token, pos,
                              memory=memory, route_rows=route_rows, tp=tp)
    return logits, caches


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            prefix_emb=None, enc_frames=None, use_kernels: bool = False,
            tp=None):
    """Run a (B, S) prompt (after its ``prefix_emb`` where the config has
    a prefix; cross-attending the encoder's output of ``enc_frames`` where
    given); returns the last position's logits (B, vocab) and fresh
    caches: the prompt's k/v in caches of length ``cache_len``, and each
    recurrent block's last state.  ``tp`` as in :func:`decode_step`: the
    caches come out as this rank's shards."""
    if tp is not None:
        params = tp.unshard(params)
    put, stacked = _stacker(cfg)
    logits, _ = M.prefill(M.from_stacked(params, cfg), cfg, tokens,
                          cache_len, prefix_emb=prefix_emb,
                          enc_frames=enc_frames, use_kernels=use_kernels,
                          tp=tp, sink=put)
    return logits, stacked()
