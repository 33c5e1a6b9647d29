"""The plain reference of the benchmark's training step, in float32.

Plain PyTorch, written from the configuration file alone: no import of the
program, of its kernels or of JAX.  It takes the weights as a dict from
leaf path to tensor in the program's stacked layout (a layout it knows,
as a checkpoint format is known) and draws them itself from the seed, and
it draws each step's batch itself; it works out again each rank's rows,
each rank's routing and capacity drops, the mean of the gradients over the
ranks, the clip and AdamW, holding each leaf in the dtype the
configuration stores it in (bf16 weights rounded after each update, f32
moments).  Matmuls run in true f32 (TF32 off, set by the caller on the
card).  ``prec="fp8"`` is the control: every GEMM computed as an fp8 GEMM
computes it (operands in e4m3 in the forward, output gradients in e5m2 in
the backward, per-tensor scales, f32 accumulation), the precision below
the configuration's bf16 that a later change might be tempted to drop to.

Memory: each layer and each block of attention queries or loss positions
is rematerialised in the backward, so the activations held are one
layer's inputs; the state is 4 f32 copies of the weights (weights,
gradients, two moments)."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 1024      # attention query rows per rematerialised block
CE_BLOCK = 512      # loss positions per rematerialised block
FP8_MAX = 448.0     # largest finite float8 e4m3fn
FP8_E5M2_MAX = 57344.0


@dataclasses.dataclass(frozen=True)
class Spec:
    layers: int
    heads: int
    kv_heads: int
    hd: int
    eps: float
    rope_theta: float
    mla: tuple | None          # (kv_lora_rank, nope, rope, v)
    moe: tuple | None          # (E, k, d_expert, n_shared, first_dense)
    capacity_factor: float = 1.25
    aux_coef: float = 0.001
    renorm: bool = True


def spec_of(conf: dict) -> Spec:
    """The model as the configuration file states it, with the values of
    ``deviations`` where the program runs something else (the reference
    follows the program there, so that the comparison is of the same
    function)."""
    dev = conf.get("deviations", {})
    theta = dev.get("rope_scaling", {}).get("port_rope_theta",
                                            conf["rope_theta"])
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    mla = moe = None
    if "kv_lora_rank" in conf:
        if conf.get("q_lora_rank"):
            raise NotImplementedError("low-rank queries")
        mla = (conf["kv_lora_rank"], conf["qk_nope_head_dim"],
               conf["qk_rope_head_dim"], conf["v_head_dim"])
    kw = {}
    if "n_routed_experts" in conf:
        moe = (conf["n_routed_experts"], conf["num_experts_per_tok"],
               conf["moe_intermediate_size"], conf["n_shared_experts"],
               conf["first_k_dense_replace"])
        kw = dict(capacity_factor=dev["capacity_factor"]["port"],
                  aux_coef=dev["seq_aux"]["port_coef"],
                  renorm=bool(dev["norm_topk_prob"]["port"]))
    return Spec(layers=conf["num_hidden_layers"], heads=H,
                kv_heads=conf["num_key_value_heads"], hd=d // H,
                eps=conf["rms_norm_eps"],
                rope_theta=float(theta), mla=mla, moe=moe, **kw)


def groups(spec: Spec) -> list:
    """(first layer, count) of each stacked group of the layout."""
    if spec.moe and spec.moe[4]:
        fd = spec.moe[4]
        return [(0, fd), (fd, spec.layers - fd)]
    return [(0, spec.layers)]


# ------------------------------------------------------------ arithmetic
def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to an 8-bit float under a per-tensor scale."""
    top = FP8_MAX if dtype == torch.float8_e4m3fn else FP8_E5M2_MAX
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Q(torch.autograd.Function):
    """A GEMM operand in e4m3; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _G(torch.autograd.Function):
    """A GEMM's output, whose gradient enters the backward GEMMs in
    e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _q8(x):
    return _Q.apply(x)


def _mm(a, b, prec):
    """``a @ b``; under ``fp8`` as an fp8 GEMM computes it: both
    operands in e4m3 in the forward, the output's gradient in e5m2 in the
    backward, each under its own per-tensor scale, accumulated in f32."""
    if prec == "fp8":
        return _G.apply(_Q.apply(a) @ _Q.apply(b))
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta, rot):
    """Rotate the pairs (2i, 2i+1) of the first ``rot`` dims of (B, S, h,
    .) by position."""
    S = x.shape[1]
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float64)
                           / rot))
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * inv).float()
    ang = ang.to(x.device)[None, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr = x[..., :rot]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([r.reshape(xr.shape), x[..., rot:]], dim=-1)


def _attend(q, k, v, prec):
    """Causal softmax attention, (B, S, H, .) each, in query blocks."""
    B, S, H, dq = q.shape
    scale = 1.0 / math.sqrt(dq)

    def block(qb, i0):
        if prec == "fp8":
            s = _G.apply(torch.einsum("bqhd,bkhd->bhqk", _q8(qb), _q8(k)))
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", qb, k)
        s = s * scale
        qpos = i0 + torch.arange(qb.shape[1], device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if prec == "fp8":
            return _G.apply(torch.einsum("bhqk,bkhd->bqhd", _q8(p), _q8(v)))
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    outs = []
    for i0 in range(0, S, Q_BLOCK):
        qb = q[:, i0:i0 + Q_BLOCK]
        outs.append(checkpoint(block, qb, i0, use_reentrant=False)
                    if torch.is_grad_enabled() else block(qb, i0))
    return torch.cat(outs, dim=1)


def _attention(w, spec, h, prec):
    B, S, _ = h.shape
    H, KV, hd = spec.heads, spec.kv_heads, spec.hd
    q = _mm(h, w["wq"], prec).view(B, S, H, hd)
    k = _mm(h, w["wk"], prec).view(B, S, KV, hd)
    v = _mm(h, w["wv"], prec).view(B, S, KV, hd)
    q, k = _rope(q, spec.rope_theta, hd), _rope(k, spec.rope_theta, hd)
    # query head j reads KV head j // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    o = _attend(q, k, v, prec)
    return _mm(o.reshape(B, S, H * hd), w["wo"], prec)


def _mla(w, spec, h, prec):
    B, S, _ = h.shape
    H = spec.heads
    r, dn, dr, dv = spec.mla
    q = _mm(h, w["wq"], prec).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], spec.rope_theta, dr)], -1)
    c = _rms(_mm(h, w["w_dkv"], prec), w["kv_norm.scale"], 1e-6)
    kr = _rope(_mm(h, w["w_kr"], prec)[:, :, None, :], spec.rope_theta, dr)
    kn = _mm(c, w["w_uk"], prec).view(B, S, H, dn)
    v = _mm(c, w["w_uv"], prec).view(B, S, H, dv)
    k = torch.cat([kn, kr.expand(B, S, H, dr)], dim=-1)
    o = _attend(q, k, v, prec)
    return _mm(o.reshape(B, S, H * dv), w["wo"], prec)


def _ffn(h, wg, wu, wd, prec):
    return _mm(F.silu(_mm(h, wg, prec)) * _mm(h, wu, prec), wd, prec)


def _moe(w, spec, h, prec):
    """Softmax router over all the rank's tokens, top k (renormalised
    where the program renormalises), each expert keeping its first C
    tokens in token order, C = max(ceil(cf k T / E), min(8, k T)); the
    Switch aux loss; then the shared experts."""
    E, k = spec.moe[:2]
    B, S, D = h.shape
    T = B * S
    x = h.reshape(T, D)
    probs = torch.softmax(_mm(x, w["router"], prec), dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    if spec.renorm:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    density = F.one_hot(topi[:, 0], E).float().mean(0)
    aux = spec.aux_coef * E * (density * probs.mean(0)).sum()
    C = max(math.ceil(spec.capacity_factor * k * T / E), min(8, T * k))
    out = torch.zeros_like(x)
    for e in range(E):
        hit = topi == e
        tok = hit.any(-1).nonzero()[:, 0][:C]
        if tok.numel() == 0:
            continue
        gate = (topv * hit).sum(-1)[tok]
        y = _ffn(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e], prec)
        out = out.index_add(0, tok, y * gate[:, None])
    out = out + _ffn(x, w["shared.w_gate"], w["shared.w_up"],
                     w["shared.w_down"], prec)
    return out.reshape(B, S, D), aux


def _layer_weights(W: dict, spec: Spec, li: int) -> dict:
    """Layer ``li``'s weights, views into the stacked leaves, under short
    names."""
    for gi, (l0, n) in enumerate(groups(spec)):
        if l0 <= li < l0 + n:
            pre, j = f"['groups'][{gi}]", li - l0
            break
    out = {}
    for path, t in W.items():
        if path.startswith(pre):
            keys = path[len(pre):].strip("[]'").split("']['")
            out[".".join(keys[1:]) if keys[0] in ("attn", "moe", "mlp")
                else ".".join(keys)] = t[j]
    return out


def _layer(x, w, spec, li, prec):
    h = _rms(x, w["ln1.scale"], spec.eps)
    x = x + (_mla if spec.mla else _attention)(w, spec, h, prec)
    h = _rms(x, w["ln2.scale"], spec.eps)
    if spec.moe and li >= spec.moe[4]:
        y, aux = _moe(w, spec, h, prec)
    else:
        y = _ffn(h, w["w_gate"], w["w_up"], w["w_down"], prec)
        aux = x.new_zeros(())
    return x + y, aux


def rank_loss(W: dict, spec: Spec, tokens: torch.Tensor,
              prec: str = "f32") -> torch.Tensor:
    """One rank's loss on its rows: the mean next-token cross-entropy over
    every position but each row's last, plus the experts' aux losses."""
    B, S = tokens.shape
    x = W["['embed']"][tokens]
    aux = x.new_zeros(())
    for li in range(spec.layers):
        w = _layer_weights(W, spec, li)
        x, a = checkpoint(_layer, x, w, spec, li, prec, use_reentrant=False)
        aux = aux + a
    x = _rms(x, W["['final_norm']['scale']"], spec.eps)
    head = W["['lm_head']"]
    tgt = tokens[:, 1:]

    def ce(xc, tc):
        logits = _mm(xc, head, prec)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, tc[..., None])[..., 0]).sum()

    total = x.new_zeros(())
    for i0 in range(0, S - 1, CE_BLOCK):
        i1 = min(i0 + CE_BLOCK, S - 1)
        total = total + checkpoint(ce, x[:, i0:i1], tgt[:, i0:i1],
                                   use_reentrant=False)
    return total / (B * (S - 1)) + aux


def train(spec: Spec, leaves: list, draw, batch, steps: int, opt: dict,
          *, rank: int = 0, world: int = 1, rows: int, prec: str = "f32",
          all_reduce=None) -> dict:
    """``steps`` steps of the data-parallel step from the drawn weights.

    ``leaves`` is ``[(path, shape, dtype)]`` in leaf order; ``draw(i)``
    draws leaf ``i``'s initial value in its stored dtype; ``batch(step)``
    the global batch, of which this rank trains rows ``[rank * rows,
    (rank + 1) * rows)``; ``all_reduce`` sums a tensor over the ranks in
    place (None for one rank).  Returns the step losses (the mean over the
    ranks), each leaf's norm of the first clipped gradient, and each
    leaf's norm of its change after the steps."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["clip_norm"]
    names = [p for p, _, _ in leaves]
    dtypes = [dt for _, _, dt in leaves]
    P = [draw(i).float() for i in range(len(leaves))]
    M = [torch.zeros_like(p) for p in P]
    V = [torch.zeros_like(p) for p in P]
    losses, g1 = [], None
    for s in range(steps):
        tokens = batch(s)[rank * rows:(rank + 1) * rows]
        for p in P:
            p.requires_grad_(True)
            p.grad = None
        loss = rank_loss(dict(zip(names, P)), spec, tokens, prec)
        loss.backward()
        G = [p.grad for p in P]
        loss = loss.detach()
        for p in P:
            p.requires_grad_(False)
            p.grad = None
        if all_reduce is not None:
            for g in G:
                all_reduce(g)
                g.div_(world)
            all_reduce(loss)
            loss = loss / world
        losses.append(float(loss))
        norm = torch.sqrt(sum(torch.linalg.vector_norm(g).square()
                              for g in G))
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        for g in G:
            g.mul_(scale)
        if s == 0:
            g1 = [float(torch.linalg.vector_norm(g)) for g in G]
        c = s + 1
        with torch.no_grad():
            for p, m, v, g, dt in zip(P, M, V, G, dtypes):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** c)) / (torch.sqrt(v / (1 - b2 ** c)) + eps)
                u = (u + wd * p).mul_(-lr)
                p.copy_((p + u).to(dt).float())
        del G
    change = []
    for i, p in enumerate(P):
        change.append(float(torch.linalg.vector_norm(p - draw(i).float())))
    return {"losses": losses, "grad_norms": g1, "change_norms": change}
