"""The benchmark's own counts of work: a training step's model FLOPs from a
configuration file, and the bytes each gradient-staging kernel must move.

Model FLOPs count what the model needs, not what an implementation runs:
6 x the weights a token passes through in matmuls (forward 2, backward
4), the routed experts at ``num_experts_per_tok`` (no capacity slack),
plus causal attention at 3 x its forward (S(S+1)/2 query-key pairs a
sequence, each 2 x (qk width + v width) FLOP a head).  Remat's second
forward is not counted; the embedding lookup is free."""
from __future__ import annotations


def _layer_matmul_params(conf: dict, li: int) -> int:
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    if "kv_lora_rank" in conf:
        dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
        dv, r = conf["v_head_dim"], conf["kv_lora_rank"]
        ql = conf.get("q_lora_rank")
        q = (d * ql + ql * H * (dn + dr)) if ql else d * H * (dn + dr)
        attn = q + d * (r + dr) + r * H * (dn + dv) + H * dv * d
    else:
        hd = d // H
        kv = conf["num_key_value_heads"]
        attn = d * H * hd + 2 * d * kv * hd + H * hd * d
    if "n_routed_experts" in conf and li >= conf["first_k_dense_replace"]:
        de = conf["moe_intermediate_size"]
        k, ns = conf["num_experts_per_tok"], conf["n_shared_experts"]
        ffn = d * conf["n_routed_experts"] + (k + ns) * 3 * d * de
    else:
        ffn = 3 * d * conf["intermediate_size"]
    return attn + ffn


def matmul_params_per_token(conf: dict) -> int:
    """Weights a token passes through in matmuls: every layer's, the
    router, its experts, and the LM head."""
    return (sum(_layer_matmul_params(conf, li)
                for li in range(conf["num_hidden_layers"]))
            + conf["hidden_size"] * conf["vocab_size"])


def attention_fwd_flops_per_token(conf: dict, seq: int) -> float:
    """Causal attention's forward FLOPs per token, all layers."""
    H = conf["num_attention_heads"]
    if "kv_lora_rank" in conf:
        dqk = conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]
        dv = conf["v_head_dim"]
    else:
        dqk = dv = conf["hidden_size"] // H
    pairs = seq * (seq + 1) / 2
    return conf["num_hidden_layers"] * H * 2 * (dqk + dv) * pairs / seq


def train_flops_per_token(conf: dict, seq: int) -> float:
    """Model FLOPs of one trained token at sequence length ``seq``."""
    return (6.0 * matmul_params_per_token(conf)
            + 3.0 * attention_fwd_flops_per_token(conf, seq))


def _promote(dtypes) -> str:
    ds = set(dtypes)
    return ds.pop() if len(ds) == 1 else "float32"


ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def staging_launches(buckets, comms, chunks, fused, sizes, dtypes,
                     dp: int) -> list:
    """The gradient-staging launches of one step, in order, each as
    ``(kernel, bytes)``: per unfused bucket a bucket pack (its leaves read,
    the f32 buffer written) and, where its leaves are not f32, a
    convert-copy casting the reduced buffer back; per fused bucket a pack
    (leaves read, the chunked, dp-padded f32 staging written) and an
    unpack (the f32 data read, the leaves written); then the clip's
    convert-copy of each synced gradient that is not f32, cast up.  Each
    input byte counts once and each output byte once."""
    out, synced = [], {}
    for bi, b in enumerate(buckets):
        n = sum(sizes[i] for i in b)
        read = sum(sizes[i] * ITEMSIZE[dtypes[i]] for i in b)
        if fused[bi]:
            k = min(max(int(chunks[bi]), 1), max(n, 1))
            cuts = [n * c // k for c in range(k + 1)]
            staged = sum(-(-(cuts[c + 1] - cuts[c]) // dp) * dp
                         for c in range(k))
            out.append(("fused_pack", read + 4 * staged))
            out.append(("fused_unpack", 4 * n + read))
            for i in b:
                synced[i] = dtypes[i]
        else:
            dt = _promote(dtypes[i] for i in b)
            out.append(("bucket_pack", read + 4 * n))
            if dt != "float32":
                out.append(("convert_copy", 4 * n + ITEMSIZE[dt] * n))
            for i in b:
                synced[i] = dt
    for i in range(len(sizes)):
        if synced[i] != "float32":
            out.append(("convert_copy",
                        ITEMSIZE[synced[i]] * sizes[i] + 4 * sizes[i]))
    return out
