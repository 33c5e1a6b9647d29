"""Model configuration for the decoders the port runs.

The port's own copy of ``repro.models.config.ModelConfig``: the same field
names, defaults, ``block_kind``, ``is_moe_layer``, parameter counts and
``reduced()`` smoke-test variant, restricted to the blocks this package
implements: dense attention (with an optional int8 KV cache), DeepSeek-V2's
Multi-head Latent Attention (``block == "mla"``) and routed experts
(``moe``), the RG-LRU hybrid of RecurrentGemma (``recurrent``) and RWKV-6
(``block == "rwkv"``), the encoder-decoder of SeamlessM4T (``encdec``: an
encoder over stub frame embeddings, cross-attention in every decoder
layer) and the VLM prefix of PaliGemma (``vlm_prefix_len`` stub patch
embeddings before the text tokens).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # None: full-rank queries (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_expert: int = 1408          # per-expert FFN hidden size
    first_dense_layers: int = 1   # DeepSeek-V2: layer 0 is dense
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 12
    enc_seq: int = 1024           # frame-embedding sequence length (stub)
    frontend_dim: int = 1024      # dim of precomputed frame embeddings


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 4096
    conv_width: int = 4
    # Griffin/RecurrentGemma block pattern: (recurrent, recurrent, local_attn)
    pattern: tuple = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    norm: str = "rms"             # rms | layer
    act: str = "silu"             # silu | gelu | relu
    glu: bool = True              # gated FFN (SwiGLU/GeGLU)
    qkv_bias: bool = False
    rope_frac: float = 1.0        # fraction of head_dim rotated (StableLM: 0.25)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    window: Optional[int] = None  # sliding-window size for "attn" blocks
    block: str = "attn"           # attn | mla | rwkv (or hybrid via recurrent)
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    encdec: Optional[EncDecConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    vlm_prefix_len: int = 0       # image-token prefix length (stub embeddings)
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""      # "" = activations dtype; "int8" = quantized
    source: str = ""              # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer: int) -> str:
        """Block category of a layer: ``attn``, ``rec`` or ``rwkv`` (MLA is
        an ``attn`` block variant, selected by ``cfg.block``)."""
        if self.recurrent is not None:
            return {"rec": "rec", "attn": "attn"}[
                self.recurrent.pattern[layer % len(self.recurrent.pattern)]]
        return "attn" if self.block == "mla" else self.block

    def is_moe_layer(self, layer: int) -> bool:
        return self.moe is not None and layer >= self.moe.first_dense_layers

    # ------------------------------------------------------------ accounting
    def param_count(self) -> float:
        """Approximate parameter count (for roofline 6·N·D), as the
        reference counts it."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                if self.block == "mla" and self.mla:
                    m = self.mla
                    qdim = self.n_heads * (m.qk_nope_head_dim
                                           + m.qk_rope_head_dim)
                    total += d * (m.q_lora_rank or 0) or 0
                    total += (m.q_lora_rank or d) * qdim
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                    total += self.n_heads * self.hd * d
            elif kind == "rec":
                L = self.recurrent.lru_width
                total += (2 * d * L + L * d + self.recurrent.conv_width * L
                          + 3 * L)
            elif kind == "rwkv":
                total += 6 * d * d + d * 64 * 2  # r,k,v,g,o + decay lora
            if self.is_moe_layer(i):
                e = self.moe
                nff = 3 if self.glu else 2
                total += e.n_routed * nff * d * e.d_expert
                total += e.n_shared * nff * d * e.d_expert
                total += d * e.n_routed
            elif kind != "rwkv":
                total += (3 if self.glu else 2) * d * self.d_ff
            else:
                total += 2 * d * self.d_ff + d * d  # rwkv channel-mix
        if self.encdec is not None:
            for _ in range(self.encdec.n_enc_layers):
                total += 4 * d * self.hd * self.n_heads
                total += (3 if self.glu else 2) * d * self.d_ff
            # decoder cross-attention
            total += self.n_layers * 4 * d * self.hd * self.n_heads
        return float(total)

    def active_param_count(self) -> float:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        nff = 3 if self.glu else 2
        n_moe_layers = self.n_layers - e.first_dense_layers
        inactive = (e.n_routed - e.top_k) * nff * self.d_model * e.d_expert
        return self.param_count() - n_moe_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant, as the reference's ``reduced()``: 2 layers
        (3 for a recurrent hybrid, one pattern cycle), d_model 256, f32,
        LRU width 256, a small MLA, 4 experts with a capacity that drops
        no token at toy scale, a 2-layer encoder over 32 frames of 256 and
        a prefix of 8 patches."""
        kw: dict = dict(
            n_layers=2 if self.recurrent is None else 3,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=512,
            vocab=512,
            head_dim=64,
            window=min(self.window, 64) if self.window else None,
            dtype="float32",
        )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=64,
                q_lora_rank=64 if self.mla.q_lora_rank else None,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed=4, n_shared=1, top_k=2, d_expert=128,
                capacity_factor=8.0)  # generous: no token drops at toy scale
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_enc_layers=2, enc_seq=32,
                                        frontend_dim=256)
        if self.recurrent is not None:
            kw["recurrent"] = dataclasses.replace(self.recurrent,
                                                  lru_width=256)
        if self.vlm_prefix_len:
            kw["vlm_prefix_len"] = 8
        return dataclasses.replace(self, name=self.name + "-reduced", **kw)
