"""Architecture registry of the port: ``get_config("<arch-id>")``.

Every config of the reference registry -- dense, MLA + MoE (DeepSeek-V2),
RG-LRU hybrid, RWKV-6, the VLM prefix decoder (PaliGemma) and the
encoder-decoder (SeamlessM4T) -- copied with its published widths and
source; reduced smoke-test variants come from ``cfg.reduced()``.
"""
from __future__ import annotations

from ..models.config import (EncDecConfig, MLAConfig, ModelConfig,
                             MoEConfig, RecurrentConfig)

_CONFIGS = {
    # arXiv:2401.02385 — Llama-2 architecture, small
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", arch_type="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
        source="arXiv:2401.02385"),
    # arXiv:2407.10671 — QKV bias, tied embeddings, rope theta 1e6
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b", arch_type="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936, qkv_bias=True,
        tie_embeddings=True, rope_theta=1000000.0,
        source="arXiv:2407.10671"),
    # LayerNorm, partial rotary (25% of the head dim), full MHA
    "stablelm-1.6b": ModelConfig(
        name="stablelm-1.6b", arch_type="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352, norm="layer",
        act="silu", glu=True, rope_frac=0.25,
        source="hf:stabilityai/stablelm-2-1_6b"),
    # the paper's benchmark model: sinusoidal positions, ReLU FFN
    "transformer-paper": ModelConfig(
        name="transformer-paper", arch_type="dense", n_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=32768,
        norm="layer", act="relu", glu=False, rope_frac=0.0,
        source="arXiv:1706.03762 (Transformer-base; DisCo benchmark model)"),
    # Griffin hybrid: (rec, rec, local-attn) cycles, RG-LRU width 4096,
    # local attention window 2048 with 16 heads over 1 KV head, GeGLU
    "recurrentgemma-9b": ModelConfig(
        name="recurrentgemma-9b", arch_type="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        vocab=256000, act="gelu", glu=True, window=2048,
        tie_embeddings=True,
        recurrent=RecurrentConfig(lru_width=4096, conv_width=4,
                                  pattern=("rec", "rec", "attn")),
        source="arXiv:2402.19427 (Griffin / RecurrentGemma-9B)"),
    # RWKV-6 "Finch": attention-free, data-dependent decay WKV with 40 heads
    # at hd 64, ReLU^2 channel mix
    "rwkv6-3b": ModelConfig(
        name="rwkv6-3b", arch_type="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab=65536,
        block="rwkv", norm="layer", glu=False, act="relu", rope_frac=0.0,
        source="arXiv:2404.05892 (RWKV-6 Finch)"),
    # DeepSeek-V2-Lite (16B total / 2.4B active): MLA (kv_lora 512, no
    # q-lora), 64 routed experts top-6 + 2 shared, d_expert 1408; layer 0
    # dense
    "deepseek-v2-lite-16b": ModelConfig(
        name="deepseek-v2-lite-16b", arch_type="moe", n_layers=27,
        d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,          # dense layer-0 FFN width
        vocab=102400, block="mla",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                      first_dense_layers=1),
        source="arXiv:2405.04434 (DeepSeek-V2-Lite)"),
    # DeepSeek-V2 236B (21B active): MLA (kv_lora 512, q_lora 1536), 160
    # routed experts top-6 + 2 shared, d_expert 1536; layer 0 dense
    "deepseek-v2-236b": ModelConfig(
        name="deepseek-v2-236b", arch_type="moe", n_layers=60,
        d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,          # dense layer-0 FFN width
        vocab=102400, block="mla",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536,
                      first_dense_layers=1),
        source="arXiv:2405.04434 (DeepSeek-V2)"),
    # DeepSeek-Coder-33B: Llama architecture, GQA over 8 KV heads
    "deepseek-coder-33b": ModelConfig(
        name="deepseek-coder-33b", arch_type="dense", n_layers=62,
        d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256,
        source="arXiv:2401.14196"),
    # Gemma-2B decoder behind a stub SigLIP tower: 256 patch embeddings
    # (d_model wide) before the text tokens; MQA at hd 256, GeGLU, tied
    # embeddings
    "paligemma-3b": ModelConfig(
        name="paligemma-3b", arch_type="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
        norm="rms", act="gelu", glu=True, tie_embeddings=True,
        vlm_prefix_len=256, source="arXiv:2407.07726 (SigLIP + Gemma-2B)"),
    # encoder-decoder text/unit backbone: 12 + 12 layers, LayerNorm, ReLU
    # FFN, sinusoidal positions; the speech frontend is a stub giving 1024
    # frame embeddings of 1024; vocab 256206 padded to 256208
    "seamless-m4t-medium": ModelConfig(
        name="seamless-m4t-medium", arch_type="audio", n_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256208,
        norm="layer", act="relu", glu=False, rope_frac=0.0,
        encdec=EncDecConfig(n_enc_layers=12, enc_seq=1024,
                            frontend_dim=1024),
        source="arXiv:2308.11596 (SeamlessM4T-Medium)"),
}

ARCHS = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    """The config of ``name``: an arch of the registry, or the name of one's
    reduced variant (``"tinyllama-1.1b-reduced"``, as ``reduced()`` names
    it), so that a CLI taking arch names takes reduced models too."""
    if name not in _CONFIGS and name.endswith("-reduced"):
        return get_config(name[:-len("-reduced")]).reduced()
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]
