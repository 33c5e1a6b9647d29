"""Model configuration for the decoders the port runs.

The port's own copy of ``repro.models.config.ModelConfig``: the same field
names, defaults, ``block_kind`` and ``reduced()`` smoke-test variant,
restricted to the blocks this package implements: dense attention, the
RG-LRU hybrid of RecurrentGemma (``recurrent``) and RWKV-6 (``block ==
"rwkv"``).  No MLA, MoE, encoder-decoder or VLM sub-configs yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 4096
    conv_width: int = 4
    # Griffin/RecurrentGemma block pattern: (recurrent, recurrent, local_attn)
    pattern: tuple = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | ssm | hybrid
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
    block: str = "attn"           # attn | rwkv (or hybrid via recurrent)
    recurrent: Optional[RecurrentConfig] = None
    dtype: str = "bfloat16"
    source: str = ""              # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer: int) -> str:
        """Block category of a layer: ``attn``, ``rec`` or ``rwkv``."""
        if self.recurrent is not None:
            return {"rec": "rec", "attn": "attn"}[
                self.recurrent.pattern[layer % len(self.recurrent.pattern)]]
        return self.block

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (3 for a recurrent hybrid, one
        pattern cycle), d_model 256, f32, LRU width 256, as the reference's
        ``reduced()``."""
        extra = {}
        if self.recurrent is not None:
            extra["recurrent"] = dataclasses.replace(self.recurrent,
                                                     lru_width=256)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 if self.recurrent is None else 3,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=512,
            vocab=512,
            head_dim=64,
            window=min(self.window, 64) if self.window else None,
            dtype="float32",
            **extra,
        )
