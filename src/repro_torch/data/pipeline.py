"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``).

The token streams and the stub frontends' embeddings are numpy code
copied from the reference, so the same ``(seed, step)`` gives the same
arrays in both packages; only ``materialize_batch`` differs, returning
torch tensors on a chosen device, and ``make_batch_specs`` gives meta
tensors where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov structure: each token prefers a small set of successors
    branching: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 4096)  # transition table over a vocab slice
        self._succ = rng.integers(0, v, size=(v, self.branching))
        self._v = v

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        toks = np.empty((n, self.seq_len), np.int32)
        cur = rng.integers(0, self._v, size=n)
        for t in range(self.seq_len):
            toks[:, t] = cur
            pick = rng.integers(0, self.branching, size=n)
            jump = rng.random(n) < 0.05
            cur = np.where(jump, rng.integers(0, self._v, size=n),
                           self._succ[cur, pick])
        return toks

    def global_step_batch(self, step: int) -> np.ndarray:
        """Full global batch for a step."""
        rng = np.random.default_rng((self.seed, step))
        return self._gen(rng, self.global_batch)

    def shard_step_batch(self, step: int, shard: int,
                         n_shards: int) -> np.ndarray:
        """Shard ``shard``/``n_shards`` of the global batch, generated
        independently (deterministic function of (seed, step, shard))."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        per = self.global_batch // n_shards
        rng = np.random.default_rng((self.seed, step, shard))
        return self._gen(rng, per)


def tokens_to_tensor(tokens: np.ndarray, cfg: ModelConfig,
                     device) -> torch.Tensor:
    """Token ids (int64, folded into the vocab) on ``device``."""
    return torch.from_numpy(
        (tokens % cfg.vocab).astype(np.int64)).to(device)


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Meta tensors standing in for one training batch of this arch: the
    tokens (int64, as every batch of the port carries them) and, where the
    arch has them, the stub frontends' embeddings in the reference's
    dtype, bf16: ``prefix_emb`` (batch, vlm_prefix_len, d_model) and
    ``enc_frames`` (batch, enc_seq, frontend_dim)."""
    specs = {"tokens": torch.empty((batch, seq), dtype=torch.int64,
                                   device="meta")}
    if cfg.vlm_prefix_len:
        specs["prefix_emb"] = torch.empty(
            (batch, cfg.vlm_prefix_len, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    if cfg.encdec is not None:
        specs["enc_frames"] = torch.empty(
            (batch, cfg.encdec.enc_seq, cfg.encdec.frontend_dim),
            dtype=torch.bfloat16, device="meta")
    return specs


def materialize_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                      device="cuda") -> dict:
    """The step-0 batch of ``SyntheticLMDataset(seed=seed)`` as torch
    tensors: ``{"tokens": (batch, seq) int64}``, and the stub frontends'
    f32 embeddings where the arch has them, drawn from
    ``default_rng(seed + 1)`` in the reference's order (bitwise its
    arrays): ``prefix_emb`` (batch, vlm_prefix_len, d_model), then
    ``enc_frames`` (batch, enc_seq, frontend_dim)."""
    dev = resolve_device(device)
    ds = SyntheticLMDataset(cfg.vocab, seq, batch, seed=seed)
    out = {"tokens": tokens_to_tensor(ds.global_step_batch(0), cfg, dev)}
    rng = np.random.default_rng(seed + 1)

    def normal(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    if cfg.vlm_prefix_len:
        out["prefix_emb"] = normal((batch, cfg.vlm_prefix_len, cfg.d_model))
    if cfg.encdec is not None:
        out["enc_frames"] = normal((batch, cfg.encdec.enc_seq,
                                    cfg.encdec.frontend_dim))
    return out
