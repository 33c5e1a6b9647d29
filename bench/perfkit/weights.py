"""Weights drawn from the seed, on the device, one call a leaf.

The leaves take the shapes and dtypes of a template tree (the program's
layout, on meta tensors); each is drawn in f32 from its own generator,
seeded from the run's seed and the leaf's index, scaled and cast.  So any
leaf can be drawn again alone, and the program and the reference get the
same numbers: the reference draws them itself from the same seed.

Scales: a norm's ``scale`` is ones; the embedding, the LM head and the
router are N(0, 0.02^2); every other matrix (..., d_in, d_out) is
N(0, 1/d_in)."""
from __future__ import annotations

import math
import re

import torch

_KEY = re.compile(r"\['([^']+)'\]")


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2**63 - 1)


def batch_seed(seed: int, step: int) -> int:
    return (int(seed) * 999_983 + 104_729 * (step + 1) + 17) % (2**63 - 1)


def leaf_scale(path: str, shape) -> float | None:
    """None for a norm's scale (ones), else the draw's standard deviation."""
    name = _KEY.findall(path)[-1]
    if name == "scale":
        return None
    if name in ("embed", "lm_head", "router"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def draw_leaf(path: str, shape, dtype, seed: int, index: int,
              device) -> torch.Tensor:
    scale = leaf_scale(path, shape)
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def draw_all(spec: list, seed: int, device) -> list:
    """Every leaf of ``spec`` (a list of ``(path, shape, dtype)`` in leaf
    order)."""
    return [draw_leaf(p, s, dt, seed, i, device)
            for i, (p, s, dt) in enumerate(spec)]
