"""The one generator of training traffic, read from a mix file.

A step's global batch is ``rows`` sequences of ``seq_len`` token ids,
uniform over the vocabulary, drawn on the device from a generator seeded
by the run's seed and the step's index: every step's rows differ, every
rank draws the same global batch and trains its own rows, and the
reference draws any step's batch again alone."""
from __future__ import annotations

import torch

from .weights import batch_seed

KINDS = ("uniform",)


def batch_tokens(mix: dict, vocab: int, rows: int, seed: int, step: int,
                 device) -> torch.Tensor:
    if mix["tokens"] not in KINDS:
        raise ValueError(f"token distribution {mix['tokens']!r}: the "
                         f"generator draws {KINDS}")
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, step))
    return torch.randint(0, vocab, (rows, mix["seq_len"]), generator=gen,
                         device=device)
