"""Batched serving engine (port of ``repro/serving/engine.py``).

Static slots: a fixed number of decode slots share one cache of static
capacity.  Requests are admitted into free slots through a single-sequence
prefill, each decode step advances every slot by one token, and finished
slots are retired and refilled.

Two differences from the reference, neither of which changes a token:

* Prefill runs attention through the flash-attention kernel
  (``ST.prefill(..., use_kernels=True)``); the reference's engine leaves
  ``use_kernels`` at False.  On CPU tensors the kernel's plain version runs.
* Decode advances all slots in one batched call with one position per
  slot, where the reference vmaps a batch-1 step over the slots; each slot
  computes what the reference's step computes.  The caches are updated in
  place.

The engine runs on the device its parameters lie on and allocates its
caches there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..models import stacked as ST
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (P,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine (None until the lifecycle event happened, so an
    # unfinished request reports None instead of a nonsense 0/negative)
    output: list = dataclasses.field(default_factory=list)
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency(self) -> Optional[float]:
        if self.done_at is None or self.submitted_at is None:
            return None
        return self.done_at - self.submitted_at


def _greedy(logits: torch.Tensor, rng) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServeEngine:
    """max_slots concurrent sequences, cache capacity ``cache_len`` each."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_slots: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 sampler: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 plan=None, decode_batch: Optional[int] = None):
        # a serving plan (duck-typed: slots, cache_len, decode_batch) sets
        # the slot and batch choices; explicit kwargs still win over the
        # plan's fields
        if max_slots is None:
            max_slots = int(plan.slots) if plan is not None else 8
        if cache_len is None:
            cache_len = int(plan.cache_len) if plan is not None else 256
        if decode_batch is None and plan is not None:
            decode_batch = int(plan.decode_batch)
        self.plan = plan
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.clock = clock
        # decode dispatch width: < max_slots decodes the active slots in
        # gathered chunks of this many lanes
        self.decode_batch = (max_slots if decode_batch is None
                             else max(1, min(int(decode_batch), max_slots)))
        # sampler(logits (n, vocab), rng) -> (n,) integer tensor
        self.sampler = sampler or _greedy
        self.device = params["embed"].device
        # slot state
        self.caches = ST.init_cache(cfg, max_slots, cache_len,
                                    device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int32)      # next write pos
        self.slot_last = np.zeros(max_slots, np.int32)     # last sampled tok
        self.slot_budget = np.zeros(max_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self._steps = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # ------------------------------------------------------------- kernels
    @torch.no_grad()
    def _decode(self, caches, tokens, positions):
        """Advance the slots of ``caches`` one token.  tokens, positions:
        (n,) host arrays.  Returns the logits (n, vocab)."""
        logits, _ = ST.decode_step(self.params, self.cfg, caches,
                                   self._tensor(tokens),
                                   self._tensor(positions))
        return logits

    @torch.no_grad()
    def _decode_chunk(self, tokens, positions, idx, *, n_valid):
        """Advance a gathered chunk of slots one token: gather the chunk's
        cache columns (slot axis 1), decode at the chunk width, scatter
        only the ``n_valid`` real lanes back (padding lanes duplicate a real
        slot for the gather and are discarded)."""
        index = self._tensor(idx)
        sub = [{name: leaf[:, index] for name, leaf in g.items()}
               for g in self.caches]
        logits = self._decode(sub, tokens, positions)
        for full, new in zip(self.caches, sub):
            for name in full:
                full[name][:, index[:n_valid]] = new[name][:, :n_valid]
        return logits

    @torch.no_grad()
    def _prefill(self, prompt):
        """Single-sequence prefill into a fresh cache region, attention
        through the flash-attention kernel."""
        logits, cache = ST.prefill(self.params, self.cfg,
                                   self._tensor(prompt)[None],
                                   self.cache_len, use_kernels=True)
        return logits[0], cache

    # ------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        req.submitted_at = self.clock()
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            plen = len(req.prompt)
            if not 0 < plen < self.cache_len:
                raise ValueError(f"request {req.rid}: prompt of {plen} "
                                 f"tokens, want 1 to {self.cache_len - 1}")
            logits, cache = self._prefill(req.prompt)
            # install the prefilled single-sequence cache into this slot
            for full, new in zip(self.caches, cache):
                for name in full:
                    _install_slot(full[name], new[name], slot)
            tok = int(torch.argmax(logits))
            req.first_token_at = self.clock()
            req.output.append(tok)
            self.slot_req[slot] = req
            self.slot_pos[slot] = plen
            self.slot_last[slot] = tok
            self.slot_budget[slot] = req.max_new_tokens - 1

    def step(self) -> int:
        """One engine iteration: admit waiting requests, decode all active
        slots (in gathered dispatches of ``decode_batch`` lanes when the
        batch knob is below the slot count).  Returns the number of active
        slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        if self.decode_batch >= self.max_slots:
            # full-width dispatch: every slot, as the reference's vmap
            logits = self._decode(self.caches, self.slot_last, self.slot_pos)
            full = self.sampler(logits, None).tolist()
            nxt = {slot: int(full[slot]) for slot in active}
        else:
            nxt = {}
            width = self.decode_batch
            for c0 in range(0, len(active), width):
                chunk = active[c0:c0 + width]
                # pad the gather with a duplicate of a real lane; only the
                # first len(chunk) (distinct) lanes are scattered back
                idx = chunk + [chunk[-1]] * (width - len(chunk))
                logits = self._decode_chunk(self.slot_last[idx],
                                            self.slot_pos[idx], idx,
                                            n_valid=len(chunk))
                got = self.sampler(logits, None).tolist()
                for j, slot in enumerate(chunk):
                    nxt[slot] = int(got[j])
        self._steps += 1
        for slot in active:
            req = self.slot_req[slot]
            tok = nxt[slot]
            req.output.append(tok)
            self.slot_pos[slot] += 1
            self.slot_last[slot] = tok
            self.slot_budget[slot] -= 1
            done = (self.slot_budget[slot] <= 0
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.slot_pos[slot] >= self.cache_len - 1)
            if done:
                req.done_at = self.clock()
                self.completed.append(req)
                self.slot_req[slot] = None
        return len(active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(r is not None for r in self.slot_req)):
            if self.step() == 0 and not self.queue:
                break
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("serve loop did not converge")
        return self.completed

    def stats(self) -> dict:
        lat = [r.latency for r in self.completed if r.latency is not None]
        ttft = [r.ttft for r in self.completed if r.ttft is not None]
        toks = sum(len(r.output) for r in self.completed)
        return {
            "completed": len(self.completed),
            "decode_steps": self._steps,
            "tokens": toks,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }

    def metrics(self) -> dict:
        """Per-request latency summary over the completed set: TTFT /
        TPOT / end-to-end latency percentiles plus the aggregate token
        throughput over the serving span (first submit to last finish)."""
        done = self.completed
        ttfts = [r.ttft for r in done if r.ttft is not None]
        lats = [r.latency for r in done if r.latency is not None]
        tpots = [(r.latency - r.ttft) / (len(r.output) - 1)
                 for r in done
                 if r.latency is not None and r.ttft is not None
                 and len(r.output) > 1]
        toks = sum(len(r.output) for r in done)
        starts = [r.submitted_at for r in done if r.submitted_at is not None]
        ends = [r.done_at for r in done if r.done_at is not None]
        span = (max(ends) - min(starts)) if starts and ends else 0.0

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else None

        return {
            "completed": len(done),
            "tokens": toks,
            "decode_steps": self._steps,
            "span_s": span,
            "tokens_per_s": toks / span if span > 0.0 else 0.0,
            "ttft_p50_s": pct(ttfts, 50), "ttft_p99_s": pct(ttfts, 99),
            "tpot_p50_s": pct(tpots, 50), "tpot_p99_s": pct(tpots, 99),
            "latency_p50_s": pct(lats, 50), "latency_p99_s": pct(lats, 99),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "mean_latency_s": float(np.mean(lats)) if lats else None,
        }


# ------------------------------------------------------------------ helpers
def _install_slot(full: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Write a single-sequence cache (batch 1 at axis 1) into slot ``slot``
    of the engine cache (batch max_slots at axis 1), in place."""
    full[:, slot:slot + 1] = new.to(full.dtype)
