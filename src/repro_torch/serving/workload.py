"""Seeded synthetic many-user decode request traces (the port's own copy of
``repro/serving/workload.py``; ``tests/test_torch_serving.py`` holds it
equal to the original: the same requests and the same digest).

:class:`Workload` is a frozen, hashable description of a Poisson arrival
process of (prompt length, decode budget) pairs; it materializes a
deterministic :class:`TraceRequest` sequence and digests into a stable key.
:class:`VirtualClock` + :func:`replay` drive a real
:class:`~repro_torch.serving.engine.ServeEngine` through a trace on
simulated time: requests are submitted at their recorded arrivals, every
decode step advances the clock by a fixed ``step_time``, and the engine's
injected clock stamps TTFT/latency deterministically.

Import-light on purpose (no torch, no numpy at module load); only
:func:`materialize_requests` (prompt token arrays for a real engine)
imports numpy and the engine, lazily.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import random

__all__ = ["TraceRequest", "Workload", "VirtualClock", "replay",
           "materialize_requests"]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One synthetic user request: arrival time (seconds from trace
    start), prompt length in tokens, and decode budget in new tokens."""
    rid: int
    arrival_s: float
    prompt_len: int
    new_tokens: int


@dataclasses.dataclass(frozen=True)
class Workload:
    """Frozen trace-generator parameters.

    ``rate`` is the Poisson arrival intensity (requests/second);
    ``concurrency`` is the admission-window cap the serving simulator
    prices against (how many requests contend for decode slots at once —
    a property of the traffic, not of the searched plan).  ``prompt_lens``
    and ``new_tokens`` are inclusive uniform ranges."""
    n_requests: int = 64
    rate: float = 32.0
    concurrency: int = 48
    prompt_lens: tuple = (4, 48)
    new_tokens: tuple = (8, 48)
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if not self.rate > 0.0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1, got {self.concurrency}")
        for lo, hi in (self.prompt_lens, self.new_tokens):
            if not (1 <= lo <= hi):
                raise ValueError(
                    f"ranges must satisfy 1 <= lo <= hi, got ({lo}, {hi})")

    # --------------------------------------------------------- generation
    def requests(self) -> tuple[TraceRequest, ...]:
        """The materialized trace: deterministic in the Workload value
        (same seed -> bit-identical trace, across processes — the draws go
        through ``random.Random``, whose sequence is version-stable)."""
        return _materialize(self)

    # ------------------------------------------------------------ summary
    @property
    def mean_prompt_len(self) -> float:
        reqs = self.requests()
        return sum(r.prompt_len for r in reqs) / len(reqs)

    @property
    def mean_new_tokens(self) -> float:
        reqs = self.requests()
        return sum(r.new_tokens for r in reqs) / len(reqs)

    @property
    def total_new_tokens(self) -> int:
        return sum(r.new_tokens for r in self.requests())

    @property
    def duration_s(self) -> float:
        """Arrival span of the trace (time of the last arrival)."""
        return self.requests()[-1].arrival_s

    def arrival_fractions(self) -> tuple[float, ...]:
        """Each request's arrival as a fraction of the trace span — the
        simulator scales these onto its own decode horizon so prefill
        admissions land where the traffic actually bursts."""
        dur = self.duration_s
        if dur <= 0.0:
            return tuple(0.0 for _ in self.requests())
        return tuple(min(r.arrival_s / dur, 1.0) for r in self.requests())

    # ------------------------------------------------------ serialization
    def to_tuple(self) -> tuple:
        return ("workload.v1", self.n_requests, self.rate, self.concurrency,
                tuple(self.prompt_lens), tuple(self.new_tokens), self.seed)

    @staticmethod
    def from_tuple(t) -> "Workload":
        tag, n, rate, conc, pl, nt, seed = t
        if tag != "workload.v1":
            raise ValueError(f"not a workload tuple: {t!r}")
        return Workload(n_requests=int(n), rate=float(rate),
                        concurrency=int(conc),
                        prompt_lens=tuple(int(x) for x in pl),
                        new_tokens=tuple(int(x) for x in nt),
                        seed=int(seed))

    def digest(self) -> str:
        """Stable short digest of the generator parameters (and therefore
        of the trace) — joins the serving plan-cache key."""
        return hashlib.sha256(
            json.dumps(self.to_tuple(), sort_keys=True).encode()
        ).hexdigest()[:20]


@functools.lru_cache(maxsize=128)
def _materialize(wl: Workload) -> tuple[TraceRequest, ...]:
    rng = random.Random(wl.seed)
    t = 0.0
    out = []
    for rid in range(wl.n_requests):
        t += rng.expovariate(wl.rate)
        out.append(TraceRequest(
            rid=rid, arrival_s=t,
            prompt_len=rng.randint(*wl.prompt_lens),
            new_tokens=rng.randint(*wl.new_tokens)))
    return tuple(out)


def materialize_requests(workload: Workload, vocab: int) -> list:
    """Engine-level :class:`~repro_torch.serving.engine.Request` objects for
    the trace, with deterministic synthetic prompt tokens (numpy and the
    engine imported lazily so the module stays import-light)."""
    import numpy as np

    from .engine import Request

    rng = np.random.default_rng(workload.seed)
    out = []
    for tr in workload.requests():
        prompt = rng.integers(0, vocab, size=tr.prompt_len).astype(np.int32)
        out.append(Request(rid=tr.rid, prompt=prompt,
                           max_new_tokens=tr.new_tokens))
    return out


class VirtualClock:
    """A monotonic clock the test/replay harness advances by hand.
    Callable (drop-in for ``time.monotonic``) so it plugs straight into
    ``ServeEngine(clock=...)``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._now += dt
        return self._now


def replay(engine, workload: Workload, *, step_time: float = 1e-3,
           max_steps: int = 100_000) -> dict:
    """Drive a real engine through ``workload``'s trace on its virtual
    clock: submit requests at their recorded arrivals, advance the clock
    ``step_time`` per decode step (idle gaps jump to the next arrival),
    run to drain.  Returns ``engine.metrics()``.  The engine must have
    been built with a :class:`VirtualClock` — replaying on wall time would
    make TTFT depend on host load."""
    clock = engine.clock
    if not isinstance(clock, VirtualClock):
        raise TypeError("replay() needs an engine built with "
                        "clock=VirtualClock(); wall-clock replays are not "
                        "deterministic")
    items = materialize_requests(workload, engine.cfg.vocab)
    arrivals = [tr.arrival_s for tr in workload.requests()]
    i = 0
    for _ in range(max_steps):
        while i < len(items) and arrivals[i] <= clock() + 1e-12:
            engine.submit(items[i])
            i += 1
        n = engine.step()
        if n == 0 and not engine.queue:
            if i >= len(items):
                return engine.metrics()
            # idle: jump to the next arrival instead of spinning
            clock.advance(arrivals[i] - clock())
            continue
        clock.advance(step_time)
    raise RuntimeError(f"replay did not drain within {max_steps} steps")
