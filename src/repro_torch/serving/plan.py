"""``repro_torch.serving.plan`` — searched decode-serving plans priced
under live request traffic (port of ``repro/serving/plan.py``; DESIGN.md
Sec. 15).

The serving twin of :mod:`repro_torch.plan`: a frozen, schema-versioned
:class:`ServingPlan` artifact (decode slot count, decode dispatch batch,
KV-shard layout, per-collective algorithm, prefill stream allocation,
cluster fingerprint, predicted tokens/sec) distinct from the training
``Plan``, plus the :func:`compile_serving` facade that searches the serving
knobs with the *same* mutation-registry backtracking search the training
compiler uses.  Schema and version are the reference's, so a plan written
by either package loads in the other.

The pricing model lowers one decode window into the unified
:class:`~repro_torch.core.events.EventEngine`:

* **Decode compute** — ``rounds x dispatches x layer-spans`` dep-chained
  :class:`ComputeJob`\\ s on stream 0 (each span: weight streaming + KV
  reads vs matmul flops on the reference chip, whichever binds, plus a
  launch overhead; the last span of a dispatch adds the LM head).
  Dispatches are padded to the plan's ``decode_batch`` — padding waste is
  priced, which is exactly the batch-granularity tradeoff the search
  weighs.
* **Per-token TP collectives** — the dep-coupled lowering
  (:func:`repro_torch.core.tp_traffic.couple_tp`) applied at decode
  granularity: one latency-critical ``tp``-class job per span, gating the
  next span's compute (``bwd_bytes=0`` — there is no backward in decode).
  The KV-shard layout decides the per-layer payload multiple and
  collective kind (``replicated`` -> one all-reduce, ``head`` -> two
  all-reduces, ``sequence`` -> gathered partial-attention traffic).
* **Prefill admissions** — a competing traffic class: the seeded
  :class:`~repro_torch.serving.workload.Workload` trace's arrival pattern
  is scaled onto the decode horizon; each admission is a compute job
  (threaded into the decode chain when ``streams == 1``, on a dedicated
  prefill stream when ``streams == 2`` — bought with HBM for the prefill
  working set) plus a ``prefill``-class TP collective whose finish stamps
  that request's predicted TTFT.

Cost is **seconds per decoded token** under the trace; the search start
state *is* the default engine configuration, so the searched plan can
never price worse than the default.  Serving mutations register outside
``ALL_METHODS`` and are applicable only on ``is_serving`` simulators.

One deviation from the reference (ROADMAP C17): the defaults price an H100
— ``compile_serving(cluster="h100_superpod", hw=H100_SXM)`` and
``DEFAULT_HBM_BYTES`` of an 80 GB card, where the reference's are a TPU v5e
pod and 16 GB.  Passed the reference's values, every price, plan and cache
key is the reference's.

Import-light on purpose (no torch): plans must load and price from bare
interpreters and the plan-cache CLI.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

from ..cluster import ClusterSpec, get_preset
from ..cluster.collectives import COLLECTIVE_ALGOS, KIND_AG, KIND_AR
from ..core.events import CommJob, ComputeJob, EventEngine, TC_TP
from ..core.hw import H100_SXM, Hardware
from ..core.mutations import (SERVE_KV_LAYOUTS, SERVE_STREAM_CHOICES,
                              SERVING_METHODS)
from ..core.search import backtracking_search
from ..core.tp_traffic import TPTraffic, couple_tp
from ..plan.artifact import (ClusterMismatchError, PlanError,
                             PlanVersionError, _spec_from_fingerprint,
                             _tuplize, cluster_fingerprint,
                             cluster_fingerprint_diff)
from .workload import Workload

__all__ = [
    "SERVING_SCHEMA", "SERVING_PLAN_VERSION", "DEFAULT_HBM_BYTES",
    "KV_LAYOUTS", "TC_PREFILL", "DecodeModel", "ServingState",
    "ServingSimulator", "ServingPlan", "compile_serving",
    "serving_compile_key",
]

SERVING_SCHEMA = "repro.serving_plan"
SERVING_PLAN_VERSION = 1
SERVING_SUPPORTED_VERSIONS = (1,)

# serving memory budget per device (the Hardware dataclass carries no HBM
# capacity): an 80 GB H100, overridable per compile (the reference's is a
# v5e's 16 GB)
DEFAULT_HBM_BYTES = 80e9

TC_PREFILL = "prefill"

# KV-shard layouts: (collective kind, per-layer payload multiple,
# KV memory/read shard factor).  ``replicated`` keeps the full cache on
# every device (one MLP all-reduce per layer, maximum HBM); ``head``
# shards over KV heads (attn + MLP all-reduces, sharding saturates at
# n_kv_heads — the GQA wall); ``sequence`` shards the cache over sequence
# (scales past the head count, pays gathered partial-attention traffic).
KV_LAYOUTS = SERVE_KV_LAYOUTS  # draw choices live with the mutations
_KV_KIND = {"replicated": KIND_AR, "head": KIND_AR, "sequence": KIND_AG}
_KV_PAYLOADS = {"replicated": 1.0, "head": 2.0, "sequence": 3.0}


def kv_shard_factor(layout: str, tp_degree: int, n_kv_heads: int) -> float:
    """Per-device fraction of the KV cache held (and read) under a
    layout.  ``head`` cannot shard beyond the model's KV-head count."""
    if layout == "head":
        return 1.0 / max(1, min(tp_degree, n_kv_heads))
    if layout == "sequence":
        return 1.0 / max(1, tp_degree)
    if layout != "replicated":
        raise ValueError(f"unknown KV layout {layout!r} "
                         f"(choices: {KV_LAYOUTS})")
    return 1.0


def default_tp_degree(spec: ClusterSpec) -> int:
    """The serving TP group: the innermost link level (flat specs: up to
    8-way) — decode collectives should never cross a pod boundary."""
    if spec.is_flat_compat:
        return max(1, min(8, spec.n_devices))
    return max(1, min(8, spec.levels[0].degree))


# --------------------------------------------------------------- the model
@dataclasses.dataclass(frozen=True)
class DecodeModel:
    """The decode-relevant slice of a :class:`ModelConfig` — just enough
    to price weight streaming, KV traffic and per-token activation
    collectives, serializable into the plan artifact."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    glu: bool = True
    dtype_bytes: int = 2

    @staticmethod
    def from_config(cfg) -> "DecodeModel":
        dt = {"float32": 4, "bfloat16": 2, "float16": 2}.get(cfg.dtype, 2)
        return DecodeModel(
            name=cfg.name, n_layers=int(cfg.n_layers),
            d_model=int(cfg.d_model), n_heads=int(cfg.n_heads),
            n_kv_heads=int(cfg.n_kv_heads), head_dim=int(cfg.hd),
            d_ff=int(cfg.d_ff), vocab=int(cfg.vocab), glu=bool(cfg.glu),
            dtype_bytes=dt)

    # ------------------------------------------------------ derived sizes
    @property
    def layer_weight_bytes(self) -> float:
        attn = self.d_model * self.head_dim * (self.n_heads
                                               + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * self.d_model
        ffn = (3 if self.glu else 2) * self.d_model * self.d_ff
        return float((attn + ffn) * self.dtype_bytes)

    @property
    def head_weight_bytes(self) -> float:
        return float(self.d_model * self.vocab * self.dtype_bytes)

    @property
    def params_bytes(self) -> float:
        # embedding + LM head ride along with the layer stack
        return self.n_layers * self.layer_weight_bytes \
            + 2 * self.head_weight_bytes

    @property
    def kv_bytes_per_token(self) -> float:
        """Full-cache bytes one token pins across all layers (K and V)."""
        return float(2 * self.n_kv_heads * self.head_dim * self.dtype_bytes
                     * self.n_layers)

    @property
    def act_bytes_per_token(self) -> float:
        return float(self.d_model * self.dtype_bytes)

    # ------------------------------------------------------ serialization
    def to_tuple(self) -> tuple:
        return ("decode_model.v1", self.name, self.n_layers, self.d_model,
                self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff,
                self.vocab, self.glu, self.dtype_bytes)

    @staticmethod
    def from_tuple(t) -> "DecodeModel":
        if not t or t[0] != "decode_model.v1":
            raise ValueError(f"not a decode-model tuple: {t!r}")
        (_, name, nl, dm, nh, nkv, hd, dff, vocab, glu, db) = t
        return DecodeModel(name=str(name), n_layers=int(nl), d_model=int(dm),
                           n_heads=int(nh), n_kv_heads=int(nkv),
                           head_dim=int(hd), d_ff=int(dff), vocab=int(vocab),
                           glu=bool(glu), dtype_bytes=int(db))


# ------------------------------------------------------------ search state
SLOT_DEFAULT = 8
BATCH_DEFAULT = 8


@dataclasses.dataclass
class ServingState:
    """The searched serving knobs — the mutable state the backtracking
    search clones and mutates (the serving twin of ``FusionGraph``).  The
    default value *is* the default ``ServeEngine`` configuration, so a
    search started here can never return a worse plan."""
    slots: int = SLOT_DEFAULT
    decode_batch: int = BATCH_DEFAULT
    kv_layout: str = "replicated"
    algo: str = "ring"
    streams: int = 1

    @property
    def batch(self) -> int:
        """Effective dispatch width (a batch can never exceed the slots)."""
        return max(1, min(self.decode_batch, self.slots))

    # ------------------------------------------------- search-side protocol
    def clone(self) -> "ServingState":
        return dataclasses.replace(self)

    def signature(self) -> tuple:
        return ("serving", self.slots, self.decode_batch, self.kv_layout,
                self.algo, self.streams)

    def fast_signature(self) -> tuple:
        return self.signature()

    # ------------------------------------------------------------ mutators
    def set_slots(self, n: int) -> bool:
        n = int(n)
        if n < 1 or n == self.slots:
            return False
        self.slots = n
        return True

    def set_decode_batch(self, n: int) -> bool:
        n = int(n)
        if n < 1 or n == self.decode_batch:
            return False
        self.decode_batch = n
        return True

    def set_kv_layout(self, layout: str) -> bool:
        if layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv layout {layout!r}; "
                             f"known: {KV_LAYOUTS}")
        if layout == self.kv_layout:
            return False
        self.kv_layout = layout
        return True

    def set_algo(self, algo: str) -> bool:
        if algo not in COLLECTIVE_ALGOS:
            raise ValueError(f"unknown collective algo {algo!r}")
        if algo == self.algo:
            return False
        self.algo = algo
        return True

    def set_streams(self, n: int) -> bool:
        n = int(n)
        if n not in SERVE_STREAM_CHOICES:
            raise ValueError(f"streams must be one of "
                             f"{SERVE_STREAM_CHOICES}, got {n}")
        if n == self.streams:
            return False
        self.streams = n
        return True


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


# -------------------------------------------------------------- simulator
class ServingSimulator:
    """Prices a :class:`ServingState` as seconds per decoded token under
    a :class:`Workload` trace on a cluster, by lowering one decode window
    into the unified event engine (module docstring has the job model).

    ``is_serving`` gates the serving mutations' applicability — training
    simulators never see them, serving simulators never see the
    graph-mutating training methods (``compile_serving`` passes
    ``methods=SERVING_METHODS`` explicitly)."""

    is_serving = True
    estimator = None  # no worker pool: candidate evals are engine-bound

    def __init__(self, model: DecodeModel, workload: Workload, cluster,
                 *, hw: Hardware = H100_SXM, cache_len: int = 256,
                 tp_degree: int | None = None,
                 hbm_bytes: float = DEFAULT_HBM_BYTES,
                 max_spans: int = 6, rounds: int = 4, max_jobs: int = 240):
        self.model = model
        self.workload = workload
        self.cluster = (cluster if isinstance(cluster, ClusterSpec)
                        else get_preset(cluster))
        self.hw = hw
        self.cache_len = int(cache_len)
        self.tp_degree = (default_tp_degree(self.cluster)
                          if tp_degree is None else max(1, int(tp_degree)))
        self.hbm_bytes = float(hbm_bytes)
        self.max_spans = int(max_spans)
        self.rounds = int(rounds)
        self.max_jobs = int(max_jobs)
        self._memo: dict = {}

    # ----------------------------------------------------------- protocol
    def cost(self, state: ServingState) -> float:
        return self._run(state)["seconds_per_token"]

    def price(self, state: ServingState) -> dict:
        return dict(self._run(state))

    # ------------------------------------------------------------- sizing
    def _geometry(self, state: ServingState) -> tuple[int, int, int, int]:
        """(occupancy, dispatches, spans, rounds) for a state, bounded so
        one candidate evaluation never explodes the job count."""
        occ = max(1, min(state.slots, self.workload.concurrency))
        b = min(state.batch, occ)
        disp = -(-occ // b)
        spans = max(1, min(self.max_spans, self.model.n_layers,
                           self.max_jobs // (2 * disp)))
        rounds = max(2, min(self.rounds,
                            self.max_jobs // max(1, disp * spans)))
        return occ, disp, spans, rounds

    def mem_bytes(self, state: ServingState) -> float:
        """Per-device HBM the state pins: sharded weights, the slot KV
        cache under the layout's shard factor, and (with a dedicated
        prefill stream) the prefill working set."""
        m, tp = self.model, self.tp_degree
        shard = kv_shard_factor(state.kv_layout, tp, m.n_kv_heads)
        mem = m.params_bytes / tp \
            + state.slots * self.cache_len * m.kv_bytes_per_token * shard
        if state.streams > 1:
            max_prompt = self.workload.prompt_lens[1]
            mem += 2.0 * max_prompt * (m.d_model + m.d_ff) * m.dtype_bytes \
                + self.cache_len * m.kv_bytes_per_token * shard
        return mem

    def decode_tp(self, state: ServingState) -> TPTraffic:
        """The per-span TP traffic the decode lowering couples in — the
        byte-conservation anchor the tests compare against the training
        lowering (``couple_tp`` emits exactly ``total_bytes``)."""
        occ, disp, spans, rounds = self._geometry(state)
        b = min(state.batch, occ)
        lps = self.model.n_layers / spans
        per_span = 0.0
        if self.tp_degree > 1:
            per_span = (_KV_PAYLOADS[state.kv_layout] * lps * b
                        * self.model.act_bytes_per_token)
        return TPTraffic(n_layers=rounds * disp * spans,
                         fwd_bytes=per_span, bwd_bytes=0.0, algo=state.algo,
                         kind=_KV_KIND[state.kv_layout])

    # ------------------------------------------------------------ durations
    def _span_seconds(self, b: int, lps: float, with_head: bool) -> float:
        m, hw, tp = self.model, self.hw, self.tp_degree
        wb = m.layer_weight_bytes * lps / tp
        kv = b * 0.5 * self.cache_len * (m.kv_bytes_per_token / m.n_layers) \
            * lps * self._kv_read_shard
        fl = 2.0 * (m.layer_weight_bytes / m.dtype_bytes) * b * lps / tp
        t = max((wb + kv) / hw.hbm_bw,
                fl / (hw.peak_flops * hw.efficiency)) + hw.launch_overhead
        if with_head:
            hb = m.head_weight_bytes / tp
            hf = 2.0 * (m.head_weight_bytes / m.dtype_bytes) * b / tp
            t += max(hb / hw.hbm_bw, hf / (hw.peak_flops * hw.efficiency))
        return t

    def _prefill_seconds(self) -> float:
        m, hw, tp = self.model, self.hw, self.tp_degree
        P = self.workload.mean_prompt_len
        fl = 2.0 * (m.params_bytes / m.dtype_bytes) * P / tp
        return max(m.params_bytes / tp / hw.hbm_bw,
                   fl / (hw.peak_flops * hw.efficiency)) + hw.launch_overhead

    # ------------------------------------------------------------- lowering
    def _run(self, state: ServingState) -> dict:
        key = state.fast_signature()
        hit = self._memo.get(key)
        if hit is not None:
            return hit

        m, wl, tp = self.model, self.workload, self.tp_degree
        mem = self.mem_bytes(state)
        if mem > self.hbm_bytes:
            out = {"feasible": False,
                   "reason": f"needs {mem:.3e} B HBM > budget "
                             f"{self.hbm_bytes:.3e} B",
                   "mem_bytes": mem, "hbm_bytes": self.hbm_bytes,
                   "seconds_per_token": float("inf"),
                   "tokens_per_s": 0.0, "state": state.signature()}
            self._memo[key] = out
            return out

        occ, disp, spans, rounds = self._geometry(state)
        b = min(state.batch, occ)
        lps = m.n_layers / spans
        self._kv_read_shard = kv_shard_factor(state.kv_layout, tp,
                                              m.n_kv_heads)

        # decode chain: rounds x dispatches x spans dep-chained jobs
        chain: list[ComputeJob] = []
        jid = -1
        for r in range(rounds):
            for d in range(disp):
                for s in range(spans):
                    i = len(chain)
                    chain.append(ComputeJob(
                        ref=i,
                        duration=self._span_seconds(b, lps,
                                                    with_head=s == spans - 1),
                        job_id=jid, stream=0, key=i,
                        deps=(chain[-1].job_id,) if chain else ()))
                    jid -= 1
        horizon = sum(j.duration for j in chain)

        # per-span TP collectives, dep-coupled at decode granularity
        tpt = self.decode_tp(state)
        next_id = 1
        chain, fwd_jobs, _, next_id = couple_tp(
            chain, list(range(1, len(chain) + 1)), tpt, next_id)

        # prefill admissions from the trace's arrival pattern
        t_pref = self._prefill_seconds()
        n_pref = max(1, min(wl.n_requests, 2 * rounds * disp,
                            round(rounds * occ / wl.mean_new_tokens)))
        fr = wl.arrival_fractions()
        pref_bytes = 0.0
        if tp > 1:
            pref_bytes = (_KV_PAYLOADS[state.kv_layout] * m.n_layers
                          * wl.mean_prompt_len * m.act_bytes_per_token)
        comm: list[CommJob] = list(fwd_jobs)
        ttft_gates: list[tuple[int, float]] = []   # (gate job id, ready)
        prev_pref: int | None = None
        stream = 0 if state.streams == 1 else 1
        kcount = len(chain)
        admissions = []
        for k in range(n_pref):
            frac = fr[(k * len(fr)) // n_pref]
            admissions.append((min(len(chain) - 1, int(frac * len(chain))),
                               frac * horizon))
        admissions.sort()
        for pos, ready in admissions:
            deps = () if prev_pref is None else (prev_pref,)
            if stream == 0 and pos > 0:
                deps = deps + (chain[pos - 1].job_id,)
            pj = ComputeJob(ref=kcount, duration=t_pref, job_id=jid,
                            stream=stream, key=kcount, deps=deps,
                            kind="prefill", ready=ready,
                            traffic_class=TC_PREFILL)
            jid -= 1
            kcount += 1
            prev_pref = pj.job_id
            chain.append(pj)
            if stream == 0:
                # threaded into the decode chain: the next decode dispatch
                # waits for the admission (the training TP coupling pattern)
                nxt = chain[pos]
                chain[pos] = dataclasses.replace(
                    nxt, deps=nxt.deps + (pj.job_id,))
            if pref_bytes > 0.0:
                cj = CommJob(bucket=kcount, ready=0.0, nbytes=pref_bytes,
                             algo=state.algo, kind=_KV_KIND[state.kv_layout],
                             job_id=next_id, deps=(pj.job_id,),
                             traffic_class=TC_PREFILL)
                next_id += 1
                comm.append(cj)
                ttft_gates.append((cj.job_id, ready))
            else:
                ttft_gates.append((pj.job_id, ready))

        if not fwd_jobs:
            # tp_degree == 1 emits no TP jobs; force the coupled (phased)
            # path anyway so prefill ready times are honored — a zero-byte
            # sentinel is pre-finished at t=0 and costs nothing
            sentinel = CommJob(bucket=0, ready=0.0, nbytes=0.0,
                               job_id=next_id, traffic_class=TC_TP)
            next_id += 1
            comm.append(sentinel)
            first = chain[0]
            chain[0] = dataclasses.replace(
                first, deps=first.deps + (sentinel.job_id,))

        eng = EventEngine(self.cluster, streams=1)
        u = eng.run_unified(chain, comm)

        decode_ids = [j.job_id for j in chain
                      if j.traffic_class != TC_PREFILL] \
            + [j.job_id for j in fwd_jobs]
        decode_finish = max(eng.job_finish[i] for i in decode_ids)
        tokens = rounds * occ
        spt = decode_finish / tokens
        ttfts = sorted(max(0.0, eng.job_finish[g] - ready)
                       for g, ready in ttft_gates)
        out = {
            "feasible": True,
            "seconds_per_token": spt,
            "tokens_per_s": tokens / decode_finish,
            "decode_finish_s": decode_finish,
            "finish_s": u.finish,
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p99_s": _pct(ttfts, 0.99),
            "occupancy": occ,
            "dispatch_batch": b,
            "dispatches": disp,
            "spans": spans,
            "rounds": rounds,
            "tokens": tokens,
            "n_prefills": n_pref,
            "prefill_s": t_pref,
            "tp_bytes_decode": sum(j.nbytes for j in fwd_jobs),
            "tp_bytes_total": tpt.total_bytes,
            "tp_busy_s": eng.class_busy.get(TC_TP, 0.0),
            "prefill_busy_s": eng.class_busy.get(TC_PREFILL, 0.0),
            "mem_bytes": mem,
            "hbm_bytes": self.hbm_bytes,
            "tp_degree": tp,
            "state": state.signature(),
        }
        self._memo[key] = out
        return out


# ---------------------------------------------------------------- artifact
def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """The frozen serving-strategy artifact: the searched knobs plus
    everything needed to rebuild the pricing context (model slice,
    workload, cluster fingerprint, reference chip) and re-verify the
    prediction.  Distinct schema from the training ``Plan`` — a serving
    plan loaded by ``Plan.load`` fails with ``PlanVersionError``, and vice
    versa, instead of silently mispricing."""
    slots: int
    decode_batch: int
    kv_layout: str
    algo: str
    streams: int
    cache_len: int
    tp_degree: int
    hbm_bytes: float
    model: tuple
    workload: tuple
    workload_digest: str
    cluster: tuple
    hw: tuple
    predicted_tokens_per_s: float
    predicted_ttft_p99_s: float
    version: int = SERVING_PLAN_VERSION
    provenance: dict = dataclasses.field(default_factory=dict, compare=False)

    # -------------------------------------------------------- construction
    @staticmethod
    def from_search(state: ServingState, sim: ServingSimulator,
                    price: dict, provenance: dict | None = None
                    ) -> "ServingPlan":
        return ServingPlan(
            slots=state.slots, decode_batch=state.decode_batch,
            kv_layout=state.kv_layout, algo=state.algo,
            streams=state.streams, cache_len=sim.cache_len,
            tp_degree=sim.tp_degree, hbm_bytes=sim.hbm_bytes,
            model=sim.model.to_tuple(),
            workload=sim.workload.to_tuple(),
            workload_digest=sim.workload.digest(),
            cluster=cluster_fingerprint(sim.cluster),
            hw=_tuplize(sorted(dataclasses.asdict(sim.hw).items())),
            predicted_tokens_per_s=float(price.get("tokens_per_s", 0.0)),
            predicted_ttft_p99_s=float(price.get("ttft_p99_s", 0.0)),
            provenance=dict(provenance or {}))

    # ------------------------------------------------------------ accessors
    def state(self) -> ServingState:
        return ServingState(slots=self.slots, decode_batch=self.decode_batch,
                            kv_layout=self.kv_layout, algo=self.algo,
                            streams=self.streams)

    @property
    def predicted_iteration_time(self) -> float | None:
        """Seconds per decoded token — the cache index's display metric
        (the serving analogue of a training plan's iteration time)."""
        if self.predicted_tokens_per_s > 0.0:
            return 1.0 / self.predicted_tokens_per_s
        return None

    def simulator(self, cluster: ClusterSpec | None = None
                  ) -> ServingSimulator:
        """Rebuild the pricing simulator.  An explicit ``cluster`` that
        does not match the recorded fingerprint raises
        :class:`ClusterMismatchError` (same contract as the training
        plan) — pass nothing to price on the recorded topology."""
        if cluster is not None:
            fp = cluster_fingerprint(cluster)
            if fp != self.cluster:
                diff = cluster_fingerprint_diff(self.cluster, fp)
                raise ClusterMismatchError(
                    f"plan was searched against a different cluster "
                    f"({len(diff)} field(s) differ; first: "
                    f"{diff[0] if diff else '?'})")
            spec = cluster
        else:
            spec = _spec_from_fingerprint(self.cluster)
        return ServingSimulator(
            DecodeModel.from_tuple(self.model),
            Workload.from_tuple(self.workload), spec,
            hw=Hardware(**dict(self.hw)), cache_len=self.cache_len,
            tp_degree=self.tp_degree, hbm_bytes=self.hbm_bytes)

    def price(self, cluster: ClusterSpec | None = None) -> dict:
        """Re-price the plan's knobs (on the recorded fingerprint, or an
        explicit matching/overriding cluster).  Unlike :meth:`simulator`,
        an override mismatch does not raise — it prices anyway and reports
        ``cluster_fingerprint_match: False`` (the dryrun CLI turns that
        into a field-by-field diff and a nonzero exit)."""
        match = True
        if cluster is not None:
            match = cluster_fingerprint(cluster) == self.cluster
            sim = ServingSimulator(
                DecodeModel.from_tuple(self.model),
                Workload.from_tuple(self.workload), cluster,
                hw=Hardware(**dict(self.hw)), cache_len=self.cache_len,
                tp_degree=self.tp_degree, hbm_bytes=self.hbm_bytes)
        else:
            sim = self.simulator()
        out = sim.price(self.state())
        out["cluster"] = {"name": sim.cluster.name,
                          "n_devices": sim.cluster.n_devices}
        out["cluster_fingerprint_match"] = match
        return out

    def describe(self) -> dict:
        return {
            "schema": SERVING_SCHEMA,
            "version": self.version,
            "arch": self.model[1],
            "slots": self.slots,
            "decode_batch": self.decode_batch,
            "kv_layout": self.kv_layout,
            "algo": self.algo,
            "streams": self.streams,
            "cache_len": self.cache_len,
            "tp_degree": self.tp_degree,
            "workload_digest": self.workload_digest,
            "predicted_tokens_per_s": self.predicted_tokens_per_s,
            "predicted_ttft_p99_s": self.predicted_ttft_p99_s,
        }

    # ---------------------------------------------------------------- JSON
    def _to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = SERVING_SCHEMA
        return d

    def fingerprint(self) -> str:
        import hashlib
        d = self._to_json()
        d.pop("provenance", None)
        return hashlib.sha256(
            json.dumps(d, sort_keys=True, default=repr).encode()
        ).hexdigest()[:16]

    def save(self, path: str) -> str:
        _atomic_json(path, self._to_json())
        return path

    @staticmethod
    def from_dict(d: dict) -> "ServingPlan":
        if not isinstance(d, dict) or d.get("schema") != SERVING_SCHEMA:
            raise PlanVersionError(
                f"not a {SERVING_SCHEMA} artifact "
                f"(schema={d.get('schema') if isinstance(d, dict) else '?'})")
        v = d.get("version")
        if v not in SERVING_SUPPORTED_VERSIONS:
            raise PlanVersionError(
                f"unsupported serving-plan version {v!r}; supported: "
                f"{SERVING_SUPPORTED_VERSIONS}")
        try:
            return ServingPlan(
                slots=int(d["slots"]), decode_batch=int(d["decode_batch"]),
                kv_layout=str(d["kv_layout"]), algo=str(d["algo"]),
                streams=int(d["streams"]), cache_len=int(d["cache_len"]),
                tp_degree=int(d["tp_degree"]),
                hbm_bytes=float(d["hbm_bytes"]),
                model=_tuplize(d["model"]),
                workload=_tuplize(d["workload"]),
                workload_digest=str(d["workload_digest"]),
                cluster=_tuplize(d["cluster"]),
                hw=_tuplize(d["hw"]),
                predicted_tokens_per_s=float(d["predicted_tokens_per_s"]),
                predicted_ttft_p99_s=float(d["predicted_ttft_p99_s"]),
                version=int(v),
                provenance=dict(d.get("provenance") or {}))
        except (KeyError, TypeError, ValueError) as e:
            raise PlanError(f"malformed serving plan: {e}") from e

    @staticmethod
    def load(path: str) -> "ServingPlan":
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise PlanError(f"cannot read serving plan {path}: {e}") from e
        return ServingPlan.from_dict(d)


# ----------------------------------------------------------------- facade
def serving_compile_key(model: DecodeModel, workload: Workload,
                        sim: ServingSimulator, knobs: str) -> str:
    """The plan-cache key of one serving compile point: model slice x
    workload digest x pricing context x search knobs (the serving twin of
    ``repro_torch.plan.cache.compile_key`` — the workload digest keeps
    two traffic patterns from sharing a plan)."""
    from ..plan.cache import _sha
    return _sha({
        "schema": SERVING_SCHEMA,
        "model": model.to_tuple(),
        "workload": workload.digest(),
        "cache_len": sim.cache_len,
        "tp_degree": sim.tp_degree,
        "hbm_bytes": sim.hbm_bytes,
        "cluster": cluster_fingerprint(sim.cluster),
        "hw": sorted(dataclasses.asdict(sim.hw).items()),
        "knobs": knobs,
    })


def _cache_features(model: DecodeModel, workload: Workload,
                    sim: ServingSimulator, knobs: str) -> dict:
    """Index features in the training cache's key vocabulary so the
    ``ls``/``stats`` CLI and similarity ranking stay schema-agnostic
    (``graph`` is namespaced — a serving entry can never look like an
    exact trace match to a training request)."""
    from ..plan.cache import _sha
    spec = sim.cluster
    if spec.is_flat_compat:
        levels = ["flat"]
    else:
        levels = [l.name for l in spec.levels]
    return {
        "schema": SERVING_SCHEMA,
        "graph": f"serving:{workload.digest()}",
        "arch": model.name,
        "cluster": _sha(cluster_fingerprint(spec)),
        "cluster_name": spec.name,
        "n_devices": int(spec.n_devices),
        "levels": levels,
        "knobs": knobs,
    }


def compile_serving(arch, *, cluster="h100_superpod",
                    workload: Workload | None = None, cache_len: int = 256,
                    tp_degree: int | None = None, hw: Hardware = H100_SXM,
                    hbm_bytes: float = DEFAULT_HBM_BYTES,
                    alpha: float = 1.05, beta: int = 10,
                    unchanged_limit: int = 60, max_steps: int | None = None,
                    methods=None, seed: int = 0, cache=None) -> ServingPlan:
    """Search a serving plan for ``arch`` (a config name, ``ModelConfig``
    or :class:`DecodeModel`) under ``workload`` traffic on ``cluster``.

    The search starts from the default :class:`ServingState` (the stock
    ``ServeEngine`` configuration), so the returned plan never prices
    worse than the default.  ``cache`` replays exact hits bit-identically
    through the shared :class:`~repro_torch.plan.cache.PlanCache` (the
    workload digest joins the key)."""
    from ..plan.cache import knob_digest, open_cache

    if isinstance(arch, DecodeModel):
        model = arch
    elif isinstance(arch, str):
        from ..configs import get_config
        model = DecodeModel.from_config(get_config(arch))
    else:
        model = DecodeModel.from_config(arch)
    wl = workload if workload is not None else Workload()
    spec = get_preset(cluster) if isinstance(cluster, str) else cluster
    sim = ServingSimulator(model, wl, spec, hw=hw, cache_len=cache_len,
                           tp_degree=tp_degree, hbm_bytes=hbm_bytes)
    if methods is None:
        # explicit: the training mutations' applies would crash on a
        # ServingState, and their applicability defaults to True
        methods = SERVING_METHODS
    store = open_cache(cache)
    knobs = knob_digest(alpha=alpha, beta=beta,
                        unchanged_limit=unchanged_limit, max_steps=max_steps,
                        methods=methods, seed=seed)
    key = serving_compile_key(model, wl, sim, knobs)
    if store is not None:
        hit = store.get(key)
        if isinstance(hit, ServingPlan):
            hit.provenance["cache"] = {"outcome": "hit", "key": key}
            return hit

    t0 = time.perf_counter()
    res = backtracking_search(ServingState(), sim, alpha=alpha, beta=beta,
                              unchanged_limit=unchanged_limit,
                              max_steps=max_steps, methods=methods,
                              seed=seed)
    price = sim.price(res.best)
    plan = ServingPlan.from_search(res.best, sim, price, provenance={
        "arch": model.name,
        "cluster_name": spec.name,
        "initial_cost": res.initial_cost,
        "best_cost": res.best_cost,
        "steps": res.steps,
        "simulations": res.simulations,
        "search_wall_time": round(time.perf_counter() - t0, 3),
        "seed": seed,
        "cache": {"outcome": "miss" if store is not None else "disabled",
                  "key": key if store is not None else None},
    })
    if store is not None:
        store.put(key, plan, _cache_features(model, wl, sim, knobs))
    return plan
