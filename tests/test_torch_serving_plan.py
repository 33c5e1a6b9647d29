"""The port's serving plan (``repro_torch.serving.plan``) against the
reference's (``repro.serving.plan``), on the CPU:

* the reference's ``tests/test_serving_plan.py`` cases run against the
  port's copy (property cases at 10 examples);
* ``compile_serving``, the pricing and the artifact bit-identical to the
  reference's when given the reference's defaults (``tpu_v5e_pod_16``,
  ``TPU_V5E``, 16 GB); the port's own defaults price an H100 (ROADMAP
  C17);
* a ``ServingPlan`` written by either package loads in the other, and one
  plan cache directory serves serving entries to both;
* ``ServeEngine(plan=...)`` takes the plan's ``kv_layout`` (ROADMAP C16),
  twin of ``tests/test_serving.py::test_plan_enactment_and_metrics``;
* the ``serve_with_plan`` example runs.
"""
import dataclasses
import functools
import json
import math
import os

import numpy as np
import pytest
from _propcheck import given, settings, st

torch = pytest.importorskip("torch")

import repro.plan as RPLAN  # noqa: E402
import repro.serving.plan as RSP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.hw import TPU_V5E as R_TPU_V5E  # noqa: E402
from repro.serving.workload import Workload as RWorkload  # noqa: E402

from repro_torch.cluster import get_preset  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import backtracking_search  # noqa: E402
from repro_torch.core.events import ComputeJob  # noqa: E402
from repro_torch.core.hw import H100_SXM, TPU_V5E  # noqa: E402
from repro_torch.core.mutations import SERVING_METHODS  # noqa: E402
from repro_torch.core.tp_traffic import couple_tp  # noqa: E402
from repro_torch.plan import (ClusterMismatchError, Plan,  # noqa: E402
                              PlanCache, PlanError, PlanVersionError)
from repro_torch.plan.cache import _load_artifact, warm_start_state  # noqa: E402
from repro_torch.serving.plan import (DEFAULT_HBM_BYTES,  # noqa: E402
                                      DecodeModel, ServingPlan,
                                      ServingSimulator, ServingState,
                                      compile_serving, kv_shard_factor)
from repro_torch.serving.workload import (VirtualClock,  # noqa: E402
                                          Workload, replay)

# the reference's defaults, passed explicitly to the port
REF_DEFAULTS = dict(cluster="tpu_v5e_pod_16", hbm_bytes=16e9)


# ------------------------------------------------------------------ trace
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 64))
def test_trace_seeded_reproducible(seed, n):
    a = Workload(n_requests=n, seed=seed)
    b = Workload(n_requests=n, seed=seed)
    assert a.requests() == b.requests()
    assert a.digest() == b.digest()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_trace_conservation_and_monotone(seed):
    wl = Workload(n_requests=32, prompt_lens=(2, 9), new_tokens=(1, 5),
                  seed=seed)
    reqs = wl.requests()
    assert len(reqs) == wl.n_requests
    assert [r.rid for r in reqs] == list(range(wl.n_requests))
    last = 0.0
    for r in reqs:
        assert r.arrival_s >= last
        last = r.arrival_s
        assert 2 <= r.prompt_len <= 9
        assert 1 <= r.new_tokens <= 5
    assert wl.total_new_tokens == sum(r.new_tokens for r in reqs)
    fr = wl.arrival_fractions()
    assert len(fr) == wl.n_requests and all(0.0 <= f <= 1.0 for f in fr)


def test_trace_digest_discriminates():
    base = Workload(seed=0)
    assert base.digest() != Workload(seed=1).digest()
    assert base.digest() != Workload(rate=16.0).digest()
    assert base.digest() != Workload(concurrency=8).digest()
    assert Workload.from_tuple(base.to_tuple()) == base


def test_workload_validation():
    with pytest.raises(ValueError):
        Workload(n_requests=0)
    with pytest.raises(ValueError):
        Workload(rate=0.0)
    with pytest.raises(ValueError):
        Workload(prompt_lens=(5, 2))


def test_virtual_clock():
    clk = VirtualClock()
    assert clk() == 0.0
    clk.advance(1.5)
    assert clk() == 1.5
    with pytest.raises(ValueError):
        clk.advance(-0.1)


# ------------------------------------------------------------- the artifact
def _small_plan(cluster="h100_superpod", seed=0, cache=None):
    return compile_serving(
        "tinyllama-1.1b", cluster=cluster,
        workload=Workload(n_requests=24, seed=3),
        unchanged_limit=10, max_steps=20, seed=seed, cache=cache)


@pytest.fixture(scope="module")
def small_plan():
    return _small_plan()


def test_serving_plan_roundtrip_bit_identity(tmp_path, small_plan):
    plan = small_plan
    path = os.path.join(tmp_path, "sp.json")
    plan.save(path)
    loaded = ServingPlan.load(path)
    assert loaded == plan
    assert loaded.fingerprint() == plan.fingerprint()
    path2 = os.path.join(tmp_path, "sp2.json")
    loaded.save(path2)
    with open(path) as a, open(path2) as b:
        assert a.read() == b.read()


def test_serving_plan_foreign_versions(tmp_path, small_plan):
    d = small_plan._to_json()
    with pytest.raises(PlanVersionError):
        ServingPlan.from_dict(dict(d, schema="repro.other_plan"))
    with pytest.raises(PlanVersionError):
        ServingPlan.from_dict(dict(d, version=999))
    with pytest.raises(PlanError):
        ServingPlan.from_dict({"schema": "repro.serving_plan", "version": 1})
    # the training loader rejects serving JSON instead of mis-parsing it
    with pytest.raises(PlanError):
        Plan.from_dict(d)
    with pytest.raises(PlanError):
        ServingPlan.load(os.path.join(tmp_path, "missing.json"))
    torn = os.path.join(tmp_path, "torn.json")
    with open(torn, "w") as f:
        f.write(json.dumps(d)[: len(json.dumps(d)) // 2])
    with pytest.raises(PlanError):
        ServingPlan.load(torn)


def test_cluster_mismatch_reprice(small_plan):
    plan = small_plan
    other = get_preset("a100_nvlink_ib")
    with pytest.raises(ClusterMismatchError):
        plan.simulator(cluster=other)
    p = plan.price(cluster=other)
    assert p["cluster_fingerprint_match"] is False
    assert plan.price()["cluster_fingerprint_match"] is True


# -------------------------------------------------------- decode lowering
def _sim(preset="h100_superpod"):
    model = DecodeModel.from_config(get_config("tinyllama-1.1b"))
    return ServingSimulator(model, Workload(n_requests=24, seed=3),
                            get_preset(preset))


@pytest.mark.parametrize("layout", ("replicated", "head", "sequence"))
@pytest.mark.parametrize("algo", ("ring", "hier"))
def test_decode_lowering_byte_conservation(layout, algo):
    sim = _sim()
    state = ServingState(kv_layout=layout, algo=algo)
    tpt = sim.decode_tp(state)
    price = sim.price(state)
    assert price["feasible"]
    assert math.isclose(price["tp_bytes_decode"], tpt.total_bytes,
                        rel_tol=1e-9)
    assert price["tp_bytes_total"] == tpt.total_bytes


def test_decode_lowering_matches_training_couple_tp():
    sim = _sim()
    state = ServingState()
    tpt = sim.decode_tp(state)
    chain = [ComputeJob(ref=i, duration=1e-6, job_id=-(i + 1), key=i)
             for i in range(tpt.n_layers)]
    ends = list(range(1, tpt.n_layers + 1))
    _, fwd, bwd, _ = couple_tp(chain, ends, tpt, next_id=1)
    assert bwd == []
    emitted = sum(j.nbytes for j in fwd)
    assert math.isclose(emitted, sim.price(state)["tp_bytes_decode"],
                        rel_tol=1e-9)


def test_tp1_is_commfree_but_feasible():
    model = DecodeModel.from_config(get_config("tinyllama-1.1b"))
    sim = ServingSimulator(model, Workload(n_requests=24, seed=3),
                           get_preset("h100_superpod"), tp_degree=1)
    p = sim.price(ServingState())
    assert p["feasible"] and p["tp_bytes_decode"] == 0.0
    assert p["seconds_per_token"] > 0.0


def test_infeasible_memory_prices_inf():
    model = DecodeModel.from_config(get_config("tinyllama-1.1b"))
    sim = ServingSimulator(model, Workload(n_requests=24, seed=3),
                           get_preset("h100_superpod"), hbm_bytes=1e6)
    p = sim.price(ServingState())
    assert not p["feasible"]
    assert p["seconds_per_token"] == float("inf")
    assert p["tokens_per_s"] == 0.0


def test_kv_shard_factor():
    assert kv_shard_factor("head", 8, 4) == pytest.approx(0.25)
    assert kv_shard_factor("sequence", 8, 4) == pytest.approx(0.125)
    assert kv_shard_factor("replicated", 8, 4) == 1.0
    with pytest.raises(ValueError):
        kv_shard_factor("bogus", 8, 4)


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("preset", ("h100_superpod", "a100_nvlink_ib"))
def test_searched_never_worse_than_default(preset):
    sim = _sim(preset)
    default = ServingState()
    d_cost = sim.cost(default)
    res = backtracking_search(default, sim, methods=SERVING_METHODS,
                              unchanged_limit=15, max_steps=40, seed=0)
    assert res.best_cost <= d_cost * (1 + 1e-9)
    assert res.initial_cost == d_cost
    assert isinstance(res.best, ServingState)
    assert sim.price(res.best)["feasible"]


def test_search_is_deterministic():
    sim = _sim()
    r1 = backtracking_search(ServingState(), sim, methods=SERVING_METHODS,
                             unchanged_limit=10, max_steps=25, seed=7)
    r2 = backtracking_search(ServingState(), sim, methods=SERVING_METHODS,
                             unchanged_limit=10, max_steps=25, seed=7)
    assert r1.best.signature() == r2.best.signature()
    assert r1.best_cost == r2.best_cost


# ------------------------------------------------------------------- cache
def test_serving_plan_through_plan_cache(tmp_path):
    cache = PlanCache(os.path.join(tmp_path, "cache"))
    plan = _small_plan()
    cache.put("servekey", plan, {"schema": "repro.serving_plan",
                                 "graph": "serving:x", "cluster": "c",
                                 "arch": "tinyllama-1.1b"})
    got = cache.get("servekey")
    assert isinstance(got, ServingPlan)
    assert got == plan and got.fingerprint() == plan.fingerprint()
    v = cache.verify()
    assert v["ok"] == 1 and not v["corrupt"]
    assert warm_start_state(plan, base=None, sim=None) is None
    art = _load_artifact(cache._plan_path("servekey"))
    assert isinstance(art, ServingPlan)


def test_compile_serving_cache_hit_zero_search(tmp_path):
    cachedir = os.path.join(tmp_path, "cache")
    p1 = _small_plan(cache=cachedir)
    p2 = _small_plan(cache=cachedir)
    assert p1.provenance["cache"]["outcome"] == "miss"
    assert p2.provenance["cache"]["outcome"] == "hit"
    assert p1 == p2 and p1.fingerprint() == p2.fingerprint()
    p3 = compile_serving("tinyllama-1.1b", cluster="h100_superpod",
                         workload=Workload(n_requests=24, seed=4),
                         unchanged_limit=10, max_steps=20, seed=0,
                         cache=cachedir)
    assert p3.provenance["cache"]["outcome"] == "miss"
    assert p3.provenance["cache"]["key"] != p1.provenance["cache"]["key"]


# ------------------------------------------------ against the reference
# (cluster, workload kwargs, cache_len, tp_degree, seed)
PARITY = [
    ("tpu_v5e_pod_16", dict(n_requests=24, seed=3), 256, None, 0),
    ("a100_nvlink_ib", dict(n_requests=16, rate=16.0, seed=5), 1024, None, 3),
    ("h100_superpod", dict(n_requests=32, prompt_lens=(16, 2048),
                           new_tokens=(32, 64), seed=0), 4096, 1, 0),
]


# (slots, decode_batch, kv_layout, algo, streams)
STATES = [(8, 8, "replicated", "ring", 1), (8, 8, "head", "hier", 2),
          (32, 4, "sequence", "tree", 1), (32, 4, "replicated", "hier", 2),
          (64, 16, "head", "ring", 2), (4, 64, "sequence", "ring", 2)]


def _strip(d: dict) -> dict:
    """An artifact's JSON without its provenance (wall times differ)."""
    d = dict(d)
    d.pop("provenance")
    return d


def _compile(package, cluster, wl, cache_len, tp, seed, cache=None):
    """One compile point in ``package`` ("reference" or "port"), priced
    under the reference's defaults."""
    kw = dict(cluster=cluster, cache_len=cache_len, tp_degree=tp,
              unchanged_limit=15, max_steps=30, seed=seed, cache=cache,
              hbm_bytes=REF_DEFAULTS["hbm_bytes"])
    if package == "reference":
        return RSP.compile_serving("tinyllama-1.1b",
                                   workload=RWorkload(**wl), **kw)
    return compile_serving("tinyllama-1.1b", workload=Workload(**wl),
                           hw=TPU_V5E, **kw)


@functools.lru_cache(maxsize=None)
def _both(i):
    """PARITY[i] compiled in (reference, port), no cache."""
    return _compile("reference", *PARITY[i]), _compile("port", *PARITY[i])


@pytest.mark.parametrize("i", range(len(PARITY)))
def test_compile_serving_bit_identical_to_reference(i):
    ref, port = _both(i)
    assert _strip(port._to_json()) == _strip(ref._to_json())
    assert port.fingerprint() == ref.fingerprint()
    for k in ("steps", "simulations", "initial_cost", "best_cost"):
        assert port.provenance[k] == ref.provenance[k], k
    assert port.price() == ref.price()


@pytest.mark.parametrize("preset", ("tpu_v5e_pod_16", "h100_superpod"))
def test_pricing_bit_identical_to_reference(preset):
    """Every layout, algorithm and stream count, at slot and batch
    geometries with one and several dispatches, under ``TPU_V5E`` and
    16 GB in both packages."""
    rmodel = RSP.DecodeModel.from_config(jax_config("tinyllama-1.1b"))
    pmodel = DecodeModel.from_config(get_config("tinyllama-1.1b"))
    assert pmodel.to_tuple() == rmodel.to_tuple()
    rsim = RSP.ServingSimulator(rmodel, RWorkload(n_requests=24, seed=3),
                                preset, hw=R_TPU_V5E, hbm_bytes=16e9)
    psim = ServingSimulator(pmodel, Workload(n_requests=24, seed=3), preset,
                            hw=TPU_V5E, hbm_bytes=16e9)
    for slots, batch, layout, algo, streams in STATES:
        kw = dict(slots=slots, decode_batch=batch, kv_layout=layout,
                  algo=algo, streams=streams)
        assert psim.price(ServingState(**kw)) == \
            rsim.price(RSP.ServingState(**kw)), kw


def test_defaults_price_an_h100():
    """ROADMAP C17: the port's defaults are an H100 cluster, ``H100_SXM``
    and 80 GB, where the reference's are a v5e pod, ``TPU_V5E`` and
    16 GB."""
    assert DEFAULT_HBM_BYTES == 80e9 and RSP.DEFAULT_HBM_BYTES == 16e9
    plan = compile_serving("tinyllama-1.1b", max_steps=5)
    assert dict(plan.hw) == dataclasses.asdict(H100_SXM)
    assert plan.hbm_bytes == 80e9
    assert plan.simulator().cluster.name == "h100_superpod"


def test_plan_json_crosses_packages(tmp_path):
    ref, port = _both(0)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port.save(a)
    ref.save(b)
    from_port = RSP.ServingPlan.load(a)
    from_ref = ServingPlan.load(b)
    assert _strip(from_port._to_json()) == _strip(port._to_json())
    assert _strip(from_ref._to_json()) == _strip(ref._to_json())
    assert from_ref == port and from_port == ref
    assert from_ref.price() == from_port.price()


@pytest.mark.parametrize("first", ["reference", "port"])
def test_plan_cache_shared_by_both_packages(tmp_path, first):
    """A serving entry written by either package is an exact hit for the
    other, loaded as its own ``ServingPlan``; a training cache reader
    (``PlanCache``) of either package indexes it."""
    d = str(tmp_path / "cache")
    second = {"reference": "port", "port": "reference"}[first]
    cold = _compile(first, *PARITY[0], cache=d)
    hit = _compile(second, *PARITY[0], cache=d)
    assert isinstance(hit, ServingPlan if second == "port"
                      else RSP.ServingPlan)
    assert cold.provenance["cache"]["outcome"] == "miss"
    assert hit.provenance["cache"]["outcome"] == "hit"
    assert _strip(hit._to_json()) == _strip(cold._to_json())
    for cache in (PlanCache(d), RPLAN.PlanCache(d)):
        rep = cache.verify()
        assert rep["ok"] == 1 and rep["corrupt"] == []


# ----------------------------------------------------------- the engine
def test_plan_enactment_and_metrics():
    """Twin of ``tests/test_serving.py::test_plan_enactment_and_metrics``
    on the port: the engine takes the plan's slots, batch and KV layout
    (explicit kwargs win), and ``replay`` on a virtual clock serves every
    request."""
    from repro_torch.models import stacked as ST
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("tinyllama-1.1b").reduced()
    params = ST.init_params(cfg, seed=0, device="cpu")
    plan = compile_serving("tinyllama-1.1b", cluster="tpu_v5e_pod_16",
                           workload=Workload(n_requests=16, seed=0),
                           unchanged_limit=8, max_steps=15, seed=0)
    clk = VirtualClock()
    eng = ServeEngine(params, cfg, plan=plan, max_slots=3, cache_len=48,
                      decode_batch=2, clock=clk)
    assert eng.max_slots == 3 and eng.decode_batch == 2
    assert eng.plan is plan and eng.kv_layout == plan.kv_layout
    wl = Workload(n_requests=5, rate=64.0, concurrency=3,
                  prompt_lens=(3, 6), new_tokens=(2, 4), seed=2)
    m = replay(eng, wl, step_time=1e-3)
    assert m["completed"] == 5
    assert m["tokens"] == sum(r.new_tokens for r in wl.requests())
    for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
              "latency_p50_s", "latency_p99_s", "mean_ttft_s"):
        assert k in m
    assert m["tokens_per_s"] > 0.0
    assert m["latency_p99_s"] >= m["ttft_p50_s"] >= 0.0
    # without a plan the layout is the reference's default
    assert ServeEngine(params, cfg, max_slots=2,
                       cache_len=16).kv_layout == "replicated"


def test_serve_with_plan_example_runs():
    from repro_torch.examples import serve_with_plan

    out = serve_with_plan.main(["--device", "cpu", "--steps", "10"])
    assert out["metrics"]["completed"] == 6
    assert out["engine"].kv_layout == out["plan"].kv_layout
    assert np.isfinite(out["metrics"]["tokens_per_s"])
