"""The port's copies of DisCo's search against the reference, on the CPU:
the cluster cost models, the fusion IR and its mutations, the cost
substrate, the event simulator, the backtracking search and the Plan
artifact.  Graphs are carried from the reference into the port by copying
each ``PrimOp``'s fields and the edges; both packages then apply the same
seeded mutations.

Every comparison prices under ``TPU_V5E`` in both packages (the port's
default ``hw`` is ``H100_SXM``).  Costs, best costs and Plans are held
bit-identical where no two ready groups tie on their min pid: mutation
draws without duplicate fusion.  With duplicate fusion the port breaks
such ties by content (ROADMAP C1), so its Plan round trip is exact on the
draws where the reference's is not.
"""
import dataclasses
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.cluster as RC  # noqa: E402
import repro.core as RCO  # noqa: E402
import repro.plan as RP  # noqa: E402
from repro.core import costs as RCOSTS  # noqa: E402
from repro.core.events import BackgroundTraffic as RBackground  # noqa: E402

import repro_torch.cluster as PC  # noqa: E402
import repro_torch.core as PCO  # noqa: E402
import repro_torch.plan as PP  # noqa: E402
from repro_torch.core import costs as PCOSTS  # noqa: E402
from repro_torch.core.events import BackgroundTraffic as PBackground  # noqa: E402
from repro_torch.distributed import train_step as PTS  # noqa: E402

SPEC = "a100_nvlink_ib"
NO_DUP = tuple(m for m in RCO.ALL_METHODS if m != RCO.METHOD_DUP)
# ROADMAP C1: draws (seed, n_mut) whose reference round trip prices a
# rebuilt graph differently
C1_DRAWS = ((8211, 13), (79, 14), (616, 16), (815, 15), (7474, 10))
# seeded mutation draws without duplicate fusion
DRAWS = ((0, 4), (1, 8), (2, 12), (3, 16), (5, 20), (8, 24))


def chain_graph(M, n=16, grads=(3, 6, 9, 12), grad_bytes=float(1 << 20)):
    """A chain of ``n`` EW prims with gradients at ``grads``, profiled
    under TPU_V5E (the round-trip tests' graph)."""
    prims = [M.PrimOp(
        pid=i, op_type="mul", category=M.EW, flops=100.0, in_bytes=64.0,
        out_bytes=64.0, time=1e-6,
        grad_param=list(grads).index(i) if i in grads else -1,
        grad_bytes=grad_bytes if i in grads else 0.0,
        grad_sig="f32" if i in grads else "") for i in range(n)]
    return M.profile_graph(
        M.FusionGraph(prims, [(i, i + 1) for i in range(n - 1)]),
        M.TPU_V5E)


def to_port(g):
    """An unfused reference FusionGraph as a port FusionGraph: each prim's
    fields and the edges, copied.  The edge sets are copied as sets, so
    they iterate in the same order, and seeded mutations draw the same
    neighbours in both packages."""
    prims = [PCO.PrimOp(**dataclasses.asdict(p)) for p in g.prims]
    return PCO.FusionGraph._from_parts(
        prims, [set(s) for s in g.psuccs], [set(s) for s in g.ppreds],
        g.groups, g.provider, g._next_gid, g.grad_prim, g.buckets)


def mutated(M, base, seed, n_mut, methods=None):
    rng = random.Random(seed)
    g = base.clone()
    for _ in range(n_mut):
        M.random_apply(g, rng.choice(methods or M.ALL_METHODS), 1, rng)
    return g


def simulators(kind):
    """The same pricing configuration in (reference, port)."""
    out = []
    for M, C, BG in ((RCO, RC, RBackground), (PCO, PC, PBackground)):
        kw = {"hw": M.TPU_V5E, "cluster": C.get_preset(SPEC)}
        if kind == "streams4":
            kw["streams"] = 4
        elif kind == "background":
            kw.update(streams=2, background=(BG("tp", 1 << 16, 1e-4),))
        out.append(M.Simulator(**kw))
    return out


@pytest.fixture(scope="module")
def tinyllama():
    """Reduced tinyllama's step as the JAX package traces it, profiled
    under TPU_V5E, in (reference, port)."""
    g = RP.trace_model_graph("tinyllama-1.1b", reduced=True,
                             hw=RCO.TPU_V5E)
    return g, to_port(g)


# ------------------------------------------------------------------ cluster
@pytest.mark.parametrize("preset", RC.list_presets())
def test_comm_time_matches_reference(preset):
    assert PC.list_presets() == RC.list_presets()
    rspec, pspec = RC.get_preset(preset), PC.get_preset(preset)
    for kind in RC.BUCKET_COMM_KINDS:
        for algo in RC.COLLECTIVE_ALGOS:
            for nb in (1.0, 4096.0, 3.7e6, 2.2e9):
                assert (PC.comm_time(nb, pspec, algo, kind)
                        == RC.comm_time(nb, rspec, algo, kind))


def test_h100_hardware_value():
    hw = PCO.H100_SXM
    assert (hw.name, hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.vmem_bytes,
            hw.mxu_dim, hw.launch_overhead) == (
        "h100-sxm", 989e12, 3.35e12, 450e9, 50 * 2**20, 64, 5e-6)
    assert hw.allreduce_latency == RCO.TPU_V5E.allreduce_latency
    assert hw.efficiency == RCO.TPU_V5E.efficiency
    assert dataclasses.asdict(PCO.TPU_V5E) == dataclasses.asdict(
        RCO.TPU_V5E)
    # every default hw of the port is the H100
    g = to_port(chain_graph(RCO))
    assert PCO.Simulator().hw == PCO.H100_SXM
    assert PCO.OracleEstimator().hw == PCO.H100_SXM
    assert (PCO.prim_time(g.prims[0])
            == PCO.prim_time(g.prims[0], PCO.H100_SXM))


# ------------------------------------------------------- graph, mutations
@pytest.mark.parametrize("seed,n_mut", DRAWS + C1_DRAWS)
def test_mutations_give_equal_signatures(seed, n_mut):
    rbase = chain_graph(RCO)
    pbase = to_port(rbase)
    rg = mutated(RCO, rbase, seed, n_mut)
    pg = mutated(PCO, pbase, seed, n_mut)
    assert pg.fast_signature() == rg.fast_signature()
    assert pg.signature() == rg.signature()


def test_prim_and_fused_times_match_reference(tinyllama):
    rg, pg = tinyllama
    for rp, pp in zip(rg.prims, pg.prims):
        assert (PCO.prim_time(pp, PCO.TPU_V5E)
                == RCO.prim_time(rp, RCO.TPU_V5E))
    rm = mutated(RCO, rg, 3, 40, NO_DUP)
    pm = mutated(PCO, pg, 3, 40, NO_DUP)
    assert pm.groups == rm.groups
    for gid in rm.groups:
        assert (PCO.group_time_oracle(pm, gid, PCO.TPU_V5E)
                == RCO.group_time_oracle(rm, gid, RCO.TPU_V5E))
        members = [rm.prims[p] for p in rm.groups[gid]]
        in_b, out_b = rm.group_external_io(gid)
        assert (PCOSTS.fused_time_oracle(
            [pm.prims[p] for p in pm.groups[gid]], in_b, out_b,
            PCO.TPU_V5E)
            == RCOSTS.fused_time_oracle(members, in_b, out_b, RCO.TPU_V5E))


# --------------------------------------------------------------- simulator
@pytest.mark.parametrize("kind", ["streams1", "streams4", "background"])
@pytest.mark.parametrize("seed,n_mut", DRAWS)
def test_simulator_cost_is_bit_identical(kind, seed, n_mut, tinyllama):
    rsim, psim = simulators(kind)
    rbase = chain_graph(RCO)
    for rb, pb in ((rbase, to_port(rbase)), tinyllama):
        rg = mutated(RCO, rb, seed, n_mut, NO_DUP)
        pg = mutated(PCO, pb, seed, n_mut, NO_DUP)
        assert psim.cost(pg) == rsim.cost(rg)
        assert (dataclasses.asdict(psim.run(pg))
                == dataclasses.asdict(rsim.run(rg)))


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("kind", ["streams1", "streams4", "background"])
@pytest.mark.parametrize("graph", ["chain", "tinyllama"])
def test_search_without_dup_matches_reference(kind, graph, tinyllama):
    rsim, psim = simulators(kind)
    if graph == "chain":
        rg = chain_graph(RCO)
        pg = to_port(rg)
    else:
        rg, pg = tinyllama
    kw = dict(methods=NO_DUP, unchanged_limit=30, max_steps=60, seed=4)
    rres = RCO.backtracking_search(rg, rsim, **kw)
    pres = PCO.backtracking_search(pg, psim, **kw)
    assert pres.best_cost == rres.best_cost
    assert pres.initial_cost == rres.initial_cost
    assert pres.simulations == rres.simulations
    rplan = RP.Plan.from_graph(rres.best, sim=rsim,
                               predicted=rres.best_cost)
    pplan = PP.Plan.from_graph(pres.best, sim=psim,
                               predicted=pres.best_cost)
    assert pplan._to_json() == rplan._to_json()


# --------------------------------------------------------------------- C1
@pytest.mark.parametrize("kind", ["streams4", "background"])
@pytest.mark.parametrize("seed,n_mut", C1_DRAWS)
def test_plan_round_trip_is_exact_with_dup(kind, seed, n_mut, tmp_path):
    _, sim = simulators(kind)
    base = to_port(chain_graph(RCO))
    g = mutated(PCO, base, seed, n_mut)
    plan = PP.Plan.from_graph(g, sim=sim)
    rebuilt = plan.to_graph(base)
    assert rebuilt.fast_signature() == g.fast_signature()
    assert sim.cost(rebuilt) == sim.cost(g) == plan.predicted_iteration_time
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = PP.Plan.load(path)
    assert loaded == plan
    assert loaded.simulator().cost(loaded.to_graph(base)) == \
        plan.predicted_iteration_time


# -------------------------------------------------------------- artifacts
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_json_loads_in_the_other_package(writer, tinyllama, tmp_path):
    rg, pg = tinyllama
    rsim, psim = simulators("streams4")
    rres = RCO.backtracking_search(rg, rsim, unchanged_limit=20,
                                   max_steps=40, seed=1)
    pres = PCO.backtracking_search(pg, psim, unchanged_limit=20,
                                   max_steps=40, seed=1)
    rplan = RP.Plan.from_graph(rres.best, sim=rsim, predicted=rres.best_cost)
    pplan = PP.Plan.from_graph(pres.best, sim=psim, predicted=pres.best_cost)
    path = str(tmp_path / "plan.json")
    if writer == "reference":
        rplan.save(path)
        other, mine = PP.Plan.load(path), rplan
    else:
        pplan.save(path)
        other, mine = RP.Plan.load(path), pplan
    assert other._to_json() == mine._to_json()
    # twelve leaves, as reduced tinyllama has
    params = [np.zeros(1, np.float32) for _ in range(12)]
    want = dataclasses.asdict(RP.Plan.load(path).grad_sync(params))
    assert dataclasses.asdict(PP.Plan.load(path).grad_sync(params)) == want
    assert dataclasses.asdict(
        PTS.GradSyncStrategy.load(path, params=params)) == want


def test_compile_cache_hits(tinyllama, tmp_path):
    """``compile(cache=)`` stores the cold Plan and replays it on the
    second call (``tests/test_torch_plan_cache.py`` holds the cache)."""
    kw = dict(graph=tinyllama[1], cluster=SPEC, streams=4, hw=PCO.TPU_V5E,
              unchanged_limit=10, max_steps=10, cache=str(tmp_path))
    cold = PP.compile(**kw)
    hit = PP.compile(**kw)
    assert cold.provenance["cache"]["outcome"] == "cold"
    assert hit.provenance["cache"]["outcome"] == "hit"
    assert hit == cold


# ---------------------------------------------------------------- baselines
@pytest.mark.parametrize("name", sorted(RCO.BASELINES))
def test_baseline_strategies_match_reference(name, tinyllama):
    rg, pg = tinyllama
    assert sorted(PCO.BASELINES) == sorted(RCO.BASELINES)
    rb, pb = RCO.BASELINES[name](rg), PCO.BASELINES[name](pg)
    assert pb.signature() == rb.signature()
    assert pb.fast_signature() == rb.fast_signature()


@pytest.mark.parametrize("kind", ["flat", "streams1", "streams4"])
def test_evaluate_baselines_is_bit_identical(kind, tinyllama):
    if kind == "flat":
        rsim = RCO.Simulator(hw=RCO.TPU_V5E, n_devices=64)
        psim = PCO.Simulator(hw=PCO.TPU_V5E, n_devices=64)
    else:
        rsim, psim = simulators(kind)
    rg, pg = tinyllama
    want = RCO.evaluate_baselines(rg, rsim)
    assert PCO.evaluate_baselines(pg, psim) == want
    assert len(want) == (6 if kind == "flat" else 11)


def test_worker_pool_search_matches_serial(tinyllama):
    """The process-pool path (``workers=``) gives the serial search's
    result in the port."""
    _, psim = simulators("streams4")
    kw = dict(unchanged_limit=10, max_steps=20, seed=2)
    serial = PCO.backtracking_search(tinyllama[1], psim, **kw)
    _, psim2 = simulators("streams4")
    pooled = PCO.backtracking_search(tinyllama[1], psim2, workers=2, **kw)
    assert pooled.best_cost == serial.best_cost
    assert pooled.best.fast_signature() == serial.best.fast_signature()
