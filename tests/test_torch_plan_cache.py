"""The port's plan cache (``repro_torch.plan.cache``) against the
reference's, on the CPU: digests and keys equal for oracle-priced graphs,
exact hits bit-identical to cold compiles (also on ROADMAP C1's cache
seeds, where the reference's are not), warm starts, one cache directory
read by both packages, the CLI, and a serving-plan entry that the port
cannot load but neither counts corrupt nor drops.

Every compile prices under ``TPU_V5E`` in both packages (the port's
default ``hw`` is ``H100_SXM``).
"""
import json
import os

import pytest

pytest.importorskip("torch")

import repro.core as RCO  # noqa: E402
import repro.plan as RP  # noqa: E402
from repro.plan import cache as RCACHE  # noqa: E402

import repro_torch.cluster as PC  # noqa: E402
import repro_torch.core as PCO  # noqa: E402
import repro_torch.plan as PP  # noqa: E402
from repro_torch.plan import cache as PCACHE  # noqa: E402

from test_torch_search import (DRAWS, NO_DUP, chain_graph, mutated,  # noqa: E402
                               simulators, to_port)

SPEC, OTHER = "a100_nvlink_ib", "h100_superpod"
KNOBS = dict(unchanged_limit=25, max_steps=20)
# ROADMAP C1: cache seeds whose reference hit prices differently from cold
C1_SEEDS = (112, 114, 117, 296)


def port_chain():
    return to_port(chain_graph(RCO))


def strategy_json(plan) -> dict:
    """A Plan's JSON without its provenance (the cache outcome and wall
    times differ between a cold compile and its hit)."""
    d = plan._to_json()
    d.pop("provenance")
    return d


def compile_both(rg, pg, d, seed, **kw):
    """The same compile point, cached in ``d``, in (reference, port)."""
    args = dict(cluster=SPEC, streams=4, seed=seed, hw=RCO.TPU_V5E, **KNOBS)
    rplan = RP.compile_plan(graph=rg, cache=d, **args, **kw)
    args["hw"] = PCO.TPU_V5E
    pplan = PP.compile_plan(graph=pg, cache=d, **args, **kw)
    return rplan, pplan


@pytest.mark.parametrize("kind", ["streams1", "streams4", "background"])
@pytest.mark.parametrize("seed,n_mut", DRAWS)
def test_digests_and_keys_match_reference(kind, seed, n_mut, tinyllama):
    rsim, psim = simulators(kind)
    rbase = chain_graph(RCO)
    knobs = dict(alpha=1.05, beta=10, unchanged_limit=25, max_steps=20,
                 methods=None, seed=seed)
    assert PCACHE.knob_digest(**knobs) == RCACHE.knob_digest(**knobs)
    for rb, pb in ((rbase, to_port(rbase)), tinyllama):
        rg = mutated(RCO, rb, seed, n_mut, NO_DUP)
        pg = mutated(PCO, pb, seed, n_mut, NO_DUP)
        assert PCACHE.graph_digest(pg) == RCACHE.graph_digest(rg)
        kd = RCACHE.knob_digest(**knobs)
        assert (PCACHE.compile_key(pg, psim, kd)
                == RCACHE.compile_key(rg, rsim, kd))
        assert (PCACHE.cache_features(pg, psim, arch="a", knobs=kd)
                == RCACHE.cache_features(rg, rsim, arch="a", knobs=kd))


@pytest.mark.parametrize("seed", (0, 7) + C1_SEEDS)
def test_exact_hit_is_bit_identical_to_cold(seed, tmp_path):
    g0 = port_chain()
    sim = PCO.Simulator(cluster=PC.get_preset(SPEC), streams=4,
                        hw=PCO.TPU_V5E)
    cache = PP.PlanCache(str(tmp_path))
    kw = dict(graph=g0, cluster=SPEC, streams=4, seed=seed, cache=cache,
              hw=PCO.TPU_V5E, **KNOBS)
    cold = PP.compile_plan(**kw)
    assert cold.provenance["cache"]["outcome"] == "cold"
    hit = PP.compile_plan(**kw)
    assert hit.provenance["cache"]["outcome"] == "hit"
    assert hit == cold
    assert hit.fingerprint() == cold.fingerprint()
    assert hit.strategy_fingerprint() == cold.strategy_fingerprint()
    g_hit, g_cold = hit.to_graph(g0), cold.to_graph(g0)
    assert g_hit.fast_signature() == g_cold.fast_signature()
    # the port's content tie-break prices the replay as the search did
    assert sim.cost(g_hit) == sim.cost(g_cold) \
        == cold.predicted_iteration_time
    assert cache.stats["hits"] == 1


@pytest.mark.parametrize("seed", (3, 11, 112))
def test_warm_start_from_another_cluster(seed, tmp_path):
    g0 = port_chain()
    cache = PP.PlanCache(str(tmp_path))
    kw = dict(graph=g0, streams=4, seed=seed, cache=cache, hw=PCO.TPU_V5E,
              **KNOBS)
    PP.compile_plan(cluster=SPEC, **kw)
    warm = PP.compile_plan(cluster=OTHER, **kw)
    prov = warm.provenance["cache"]
    assert prov["outcome"] in ("warm", "cold")
    if prov["outcome"] == "warm":
        assert warm.predicted_iteration_time <= prov["warm_start_cost"]
        assert prov["warm_start_cost"] < PCO.Simulator(
            cluster=PC.get_preset(OTHER), streams=4,
            hw=PCO.TPU_V5E).cost(g0)
        assert cache.stats["warm_starts"] == 1
    assert len(cache) == 2


def test_warm_start_state_matches_reference():
    """The re-applied strategy resets what a sim cannot price, as the
    reference's does, and a plan of another trace family gives None."""
    rg0 = chain_graph(RCO)
    pg0 = to_port(rg0)
    rich_r, rich_p = mutated(RCO, rg0, 5, 14), mutated(PCO, pg0, 5, 14)
    rsim4, psim4 = simulators("streams4")
    rplan = RP.Plan.from_graph(rich_r, sim=rsim4)
    pplan = PP.Plan.from_graph(rich_p, sim=psim4)
    for streams in (1, 4):
        rs = RCO.Simulator(cluster=rsim4.cluster, streams=streams)
        ps = PCO.Simulator(cluster=psim4.cluster, streams=streams)
        rw = RCACHE.warm_start_state(rplan, rg0, rs)
        pw = PCACHE.warm_start_state(pplan, pg0, ps)
        assert pw.signature() == rw.signature()
        assert pw.fast_signature() == rw.fast_signature()
    other = to_port(chain_graph(RCO, n=20, grads=(3, 7)))
    assert PCACHE.warm_start_state(pplan, other, psim4) is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_cache_serves_both_packages(writer, tmp_path):
    """A plan compiled into a directory by one package is the other's
    exact hit, with the same JSON."""
    rg0 = mutated(RCO, chain_graph(RCO), 2, 6, NO_DUP)
    pg0 = mutated(PCO, port_chain(), 2, 6, NO_DUP)
    d = str(tmp_path)
    if writer == "reference":
        rplan, pplan = compile_both(rg0, pg0, d, seed=1)
        first, second = rplan, pplan
    else:
        args = dict(cluster=SPEC, streams=4, seed=1, **KNOBS)
        first = PP.compile_plan(graph=pg0, cache=d, hw=PCO.TPU_V5E, **args)
        second = RP.compile_plan(graph=rg0, cache=d, hw=RCO.TPU_V5E, **args)
    assert first.provenance["cache"]["outcome"] == "cold"
    assert second.provenance["cache"]["outcome"] == "hit"
    assert second.provenance["cache"]["key"] \
        == first.provenance["cache"]["key"]
    assert strategy_json(second) == strategy_json(first)
    assert (second.provenance["simulations"]
            == first.provenance["simulations"])
    key = first.provenance["cache"]["key"]
    assert RP.PlanCache(d).get(key)._to_json() \
        == PP.PlanCache(d).get(key)._to_json()


def test_cache_cli_ls_stats_prune_verify(tmp_path, capsys):
    d = str(tmp_path)
    cache = PP.PlanCache(d)
    g0 = port_chain()
    sim = PCO.Simulator(cluster=PC.get_preset(SPEC), streams=4)
    cache.put("a", PP.Plan.from_graph(mutated(PCO, g0, 0, 6), sim=sim),
              PCACHE.cache_features(g0, sim, arch="chain"))
    cache.put("b", PP.Plan.from_graph(mutated(PCO, g0, 1, 6), sim=sim))
    assert PCACHE.main(["ls", "--dir", d]) == 0
    assert "2 entries" in capsys.readouterr().out
    assert PCACHE.main(["stats", "--dir", d]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 2
    assert PCACHE.main(["verify", "--dir", d]) == 0
    capsys.readouterr()
    open(cache._plan_path("b"), "w").write("{torn")
    assert PCACHE.main(["verify", "--dir", d]) == 1
    capsys.readouterr()
    assert PCACHE.main(["prune", "--dir", d]) == 0
    assert "dropped 1" in capsys.readouterr().out
    assert PCACHE.main(["prune", "--dir", d, "--max-entries", "0"]) == 0
    assert len(PP.PlanCache(d)) == 0


def test_truncated_entry_is_a_miss_and_index_rebuilds(tmp_path):
    cache = PP.PlanCache(str(tmp_path))
    g0 = port_chain()
    sim = PCO.Simulator(cluster=PC.get_preset(SPEC), streams=4)
    plan = PP.Plan.from_graph(mutated(PCO, g0, 3, 8), sim=sim)
    cache.put("k1", plan, PCACHE.cache_features(g0, sim, arch="chain"))
    cache.put("k2", plan)
    path = cache._plan_path("k2")
    blob = open(path).read()
    open(path, "w").write(blob[:len(blob) // 2])  # torn write
    assert cache.get("k2") is None
    assert cache.stats["stale"] == 1 and cache.stats["misses"] == 1
    assert [c["key"] for c in cache.verify()["corrupt"]] == ["k2"]
    assert cache.prune()["dropped"] == ["k2"]
    assert not os.path.exists(path)
    open(cache._index_path(), "w").write("{torn")
    fresh = PP.PlanCache(str(tmp_path))
    ents = fresh.entries()
    assert [e["key"] for e in ents] == ["k1"]
    assert ents[0]["arch"] == "chain"
    assert fresh.get("k1") == plan


def test_serving_entry_raises_and_is_kept(tmp_path):
    """A serving-plan entry (written by the reference's serving search,
    which the port has not ported) raises its own error on ``get``; it is
    not corruption, so ``verify`` lists it apart and ``prune`` keeps it,
    and the warm-start ladder skips it."""
    d = str(tmp_path)
    cache = PP.PlanCache(d)
    g0 = port_chain()
    sim = PCO.Simulator(cluster=PC.get_preset(SPEC), streams=4)
    cache.put("train", PP.Plan.from_graph(mutated(PCO, g0, 0, 6), sim=sim),
              PCACHE.cache_features(g0, sim, arch="chain"))
    doc = {"schema": "repro.serving_plan", "version": 1,
           "predicted_tokens_per_s": 250.0,
           "provenance": {"cache_features": {"arch": "chain"}}}
    with open(cache._plan_path("serve"), "w") as f:
        json.dump(doc, f)
    index = json.load(open(cache._index_path()))
    index["entries"]["serve"] = {"key": "serve", "created": 1.0,
                                 "arch": "chain"}
    json.dump(index, open(cache._index_path(), "w"))

    with pytest.raises(PP.ServingPlanNotPorted, match="serving plan"):
        cache.get("serve")
    assert not isinstance(PP.ServingPlanNotPorted("x"), PP.PlanError)
    assert cache.stats["stale"] == 0
    rep = cache.verify()
    assert rep["serving"] == ["serve"] and rep["corrupt"] == []
    assert cache.prune()["dropped"] == []
    assert os.path.exists(cache._plan_path("serve"))
    near = cache.nearest(PCACHE.cache_features(g0, sim, arch="chain"))
    assert [e["key"] for _, e, _ in near] == ["train"]
    # an index rebuilt from the files keeps it too
    os.remove(cache._index_path())
    rebuilt = {e["key"]: e for e in PP.PlanCache(d).entries()}
    assert sorted(rebuilt) == ["serve", "train"]
    assert rebuilt["serve"]["predicted_s"] == 1.0 / 250.0
    assert rebuilt["serve"]["arch"] == "chain"


@pytest.fixture(scope="module")
def tinyllama():
    g = RP.trace_model_graph("tinyllama-1.1b", reduced=True,
                             hw=RCO.TPU_V5E)
    return g, to_port(g)
