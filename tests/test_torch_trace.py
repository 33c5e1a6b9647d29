"""The port's tracer against the reference's, on the CPU: ``make_fx`` of
the stacked model's loss and gradients on meta tensors, turned into a
``FusionGraph``, held to the reference's ``trace_model_graph`` on reduced
tinyllama (2 layers) and a 3-layer variant; its size at full width; the
search end to end; and the launcher's ``--strategy auto``."""
import dataclasses
import math

import jax
import pytest

torch = pytest.importorskip("torch")

import repro.plan as RP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import trace as RTRACE  # noqa: E402
from repro.data.pipeline import materialize_batch  # noqa: E402
from repro.models import stacked as JST  # noqa: E402

import repro_torch.plan as PP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import OPAQUE, DOT, trace as PTRACE  # noqa: E402
from repro_torch.distributed import train_step as PTS  # noqa: E402
from repro_torch.models import regions as REGIONS  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

BATCH, SEQ = 8, 64          # trace_model_graph's defaults in both packages
# Full tinyllama-1.1b at batch 4 x 2048 traces to 61 prims (the reference's
# reduced graph has 107).  Without the scan collapse it would be over 7000.
FULL_WIDTH_MAX_PRIMS = 200


def _cfgs(n_layers):
    rcfg, pcfg = (jax_config("tinyllama-1.1b").reduced(),
                  get_config("tinyllama-1.1b").reduced())
    return (dataclasses.replace(rcfg, n_layers=n_layers),
            dataclasses.replace(pcfg, n_layers=n_layers))


def _ref_dot_flops(jaxpr) -> float:
    """dot_general FLOPs of a jaxpr, through every sub-jaxpr, a scan's
    body counted once per trip."""
    total = 0.0
    for eqn in jaxpr.eqns:
        sub = RTRACE._find_subjaxpr(eqn)
        if sub is not None:
            trips = (float(eqn.params["length"])
                     if eqn.primitive.name == "scan" else 1.0)
            total += trips * _ref_dot_flops(sub)
        elif eqn.primitive.name == "dot_general":
            total += RTRACE._dot_flops(eqn)
    return total


def _markers(g) -> list:
    """Per leaf, in leaf order: (grad_bytes, grad_sig, marked on a
    grad_identity prim)."""
    out = []
    for gi in range(len(g.grad_prim)):
        p = g.prims[g.grad_prim[gi]]
        out.append((p.grad_bytes, p.grad_sig, p.op_type == "grad_identity"))
    return out


@pytest.fixture(scope="module", params=[2, 3])
def traced(request):
    rcfg, pcfg = _cfgs(request.param)
    ref = RP.trace_model_graph(rcfg, batch=BATCH, seq=SEQ, reduced=False)
    port = PP.trace_model_graph(pcfg, batch=BATCH, seq=SEQ, reduced=False)
    return rcfg, pcfg, ref, port


def test_gradient_markers_match_reference(traced):
    _, _, ref, port = traced
    assert len(port.grad_prim) == len(ref.grad_prim) == 12
    assert _markers(port) == _markers(ref)
    assert {p.grad_sig for p in port.prims if p.grad_param >= 0} == \
        {"float32"}


def test_dot_flops_match_reference(traced):
    rcfg, pcfg, _, port = traced
    params = JST.init_params(jax.random.PRNGKey(0), rcfg)
    data = materialize_batch(rcfg, BATCH, SEQ, seed=0)
    closed = jax.make_jaxpr(
        jax.grad(lambda p, b: JST.loss_fn(p, rcfg, b)))(params, data)
    want = _ref_dot_flops(closed.jaxpr)
    with torch.device("meta"):
        meta = ST.init_params(pcfg, device="meta")
    tokens = torch.zeros((BATCH, SEQ), dtype=torch.int64, device="meta")
    # the same trace with no region collapsed: every aten op a prim
    gm, _ = PTRACE.trace_fx(lambda p, b: ST.loss_fn(p, pcfg, b), meta,
                            {"tokens": tokens})
    flat = PTRACE.graph_from_fx(gm, [], *PTRACE.grad_markers(meta))
    got = sum(p.flops for p in flat.prims if p.category == DOT)
    assert math.isclose(got, want, rel_tol=1e-9)
    # the collapse keeps every FLOP: a scan prim is the sum of its members
    assert math.isclose(sum(p.flops for p in port.prims),
                        sum(p.flops for p in flat.prims), rel_tol=1e-12)


def test_opaque_prims_only_where_the_reference_scans(traced):
    _, _, ref, port = traced
    scans = [p for p in ref.prims if p.op_type == "scan"]
    opaque = [p for p in port.prims if p.category == OPAQUE]
    assert len(opaque) == len(scans) == 4
    assert {p.op_type for p in opaque} == {"scan"}
    # the reference's other OPAQUE prims are its uninlined ``jit`` calls
    # (ROADMAP C11) and ``scatter-add``, which its LAYOUT set names
    # ``scatter_add``
    assert {p.op_type for p in ref.prims if p.category == OPAQUE} <= \
        {"scan", "jit", "scatter-add"}
    # each scan prices what the reference's does, within the few ops the
    # two models place on either side of the loop (rope tables, casts)
    for r, p in zip(sorted(scans, key=lambda p: p.flops),
                    sorted(opaque, key=lambda p: p.flops)):
        assert math.isclose(p.flops, r.flops, rel_tol=1e-2)


def test_graph_is_acyclic(traced):
    port = traced[3]
    order = port.topo_groups()
    assert sorted(order) == sorted(port.groups)


def test_full_width_trace_stays_small():
    g = PP.trace_model_graph("tinyllama-1.1b", batch=4, seq=2048,
                             reduced=False)
    assert len(g.prims) <= FULL_WIDTH_MAX_PRIMS
    assert sum(p.category == OPAQUE for p in g.prims) == 4
    assert len(g.grad_prim) == 12
    leaves = ST.leaves(_meta(get_config("tinyllama-1.1b")))
    assert [g.prims[g.grad_prim[i]].grad_bytes for i in range(12)] == \
        [float(l.numel() * l.element_size()) for l in leaves]
    assert {g.prims[g.grad_prim[i]].grad_sig for i in range(12)} == \
        {"bfloat16", "float32"}
    assert sorted(g.topo_groups()) == sorted(g.groups)
    assert all(p.time > 0 for p in g.prims)     # profiled for the H100


def _meta(cfg):
    with torch.device("meta"):
        return ST.init_params(cfg, device="meta")


def test_compile_searches_a_traced_graph():
    g = PP.trace_model_graph("tinyllama-1.1b")
    plan = PP.compile(graph=g, cluster="h100_superpod", unchanged_limit=20)
    prov = plan.provenance
    assert prov["best_cost"] <= prov["initial_cost"]
    assert plan.predicted_iteration_time == prov["best_cost"]
    assert sorted(i for b in plan.buckets for i in b) == list(range(12))
    assert plan.simulator().cost(plan.to_graph(g)) == prov["best_cost"]


def test_scan_region_outside_a_trace_changes_nothing():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = ST.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16))
    with REGIONS.scan_region():
        a = ST.loss_fn(params, cfg, {"tokens": tokens})
    b = ST.loss_fn(params, cfg, {"tokens": tokens})
    assert torch.equal(a, b)
    assert REGIONS.RECORDER.get() is None


def test_launcher_searches_and_enacts(tmp_path):
    """``--strategy auto`` on the CPU: the search prices the traced step on
    ``h100_superpod``, the Plan is saved and loads back, and training
    through its buckets gives finite losses."""
    from repro_torch.launch import train as TRAIN

    path = str(tmp_path / "plan.json")
    out = TRAIN.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                      "2", "--batch", "4", "--seq", "64", "--device", "cpu",
                      "--strategy", "auto", "--cluster", "h100_superpod",
                      "--plan-out", path, "--log-every", "100"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(l) for l in out["losses"])
    plan = PP.Plan.load(path)
    assert plan == out["plan"]
    prov = out["plan"].provenance
    assert prov["trace"]["by_category"]["opaque"] == 4
    assert 0 < prov["compute_time"]["best"] <= prov["compute_time"]["initial"]
    params = _meta(get_config("tinyllama-1.1b").reduced())
    assert dataclasses.asdict(PTS.GradSyncStrategy.load(path, params)) == \
        dataclasses.asdict(plan.grad_sync(params))
    # the reference reads the port's Plan
    assert RP.Plan.load(path).buckets == plan.buckets
    with pytest.raises(SystemExit):
        TRAIN.parse_args(["--plan-out", path])      # needs --strategy auto
