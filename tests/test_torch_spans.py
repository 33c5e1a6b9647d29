"""The port's spans (``repro_torch.spans``) and its collective bytes
counter: one train step of a tiny dense and a tiny MoE model, remat on and
off, under ``torch.profiler`` in a one-rank gloo group, read back from the
exported Chrome trace."""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

PHASES = ["step.fwd", "step.bwd", "step.sync", "step.clip", "step.update"]
REGIONS = ("model.attn", "model.ffn", "model.io")


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: entered.append(name))
    a, b = spans.span("step.fwd"), spans.span("model.attn")
    assert a is b is spans._OFF
    with a:
        pass
    assert entered == []


def test_span_opens_a_range_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("step.fwd"):
            torch.ones(2).sum()
    assert "step.fwd" in {e.key for e in prof.key_averages()}


def _strategy(params, comm, chunks=1):
    base = TS.GradSyncStrategy.size_capped(params, 1 << 16)
    nb = len(base.buckets)
    return TS.GradSyncStrategy(base.buckets, comms=[comm] * nb,
                               chunks=[chunks] * nb)


def _one_step(arch, remat, strat=None, comm="ar"):
    cfg = get_config(arch).reduced()
    params = ST.init_params(cfg, seed=0, device="cpu")
    strat = strat or _strategy(params, comm)
    init, update = adamw(1e-3, weight_decay=0.01)
    step = TS.build_train_step(cfg, strategy=strat, remat=remat,
                               optimizer=(init, update))
    opt = init(T.leaves(params))
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    return step, params, opt, {"tokens": tokens}, strat


def _trace(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _inside(e, s):
    return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b"],
                         ids=["dense", "moe"])
def test_step_spans(one_rank_group, tmp_path, arch, remat):
    step, params, opt, batch, strat = _one_step(arch, remat)
    ev = _trace(tmp_path, lambda: step(params, opt, batch))
    ua = [e for e in ev if e.get("ph") == "X"
          and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in ua:
        by_name.setdefault(e["name"], []).append(e)
    assert set(PHASES + ["sync.bucket", *REGIONS]) <= set(by_name)
    order = sorted((e for e in ua if e["name"] in PHASES),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in order] == PHASES
    (sync,) = by_name["step.sync"]
    buckets = by_name["sync.bucket"]
    assert len(buckets) == len(strat.buckets)
    assert all(_inside(b, sync) for b in buckets)
    # every aten op of the forward lies in exactly one model region
    (fwd,) = by_name["step.fwd"]
    models = [e for e in ua if e["name"] in REGIONS]
    aten = [e for e in ev if e.get("ph") == "X" and e.get("cat") == "cpu_op"
            and e["name"].startswith("aten::") and _inside(e, fwd)]
    assert aten
    for e in aten:
        assert len({m["name"] for m in models if m["tid"] == e["tid"]
                    and _inside(e, m)}) == 1, e["name"]
    # remat's recompute opens a block's spans again inside the backward (a
    # cross-entropy chunk's recompute is tied to model.io through the node
    # that recomputes it)
    (bwd,) = by_name["step.bwd"]
    again = {m["name"] for m in models if _inside(m, bwd)}
    assert again == ({"model.attn", "model.ffn"} if remat else set())


@pytest.mark.parametrize("comm", ["ar", "rs_ag"])
def test_collective_bytes(one_rank_group, comm):
    step, params, opt, batch, strat = _one_step("tinyllama-1.1b", False,
                                                comm=comm)
    leaves = T.leaves(params)
    f32 = sum(4 * sum(leaves[i].numel() for i in b) for b in strat.buckets)
    TS.reset_collectives()
    step(params, opt, batch)
    want = ({"all_reduce": f32, "reduce_scatter": 0, "all_gather": 0}
            if comm == "ar" else
            {"all_reduce": 0, "reduce_scatter": f32, "all_gather": f32})
    assert TS.COLLECTIVE_BYTES == want
    TS.reset_collectives()
    assert set(TS.COLLECTIVE_BYTES.values()) == {0}
