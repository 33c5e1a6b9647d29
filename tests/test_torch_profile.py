"""The port's profiler (``repro_torch.core.profile``) against the
reference's ``repro/core/profile_cpu.py``, on the CPU: tier A samples
equal, tier B's synthetic fused ops drawn and computed as the reference's,
two of them compiled and timed, and ``calibrate_hw`` on the CPU.
Nothing here measures the card."""
import math
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import repro.core as RCO  # noqa: E402
from repro.core import profile_cpu as RPROF  # noqa: E402
from repro.plan import trace_model_graph  # noqa: E402

import repro_torch.core as PCO  # noqa: E402
from repro_torch.core import gnn as PG  # noqa: E402
from repro_torch.core import profile as PPROF  # noqa: E402

from test_torch_search import to_port  # noqa: E402


@pytest.fixture(scope="module")
def tinyllama():
    g = trace_model_graph("tinyllama-1.1b", reduced=True, hw=RCO.TPU_V5E)
    return g, to_port(g)


@pytest.mark.parametrize("seed", [0, 1])
def test_tier_a_samples_match_reference(seed, tinyllama):
    """Features bitwise and oracle labels exactly, under TPU_V5E."""
    rs = RPROF.sample_fused_groups(tinyllama[0], 60, random.Random(seed),
                                   max_members=16, hw=RCO.TPU_V5E)
    ps = PPROF.sample_fused_groups(tinyllama[1], 60, random.Random(seed),
                                   max_members=16, hw=PCO.TPU_V5E)
    assert len(ps) == len(rs) > 20
    for r, p in zip(rs, ps):
        for k in range(3):
            assert np.array_equal(p[k], r[k])
        assert p[3] == r[3]


@pytest.mark.parametrize("seed", range(10))
def test_synth_fused_op_matches_reference(seed):
    """The same recipe from the same draws: prims and edges equal, and the
    torch function's output equal to the jnp one's on the same inputs."""
    rfn, rx, rprims, redges = RPROF.synth_fused_op(random.Random(seed),
                                                   max_nodes=12, dim=32)
    pfn, px, pprims, pedges = PPROF.synth_fused_op(random.Random(seed),
                                                   max_nodes=12, dim=32,
                                                   device="cpu")
    assert pedges == redges
    assert [vars(p) for p in pprims] == [vars(p) for p in rprims]
    assert len(px) == len(rx)
    for a, b in zip(px, rx):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(rfn(*rx))
    got = pfn(*px).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, equal_nan=True)


def test_measured_samples_compile_one_graph_each():
    """Two tier B samples compiled by ``torch.compile`` and timed on the
    host clock: one graph each, finite positive times, features equal to
    the reference's."""
    rec = {}
    ps = PPROF.measured_fused_samples(2, seed=3, max_nodes=6, dim=64,
                                      device="cpu", record=rec)
    rs = RPROF.measured_fused_samples(2, seed=3, max_nodes=6, dim=64)
    assert rec["graphs"] == 2
    assert rec["compile_s"] > 0 and rec["time_s"] > 0
    for r, p in zip(rs, ps):
        for k in range(3):
            assert np.array_equal(p[k], r[k])
        assert math.isfinite(p[3]) and p[3] > 0


def test_graph_break_raises():
    """A function dynamo cannot capture whole is never timed eagerly."""
    def fn(x):
        if x.sum() > 0:   # data-dependent control flow: a graph break
            return x * 2
        return x

    with pytest.raises(torch._dynamo.exc.Unsupported):
        PPROF.time_callable(fn, [torch.ones(4)])


def test_calibrate_hw_on_the_cpu():
    hw = PPROF.calibrate_hw("cpu")
    assert hw.name == "cpu-calibrated" and hw.efficiency == 1.0
    for v in (hw.peak_flops, hw.hbm_bw, hw.launch_overhead):
        assert math.isfinite(v) and v > 0
    h = PCO.H100_SXM
    assert (hw.ici_bw, hw.allreduce_latency, hw.vmem_bytes, hw.mxu_dim) == (
        h.ici_bw, h.allreduce_latency, h.vmem_bytes, h.mxu_dim)
    assert PPROF.CPU_HW == PCO.Hardware(**vars(RPROF.CPU_HW))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """No silent fall back to the CPU: without a card the default device
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = PG.GNNConfig(n_layers=1, n_heads=1, head_dim=2, mlp_dim=2)
    for call in (lambda: PPROF.calibrate_hw(),
                 lambda: PPROF.synth_fused_op(random.Random(0)),
                 lambda: PG.init_params(cfg),
                 lambda: PG.GNNEstimator(PG.init_params(cfg, device="cpu"),
                                         cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
