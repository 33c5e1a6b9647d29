"""Each per-layer reader on a synthetic profiler trace (the Chrome-trace
JSON ``torch.profiler`` exports), whose numbers are worked out by hand:
two steps of 10 ms, each a 6 ms model kernel, a staging kernel, an NCCL
kernel and a 1 ms optimizer kernel."""
import pytest

from perfkit import manifest, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    ev = [_x("user_annotation", "bench.traced", 0, 20000)]
    corr = 0
    for s in range(2):
        t = s * 10000
        ev.append(_x("user_annotation", "bench.step", t, 10000))
        ev.append(_x("user_annotation", "bench.optimizer", t + 8000, 1500))
        for name, host, start, dur in (
                ("gemm_kernel", t + 10, t + 100, 6000),
                ("void bucket_pack_kernel(long long const*)", t + 20,
                 t + 6100, 400),
                ("ncclDevKernel_AllReduce_Sum_f32", t + 30, t + 6500, 1000),
                ("adam_elementwise_kernel", t + 8100, t + 8200, 1000)):
            corr += 1
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", host, 5,
                         corr=corr))
            ev.append(_x("kernel", name, start, dur, tid=7, corr=corr))
    return {"traceEvents": ev}


@pytest.fixture
def run():
    return {"view": trace.reduce_trace(synthetic()), "window_s": 2.0,
            "steps": 4, "step_ms": [10.0, 10.0, 11.0, 10.0, 12.0],
            "chips": 1, "flops_per_step": 9.89e13,
            "plan_predicted_s": 0.008,
            "staging": [("bucket_pack", 1_340_000)]}


def test_view(run):
    v = run["view"]
    assert v["steps"] == 2 and len(v["ops"]) == 8
    assert [o["cls"] for o in v["ops"][:4]] == ["model", "sync", "sync",
                                                "optim"]
    assert trace.busy_us(v) == 2 * 8400


def _read(name, run):
    return manifest.metric_reader(name)(run)


def test_readers(run):
    assert _read("fwd_bwd_ms", run) == pytest.approx(6.0)
    assert _read("optim_ms", run) == pytest.approx(1.0)
    # the staging kernel overlaps nothing; the NCCL kernel runs 6500-7500
    assert _read("sync_exposed_ms", run) == pytest.approx(1.4)
    # 1.34e6 bytes a step at 3.35e12 B/s over 400 us of kernel a step
    assert _read("sync_kernels_roofline", run) == pytest.approx(
        100 * 1.34e6 / 3.35e12 / 400e-6)
    assert _read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 16800 / 20000))
    assert _read("mfu", run) == pytest.approx(100 * 9.89e13 * 4 /
                                              (2.0 * 989e12))
    assert _read("plan_error_pct", run) == pytest.approx(20.0)
    # inclusive: 11 + 0.6 x (12 - 11), within the steps read
    assert _read("step_ms_p90", run) == pytest.approx(11.6)


def test_readers_find_nothing():
    empty = {"view": None, "step_ms": [], "steps": 0, "window_s": 0}
    for e in manifest.manifest()["per_layer"]:
        assert _read(e["name"], empty) is None


def test_roofline_refuses_wrong_launch_count(run):
    run["staging"] = [("bucket_pack", 10), ("convert_copy", 10)]
    assert _read("sync_kernels_roofline", run) is None


def test_breakdown(run):
    b = trace.breakdown(run["view"])
    assert b["device_ops"][0] == ["gemm_kernel", 0.012]
    assert len(b["idle_gaps"]) <= 10
    assert all(len(g) == 2 for g in b["idle_gaps"])
