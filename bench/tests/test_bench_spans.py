"""The port's program spans in a profiler trace: ``perfkit.spans`` and its
ten readings on a synthetic Chrome trace whose numbers are worked out by
hand, and the harness's view, breakdown and readers unchanged by the
spans."""
import pytest

from perfkit import manifest, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _read(name, run):
    return manifest.metric_reader(name)(run)


def synthetic_spans():
    """Two steps of 10 ms traced from a program with the port's spans:
    the step's thread 1, autograd's thread 2, the card's stream 7.  Per
    step (us from its start, device): forward attention 100-1100 and FFN
    1100-2600 and a cross-entropy kernel 2600-2800 in ``step.fwd``; in
    ``step.bwd`` on thread 2, the attention's recompute 2800-3300 inside
    its ``model.attn`` span, which opens inside the FFN's backward node,
    then that node's kernel 3300-4300 and the attention's backward
    4300-6300, each tied to its forward by sequence number (the forward op
    that made the node is the last to start with its number: the op before
    it, in another region, already carries it, as does the apply's, which
    precedes the next step's first node); in
    ``sync.bucket`` a staging kernel 6300-6700 and an NCCL all-reduce
    6700-7700; the loss's NCCL all-reduce in ``step.sync`` 7700-7750; the
    clip's convert-copy 7700-7900; in ``step.update`` AdamW 8200-9200
    inside ``bench.optimizer`` and the apply 9200-9500 after it."""
    ev = [_x("user_annotation", "bench.traced", 0, 20000)]
    corr = [0]

    def launch(host, name, start, dur, tid=1):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", host, 5, tid=tid,
                     corr=corr[0]))
        ev.append(_x("kernel", name, start, dur, tid=7, corr=corr[0]))

    def op(name, ts, dur, tid, seq=None, bwd=False):
        e = _x("cpu_op", name, ts, dur, tid=tid)
        if seq is not None:
            e["args"] = {"Sequence number": seq, "Fwd thread id": int(bwd)}
        ev.append(e)

    for s in range(2):
        t, sa, sf = s * 10000, 100 + 10 * s, 101 + 10 * s
        for name, a, d in (("bench.step", 0, 10000), ("step.fwd", 0, 1000),
                           ("model.attn", 10, 390), ("model.ffn", 400, 500),
                           ("model.io", 900, 100), ("step.bwd", 1000, 4000),
                           ("step.sync", 5000, 1000),
                           ("sync.bucket", 5010, 490),
                           ("step.clip", 6000, 500),
                           ("step.update", 7000, 2000),
                           ("bench.optimizer", 7100, 1400)):
            ev.append(_x("user_annotation", name, t + a, d))
        op("aten::view", t + 5, 2, 1, seq=sa)
        op("aten::mm", t + 20, 20, 1, seq=sa)
        launch(t + 30, "attn_gemm", t + 100, 1000)
        op("aten::view", t + 300, 2, 1, seq=sf)
        op("aten::mm", t + 410, 20, 1, seq=sf)
        launch(t + 420, "ffn_gemm", t + 1100, 1500)
        launch(t + 950, "ce_kernel", t + 2600, 200)
        op("autograd::engine::evaluate_function: MmBackward0", t + 1100,
           150, 2, seq=sf, bwd=True)
        ev.append(_x("user_annotation", "model.attn", t + 1110, 60, tid=2))
        op("aten::mm", t + 1120, 40, 2, seq=7 + s)
        launch(t + 1150, "attn_gemm", t + 2800, 500, tid=2)
        launch(t + 1200, "ffn_gemm_bwd", t + 3300, 1000, tid=2)
        op("autograd::engine::evaluate_function: MmBackward0", t + 1300,
           100, 2, seq=sa, bwd=True)
        op("aten::mm", t + 1340, 20, 2)
        launch(t + 1350, "attn_gemm_bwd", t + 4300, 2000, tid=2)
        launch(t + 5020, "void bucket_pack_kernel(long long const*)",
               t + 6300, 400)
        launch(t + 5030, "ncclDevKernel_AllReduce_Sum_f32", t + 6700, 1000)
        launch(t + 5600, "ncclDevKernel_AllReduce_Sum_f32", t + 7700, 50)
        launch(t + 6100, "void convert_copy_kernel(float const*)", t + 7700,
               200)
        launch(t + 8100, "adam_elementwise_kernel", t + 8200, 1000)
        op("aten::add", t + 8590, 20, 1, seq=sa + 10)
        launch(t + 8600, "apply_kernel", t + 9200, 300)
    return {"traceEvents": ev}


def _without_program_spans(raw):
    from perfkit import spans
    names = set(spans.PHASES) | set(spans.REGIONS)
    return {"traceEvents": [e for e in raw["traceEvents"]
                            if e["name"] not in names]}


@pytest.fixture
def span_run():
    from perfkit import spans
    raw = synthetic_spans()
    return {"raw": raw, "spans": spans.reduce_trace(raw),
            "view": trace.reduce_trace(raw), "window_s": 2.0, "steps": 4,
            "step_ms": [10.0, 10.0, 11.0, 10.0, 12.0], "chips": 4,
            "flops_per_step": 9.89e13, "plan_predicted_s": 0.008,
            "staging": [("bucket_pack", 1_340_000),
                        ("convert_copy", 200_000)]}


def test_span_view(span_run):
    v = span_run["spans"]
    assert v["steps"] == 2 and len(v["ops"]) == 24
    step = [(o["name"], o["phase"], o["region"]) for o in v["ops"][:12]]
    assert step == [
        ("attn_gemm", "step.fwd", "model.attn"),
        ("ffn_gemm", "step.fwd", "model.ffn"),
        ("ce_kernel", "step.fwd", "model.io"),
        # launched on autograd's thread in the recompute's own span
        ("attn_gemm", "step.bwd", "model.attn"),
        # tied by sequence number to the forward op of its node
        ("ffn_gemm_bwd", "step.bwd", "model.ffn"),
        ("attn_gemm_bwd", "step.bwd", "model.attn"),
        ("void bucket_pack_kernel(long long const*)", "sync.bucket", None),
        ("ncclDevKernel_AllReduce_Sum_f32", "sync.bucket", None),
        ("ncclDevKernel_AllReduce_Sum_f32", "step.sync", None),
        ("void convert_copy_kernel(float const*)", "step.clip", None),
        ("adam_elementwise_kernel", "step.update", None),
        ("apply_kernel", "step.update", None)]
    assert [o["nccl"] for o in v["ops"][6:9]] == [False, True, True]
    assert [o["step"] for o in v["ops"]] == [0] * 12 + [1] * 12


def test_span_readings(span_run):
    from perfkit import spans
    got = spans.readings(span_run["spans"],
                         collective_bytes={"all_reduce": 1e9},
                         plan_comm_s=0.0008, chips=4)
    want = {"fwd_ms": 2.7, "bwd_ms": 3.5, "attn_ms": 3.5, "ffn_ms": 2.5,
            "io_ms": 0.2, "clip_ms": 0.2, "update_ms": 1.3,
            # sync 6300-7750, of which the convert-copy hides 7700-7750
            "grad_sync_exposed_ms": 1.4,
            # 2 x 3/4 of 1e9 bytes over 1 ms of bucket NCCL a step
            "sync_busbw_gbs": 1500.0,
            "comm_model_error_pct": 20.0}
    assert got == pytest.approx(want)
    # the regions split the forward and backward exactly
    assert got["attn_ms"] + got["ffn_ms"] + got["io_ms"] == pytest.approx(
        got["fwd_ms"] + got["bwd_ms"])
    # the harness's own readers: the apply lies outside bench.optimizer,
    # the clip's convert-copy counts as staging
    assert _read("optim_ms", span_run) == pytest.approx(1.0)
    assert _read("sync_exposed_ms", span_run) == pytest.approx(1.6)
    assert got["update_ms"] > _read("optim_ms", span_run)
    assert got["grad_sync_exposed_ms"] <= _read("sync_exposed_ms", span_run)
    one = spans.readings(span_run["spans"], collective_bytes={
        "all_reduce": 1e9}, plan_comm_s=0.0008, chips=1)
    assert one["sync_busbw_gbs"] is None
    assert one["comm_model_error_pct"] is None


def test_bucket_nccl_seconds_are_the_median_steps():
    from perfkit import spans
    ops = [{"name": "ncclDevKernel_AllReduce", "ts": 10000 * s, "dur": d,
            "phase": "sync.bucket", "region": None, "nccl": True, "step": s}
           for s, d in enumerate((1000, 1000, 5000))]
    got = spans.readings({"window": (0, 30000), "steps": 3, "ops": ops},
                         collective_bytes={"all_reduce": 1e9},
                         plan_comm_s=0.0008, chips=4)
    # a stall that held one step's kernel 5 ms moves neither reading
    assert got["sync_busbw_gbs"] == pytest.approx(1500.0)
    assert got["comm_model_error_pct"] == pytest.approx(20.0)


def test_spans_leave_the_harness_readings_alone(span_run):
    from perfkit import spans
    bare = _without_program_spans(span_run["raw"])
    plain = dict(span_run, view=trace.reduce_trace(bare))
    a, b = span_run["view"], plain["view"]
    assert (a["window"], a["steps"], a["ops"]) == (b["window"], b["steps"],
                                                    b["ops"])
    for e in manifest.manifest()["per_layer"]:
        assert _read(e["name"], span_run) == _read(e["name"], plain), \
            e["name"]
    with_b, bare_b = trace.breakdown(a), trace.breakdown(b)
    assert with_b["device_ops"] == bare_b["device_ops"]
    assert [g for _, g in with_b["idle_gaps"]] == \
        [g for _, g in bare_b["idle_gaps"]]
    # the labels only get finer: where the bare trace said bench.step, the
    # gap at a step's start now reads the forward's span
    for (n, _), (bare_n, _) in zip(with_b["idle_gaps"], bare_b["idle_gaps"]):
        assert n == bare_n or (bare_n == "bench.step" and n in spans.PHASES)
    assert "step.fwd" in {n for n, _ in with_b["idle_gaps"]}
    # a program without the spans: nothing to read
    assert all(o["phase"] is None and o["region"] is None
               for o in spans.reduce_trace(bare)["ops"])
    assert set(spans.readings(spans.reduce_trace(bare)).values()) == {None}
    assert set(spans.readings(None).values()) == {None}
