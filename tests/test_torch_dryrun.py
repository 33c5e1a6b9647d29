"""The port's dry run (``repro_torch.launch.dryrun``), its shapes and its
mesh bridge against the reference's ``repro.launch`` on the CPU:

* ``launch/shapes.py``: the constants, ``applicability`` and
  ``cache_capacity`` on every arch and shape, and ``input_specs``;
* the four cost functions, bit-identical to the reference's under
  ``TPU_V5E`` on hand-built collective sets (data parallel only, TP and
  DP, the ambiguous 16x16 set where every all-reduce has the TP group's
  size, and an empty one);
* ``price_plan`` and ``price_serving_plan`` bit-identical on a Plan and a
  ServingPlan the reference saved; a mismatched ``--cluster`` exits 1;
* ``cluster_from_mesh`` against the reference's for (16, 16) and
  (2, 16, 16); ``make_production_mesh`` on a fake world;
* the fake dry run: its collectives equal, op by op, those the same step
  issues on a real gloo (2, 2) mesh through the same counter, for a ZeRO-3
  model and for an RWKV-6 model whose heads split over the model ranks,
  and for a prefill (RWKV-6's split heads) and decode steps (ZeRO-3
  DeepSeek-V2 and a ``head_dim``-sharded cache); its flops equal
  ``FlopCounterMode``'s; its JSON read by the port's
  ``samples_from_dryrun`` and by ``benchmarks/roofline.py``;
* ``cache_specs`` against the reference's ``cache_shardings`` for every
  arch at ``decode_32k`` and ``long_500k`` on the production meshes, the
  bytes each device holds with them, and the dry run's decode holding
  that cache shard; the serving shapes on a small fake world.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` in ``os.environ``
(for 512 host devices); the fixture restores the environment, so the
variable reaches no subprocess of this worker.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import repro.core as RCO  # noqa: E402
import repro.plan as RP  # noqa: E402
import repro.serving.plan as RSP  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.cluster import get_preset as rget_preset  # noqa: E402
from repro.core.pipeline import PipelineSchedule as RSchedule  # noqa: E402
from repro.launch import mesh as RMESH  # noqa: E402
from repro.launch import shapes as RSHAPES  # noqa: E402
from repro.serving.workload import Workload as RWorkload  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.cluster import get_preset  # noqa: E402
from repro_torch.cluster.calibrate import samples_from_dryrun  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.hw import H100_SXM, TPU_V5E  # noqa: E402
from repro_torch.core.pipeline import PipelineSchedule  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import shapes as SHAPES  # noqa: E402

from test_torch_search import chain_graph  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def RDR():
    """``repro.launch.dryrun``, imported with ``os.environ`` restored."""
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as mod
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


def _canon(d) -> str:
    return json.dumps(d, sort_keys=True, default=repr)


# ------------------------------------------------------------------ shapes
def test_shape_constants_equal_the_reference():
    assert SHAPES.SHAPES == RSHAPES.SHAPES
    assert SHAPES.GRAD_ACCUM == RSHAPES.GRAD_ACCUM
    assert SHAPES.FSDP_ARCHS == RSHAPES.FSDP_ARCHS
    assert SHAPES.ZERO1_ARCHS == RSHAPES.ZERO1_ARCHS
    assert SHAPES.SW_WINDOW == RSHAPES.SW_WINDOW
    from repro_torch.core import analytic
    assert analytic.SHAPES is SHAPES.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_applicability_and_cache_capacity(arch):
    """Every shape: the same verdict, reason and config variant (the dense
    archs' sliding window on long_500k), and the same cache length."""
    for shape, info in SHAPES.SHAPES.items():
        ok, why, cfg = SHAPES.applicability(get_config(arch), shape)
        rok, rwhy, rcfg = RSHAPES.applicability(JC.get_config(arch), shape)
        assert (ok, why) == (rok, rwhy)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert (SHAPES.cache_capacity(cfg, info["seq"])
                == RSHAPES.cache_capacity(rcfg, info["seq"]))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "seamless-m4t-medium",
                                  "paligemma-3b", "recurrentgemma-9b"])
def test_input_specs_shapes(arch):
    """The reduced config's specs at every shape: the reference's keys and
    shapes (caches leaf by leaf), meta tensors, int64 tokens."""
    import jax

    cfg, rcfg = get_config(arch).reduced(), JC.get_config(arch).reduced()
    for shape in SHAPES.SHAPES:
        got = SHAPES.input_specs(cfg, shape)
        want = RSHAPES.input_specs(rcfg, shape)
        assert sorted(got) == sorted(want)
        for k in got:
            g = [t.shape for t in jax.tree.leaves(
                got[k], is_leaf=lambda x: isinstance(x, torch.Tensor))]
            w = [tuple(t.shape) for t in jax.tree.leaves(want[k])]
            assert [tuple(s) for s in g] == w, (shape, k)
        for t in jax.tree.leaves(
                got, is_leaf=lambda x: isinstance(x, torch.Tensor)):
            assert t.device.type == "meta"
        key = "tokens" if "tokens" in got else "token"
        assert got[key].dtype == torch.int64


# ----------------------------------------------------------------- pricing
def _colls(rdr):
    """Hand-built collective sets: data parallel only at 256, TP (16) and
    DP (16 x 16 = the TP size too: ambiguous, and a distinct 32 group),
    ZeRO-3's gathers and scatters with a permute, and none."""
    def make(entries):
        coll = DR.empty_collectives()
        for op, nbytes, g, n in entries:
            for _ in range(n):
                DR.add_collective(coll, op, nbytes, g)
        return coll

    sets = {
        "dp": [("all-reduce", 4.0e6, 256, 12)],
        "tp_dp": [("all-reduce", 8.0e6, 32, 10),
                  ("all-reduce", 1.0e5, 16, 64),
                  ("all-gather", 2.0e5, 16, 32)],
        "ambiguous": [("all-reduce", 3.0e6, 16, 40),
                      ("reduce-scatter", 1.0e6, 16, 8)],
        "fsdp": [("all-gather", 5.0e6, 16, 20),
                 ("reduce-scatter", 5.0e5, 16, 10),
                 ("all-reduce", 2.0e4, 16, 30),
                 ("collective-permute", 1.0e6, 2, 4)],
        "empty": [],
    }
    return {k: make(v) for k, v in sets.items()}


def test_collectives_schema_equals_parse_collectives(RDR):
    """:func:`add_collective` builds what the reference's
    ``parse_collectives`` reads from HLO text with the same ops, result
    shapes and replica groups."""
    hlo = "\n".join([
        "  %a = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
        "replica_groups=[16,16]<=[256]",
        "  %b = bf16[64,32]{1,0} all-gather(bf16[4,32]{1,0} %y), "
        "replica_groups=[16,16]<=[256]",
        "  %c = f32[8]{0} reduce-scatter(f32[128]{0} %z), "
        "replica_groups=[32,8]<=[256]",
    ])
    want = RDR.parse_collectives(hlo)
    got = DR.empty_collectives()
    DR.add_collective(got, "all-reduce", 4096.0, 16)
    DR.add_collective(got, "all-gather", 64 * 32 * 2.0, 16)
    DR.add_collective(got, "reduce-scatter", 32.0, 8)
    assert _canon(got) == _canon(want)


@pytest.mark.parametrize("name", ["dp", "tp_dp", "ambiguous", "fsdp",
                                  "empty"])
def test_cost_functions_bit_identical_under_tpu_v5e(RDR, name):
    coll = _colls(RDR)[name]
    spec = get_preset("tpu_v5e_pod_256")
    rspec = rget_preset("tpu_v5e_pod_256")
    flops = 3.7e15
    for streams in (1, 4):
        assert _canon(DR.collective_cost_model(
            coll, spec, streams=streams, tp_degree=16, keep_timeline=True)) \
            == _canon(RDR.collective_cost_model(
                coll, rspec, streams=streams, tp_degree=16,
                keep_timeline=True))
        assert _canon(DR.tp_cost_model(coll, spec, 16, flops, streams,
                                       keep_timeline=True, hw=TPU_V5E)) \
            == _canon(RDR.tp_cost_model(coll, rspec, 16, flops, streams,
                                        keep_timeline=True))
        sched = PipelineSchedule(n_stages=4, n_microbatches=8)
        rsched = RSchedule(n_stages=4, n_microbatches=8)
        assert _canon(DR.pipeline_cost_model(coll, spec, sched, flops,
                                             streams, True, hw=TPU_V5E)) \
            == _canon(RDR.pipeline_cost_model(coll, rspec, rsched, flops,
                                              streams, True))
    assert (DR.background_from_collectives(coll, 16)
            == RDR.background_from_collectives(coll, 16))
    if name != "empty":
        # the port prices compute on the H100 by default
        tpb = DR.tp_cost_model(coll, spec, 16, flops, 4)
        assert tpb is None or tpb["ref_chip"] == H100_SXM.name


@pytest.fixture(scope="module")
def saved_plans(tmp_path_factory):
    """A Plan and a ServingPlan, each compiled and saved by the
    reference."""
    d = tmp_path_factory.mktemp("plans")
    plan = RP.compile_plan(graph=chain_graph(RCO), cluster="a100_nvlink_ib",
                           streams=4, seed=3, hw=RCO.TPU_V5E,
                           unchanged_limit=25, max_steps=20)
    plan.save(str(d / "plan.json"))
    serve = RSP.compile_serving("tinyllama-1.1b",
                                workload=RWorkload(n_requests=16, seed=3),
                                cluster="tpu_v5e_pod_16", cache_len=256,
                                unchanged_limit=15, max_steps=30, seed=0)
    serve.save(str(d / "serve.json"))
    return str(d / "plan.json"), str(d / "serve.json")


@pytest.mark.parametrize("cluster", [None, "a100_nvlink_ib",
                                     "h100_superpod"])
@pytest.mark.parametrize("streams", [None, 1])
def test_price_plan_bit_identical(RDR, saved_plans, cluster, streams):
    path, _ = saved_plans
    got = DR.price_plan(path, cluster=cluster, streams=streams,
                        verbose=False)
    want = RDR.price_plan(path, cluster=cluster, streams=streams,
                          verbose=False)
    assert _canon(got) == _canon(want)
    assert ("cluster_fingerprint_diff" in got["pricing"]) == (
        cluster == "h100_superpod")


@pytest.mark.parametrize("cluster", [None, "tpu_v5e_pod_16",
                                     "a100_nvlink_ib"])
def test_price_serving_plan_bit_identical(RDR, saved_plans, cluster):
    _, path = saved_plans
    got = DR.price_serving_plan(path, cluster=cluster, verbose=False)
    want = RDR.price_serving_plan(path, cluster=cluster, verbose=False)
    assert _canon(got) == _canon(want)


def test_cli_prices_and_refuses_a_mismatched_cluster(saved_plans, tmp_path,
                                                     capsys):
    """``--plan`` and ``--serve-plan`` write their JSON and return; a
    ``--cluster`` whose fingerprint differs prints each differing field
    and exits 1."""
    plan, serve = saved_plans
    out = str(tmp_path)
    DR.main(["--plan", plan, "--out", out])
    DR.main(["--serve-plan", serve, "--out", out])
    assert sorted(os.listdir(out)) == ["plan__plan.json",
                                       "serve_plan__serve.json"]
    capsys.readouterr()
    for flag, path in (("--plan", plan), ("--serve-plan", serve)):
        with pytest.raises(SystemExit) as e:
            DR.main([flag, path, "--cluster", "h100_superpod", "--out", out])
        assert e.value.code == 1
        text = capsys.readouterr().out
        assert "fingerprint diff:" in text and "CLUSTER MISMATCH" in text


# -------------------------------------------------------------------- mesh
@pytest.mark.parametrize("shape", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"data": 4, "model": 2}])
def test_cluster_from_mesh_matches_reference(shape):
    mesh = types.SimpleNamespace(shape=shape)
    got = MESH.cluster_from_mesh(mesh, hw=TPU_V5E)
    want = RMESH.cluster_from_mesh(mesh, hw=RCO.TPU_V5E)
    assert got.describe() == want.describe()
    assert MESH.cluster_from_mesh(mesh).describe()["levels"][0][
        "bandwidth_gbps"] == H100_SXM.ici_bw / 1e9


def _fake_init(rank, n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


@pytest.mark.parametrize("multi_pod,rank", [(False, 0), (False, 37),
                                            (True, 300)])
def test_make_production_mesh_on_a_fake_world(multi_pod, rank):
    """Group sizes and this rank's groups: its model group shares its row,
    its data group its column, spanning pod x data on the multi-pod
    mesh."""
    n = 512 if multi_pod else 256
    _fake_init(rank, n)
    try:
        mesh = MESH.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.shape == ({"pod": 2, "data": 16, "model": 16}
                              if multi_pod else {"data": 16, "model": 16})
        row, col = divmod(rank, 16)
        assert dist.get_process_group_ranks(mesh.model) == \
            list(range(row * 16, row * 16 + 16))
        assert dist.get_process_group_ranks(mesh.data) == \
            list(range(col, n, 16))
        assert dist.get_world_size(mesh.data) == n // 16
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        _fake_init(0, 4)
        try:
            MESH.make_production_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


# --------------------------------------------------------------- dry run
# (arch, config changes): a ZeRO-3 model, and RWKV-6 at 5 heads of 64
# over 2 model ranks (2.5 heads a rank, as rwkv6-3b's 40 over 16)
WIDE = dict(d_model=320, n_heads=5, n_kv_heads=5)
CASES = [("deepseek-coder-33b", {}), ("rwkv6-3b", WIDE)]
# (arch, config changes, shape) of each step held to a real one: the
# training steps of CASES, RWKV-6's prefill over split heads, and decode
# steps of ZeRO-3 DeepSeek-V2 (MLA, routed experts) and of a model whose
# single KV head leaves its cache sharded on head_dim
STEPS = ([(arch, kw, "train_4k") for arch, kw in CASES]
         + [("rwkv6-3b", WIDE, "prefill_32k"),
            ("deepseek-v2-236b", {}, "decode_32k"),
            ("paligemma-3b", {}, "decode_32k")])
STEP_IDS = ["deepseek-coder-33b-kw0", "rwkv6-3b-kw1", "rwkv6-3b-prefill",
            "deepseek-v2-236b-decode", "paligemma-3b-decode"]
BATCH, SEQ, ACCUM = 8, 64, 2


def _cfg(arch, kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _specs(cfg=None, shape="train_4k"):
    """Reduced inputs of ``shape``: :data:`BATCH` rows of :data:`SEQ`
    tokens, or a decode step over caches of :data:`SEQ`."""
    if SHAPES.SHAPES[shape]["kind"] != "decode":
        return {"tokens": torch.empty((BATCH, SEQ), dtype=torch.int64,
                                      device="meta")}
    from repro_torch.models import stacked as ST
    return {"token": torch.empty((BATCH,), dtype=torch.int64, device="meta"),
            "pos": torch.empty((), dtype=torch.int64, device="meta"),
            "caches": ST.init_cache(cfg, BATCH, SEQ, device="meta")}


_WORKER = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
sys.path.insert(0, meta["tests"])
from test_torch_dryrun import _specs
out = {}
for arch, kw, shape in meta["cases"]:
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    specs = _specs(cfg, shape)
    if shape == "train_4k":
        step, args, info = DR.build_dryrun_train(
            cfg, mesh, arch, specs=specs, grad_accum=meta["accum"])
    else:
        step, args, info = DR.build_dryrun_serve(cfg, mesh, arch, shape,
                                                 specs=specs)
        info = {"mode": "auto"}
    with DR.StepCounter() as count:
        step(*args)
    out[f"{arch}__{shape}"] = {"coll": count.coll, "flops": count.flops,
                               "mode": info["mode"]}
if rank == 0:
    json.dump(out, open(f"{d}/out.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    """Each case's step on a real gloo (2, 2) mesh, counted by
    :class:`StepCounter` on rank 0."""
    d = tmp_path_factory.mktemp("dryrun")
    (d / "meta.json").write_text(json.dumps(
        {"cases": STEPS, "accum": ACCUM,
         "tests": os.path.dirname(os.path.abspath(__file__))}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("arch,kw,shape", STEPS, ids=STEP_IDS)
def test_fake_dry_run_counts_equal_a_real_step(gloo_counts, arch, kw, shape,
                                               tmp_path):
    """``dryrun_one`` on a fake (2, 2) world against the same step on four
    gloo ranks: equal collectives, op by op (count, result bytes, traffic
    and group sizes), and equal flops.  ZeRO-3 gathers over the data
    group; RWKV-6's split heads add the model group's r, k, v gathers
    (in training and in a prefill); a decode step of ZeRO-3 DeepSeek-V2
    gathers each layer over the data group and MLA's latent cache over
    the model group; a ``head_dim``-sharded cache's partial scores are
    all-reduced over the model group.  The result carries the reference's
    keys, and the pricing readers take its JSON."""
    cfg = _cfg(arch, kw)
    res = DR.dryrun_one(arch, shape, mesh_shape={"data": 2, "model": 2},
                        cfg=cfg, specs=_specs(cfg, shape),
                        grad_accum=ACCUM if shape == "train_4k" else None,
                        verbose=False)
    want = gloo_counts[f"{arch}__{shape}"]
    assert json.loads(json.dumps(res["collectives"])) == want["coll"]
    assert res["flops"] == want["flops"] > 0
    per_op = res["collectives"]["per_op"]
    m = res["memory"]
    if shape != "train_4k":
        assert res["mode"] == want["mode"] == "auto"
        assert res["grad_accum"] is None
        assert res["kind"] == SHAPES.SHAPES[shape]["kind"]
        assert per_op["all-gather"]["by_group"][2]["count"] > 0
        if arch in SHAPES.FSDP_ARCHS:
            # every layer's ZeRO-3 shards gathered over the data group
            assert per_op["all-gather"]["count"] > \
                2 * cfg.n_layers + 1
        assert m["argument_bytes"] > m["alias_bytes"] >= 0
        assert m["temp_bytes"] > 0 and m["output_bytes"] > 0
        assert (m["alias_bytes"] > 0) == (shape == "decode_32k")
        return
    assert res["mode"] == want["mode"] == (
        "fsdp_tp" if arch in SHAPES.FSDP_ARCHS else "ddp_tp")
    if arch in SHAPES.FSDP_ARCHS:
        assert per_op["reduce-scatter"]["count"] > 0
    else:
        assert per_op["all-gather"]["by_group"][2]["count"] > 0
    for key in ("arch", "shape", "mesh", "applicable", "fake_step_s",
                "bytes_accessed", "transcendentals", "grad_accum",
                "cluster"):
        assert key in res
    assert m["argument_bytes"] > m["alias_bytes"] > 0 and m["temp_bytes"] > 0
    path = tmp_path / f"{arch}__train_4k__pod2x2.json"
    path.write_text(json.dumps(res))
    samples, spec = samples_from_dryrun(json.loads(path.read_text()))
    assert samples and spec.describe() == res["cluster"]["spec"]
    probe = (
        "import json, sys; sys.path.insert(0, 'benchmarks'); "
        "import roofline as R; d = R.load_dryruns(sys.argv[1]); "
        "(k, v), = d.items(); row = R.analyse(k[0], k[1], 'pod16x16', v); "
        "print(json.dumps([row['hlo_flops_raw'], row['mem_gib_per_dev']]))")
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    flops, gib = json.loads(out.stdout.strip().splitlines()[-1])
    assert flops == res["flops"]
    assert gib == (m["argument_bytes"] + m["temp_bytes"]) / 2**30


def test_step_counter_flops_equal_flop_counter_mode():
    """The counter's flops are ``FlopCounterMode``'s on the same fake
    step, and its memory accounting sees the step's gradients."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    arch, kw = CASES[0]
    with DR.fake_world(4):
        mesh = MESH.make_mesh({"data": 2, "model": 2}, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, info = DR.build_dryrun_train(
                _cfg(arch, kw), mesh, arch, specs=_specs(), grad_accum=1)
            with FlopCounterMode(display=False) as fc, \
                    DR.StepCounter() as count:
                step(*args)
    assert count.flops == fc.get_total_flops() > 0
    assert count.peak >= info["params_bytes"]


@pytest.mark.parametrize("fake", [False, True])
def test_step_counter_memory_and_bytes_on_known_ops(fake):
    """The counter's ``peak``, ``live`` and ``bytes_accessed`` on a few
    ops whose answers are known, on real and on fake tensors: a storage
    counts from the op that creates it until it is freed; a view creates
    none and reads nothing; an in-place op creates none; each op's inputs
    and outputs count once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx, DR.StepCounter() as count:
        x = torch.ones(1000)                        # +4000, writes 4000
        y = x * 2                                   # +4000, 8000 moved
        v = y.view(10, 100)                         # a view: nothing
        del x                                       # -4000
        z = v + 1                                   # +4000, 8000 moved
        z.mul_(3)                                   # in place: 8000 moved
        # a temporary (+2000, writes 2000) and the product (+200; reads
        # 6000, writes 200), the temporary freed after the op
        w = torch.mm(z, torch.ones(100, 5))
        live, peak = count.live, count.peak
        del y, v, z, w
    assert (live, peak) == (8200, 10200)
    assert count.bytes_accessed == 4000 + 8000 + 8000 + 8000 + 2000 + 6200
    assert count.flops == 2 * 10 * 100 * 5
    assert count.live == 0


def test_step_counter_counts_the_softmax_kernels_temporaries():
    """``kernel_temp_bytes`` in the counter's peak: softmax's kernel
    copies a non-contiguous input; its backward forms ``grad * output``
    laid out as ``grad``, then copies that when it is not contiguous.
    Other ops count only their results."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n = 64 * 32 * 4
    with FakeTensorMode():
        x = torch.empty(64, 32).t()               # (32, 64), not contiguous
        y = torch.empty(32, 64)
        g = torch.empty(64, 32).t()
        cases = [(lambda: torch.softmax(x, -1), 2 * n),
                 (lambda: torch.softmax(y, -1), n),
                 (lambda: torch.ops.aten._softmax_backward_data(
                     g, y, -1, torch.float32), 3 * n),
                 (lambda: torch.ops.aten._softmax_backward_data(
                     y, y, -1, torch.float32), 2 * n),
                 (lambda: torch.ops.aten._log_softmax_backward_data(
                     g, y, -1, torch.float32), 2 * n),
                 (lambda: x * 2, n)]
        for fn, want in cases:
            with DR.StepCounter() as count:
                fn()
            assert count.peak == want


def test_dryrun_grads_is_the_step_before_its_update():
    """``dryrun_grads`` runs ``step.loss_and_grads``, the step before its
    sync, clip and update: its arguments are the parameters and batch
    rows, its temp holds at least a gradient per parameter element and no
    more than the whole step's temp."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch, kw = CASES[0]
    cfg = _cfg(arch, kw)
    with DR.fake_world(4):
        mesh = MESH.make_mesh({"data": 2, "model": 2}, device="cpu")
        grads = DR.dryrun_grads(cfg, mesh, arch, specs=_specs(),
                                grad_accum=1)
        whole = DR.dryrun_train(cfg, mesh, arch, specs=_specs(),
                                grad_accum=1)
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, _, info = DR.build_dryrun_train(cfg, mesh, arch,
                                               specs=_specs(), grad_accum=1)
    m = whole["memory"]
    assert grads["argument_bytes"] == m["argument_bytes"] - info["opt_bytes"]
    assert info["params_bytes"] <= grads["temp_bytes"] <= m["temp_bytes"]


# the reference's result keys of a compiled serving step; the port runs
# the step instead of compiling it (ROADMAP C23)
_SERVE_KEYS = {"arch", "shape", "mesh", "applicable", "reason", "cluster",
               "kind", "flops", "bytes_accessed", "transcendentals",
               "memory", "collectives", "grad_accum", "mode"}


def test_serving_shapes_wait_for_a4d(RDR):
    """ROADMAP A4d, now ported: ``prefill_32k``, ``decode_32k`` and
    ``long_500k`` run on a small fake (2, 2) world for reduced
    tinyllama-1.1b (the shapes' own batch and lengths: 32 prompts of
    32768, 128 rows over caches of 32768, one row over a sliding window
    of 4096) and return the reference's keys, ``lower_s`` and
    ``compile_s`` replaced by ``fake_step_s``; a shape the arch cannot
    take returns the reference's verdict without running."""
    cfg = get_config("tinyllama-1.1b").reduced()
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        res = DR.dryrun_one("tinyllama-1.1b", shape,
                            mesh_shape={"data": 2, "model": 2}, cfg=cfg,
                            verbose=False)
        assert _SERVE_KEYS <= set(res) and "fake_step_s" in res
        assert sorted(res["memory"]) == ["alias_bytes", "argument_bytes",
                                         "output_bytes", "temp_bytes"]
        assert res["mode"] == "auto" and res["grad_accum"] is None
        assert res["kind"] == SHAPES.SHAPES[shape]["kind"]
        assert res["flops"] > 0 and res["cluster"]["spec"]
        if shape == "long_500k":
            assert res["reason"] == "sliding-window variant (w=4096)"
    res = DR.dryrun_one("deepseek-v2-236b", "long_500k", verbose=False)
    want = RDR.dryrun_one("deepseek-v2-236b", "long_500k", False,
                          verbose=False)
    assert res == want and res["applicable"] is False
    assert "quadratic" in res["reason"]
    assert not dist.is_initialized()


def _shard_bytes(shape, nbytes: int, spec, mesh_shape: dict) -> int:
    """The bytes one device holds of a leaf of ``shape`` laid out by
    ``spec`` on a mesh of ``mesh_shape``."""
    n = nbytes
    for dim, entry in zip(shape, spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                assert dim % mesh_shape[name] == 0
                n //= mesh_shape[name]
    return n


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    """The port's ``cache_specs`` against the reference's
    ``cache_shardings`` on the ``jax.eval_shape`` caches of
    ``decode_32k`` and ``long_500k`` (where it applies), leaf by leaf, on
    a jax ``AbstractMesh``; and the bytes a device holds of the whole
    cache, from each package's own specs, equal."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as JSH
    from repro_torch.distributed import sharding as SH

    amesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    for shape in ("decode_32k", "long_500k"):
        ok, _, cfg = SHAPES.applicability(get_config(arch), shape)
        rok, _, rcfg = RSHAPES.applicability(JC.get_config(arch), shape)
        assert ok == rok
        if not ok:
            continue
        got_caches = SHAPES.input_specs(cfg, shape)["caches"]
        want_caches = RSHAPES.input_specs(rcfg, shape)["caches"]
        got = SH.cache_specs(got_caches, mesh)
        shardings = JSH.cache_shardings(want_caches, amesh)
        want = [tuple(sh.spec) for sh in jax.tree.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))]
        leaves = jax.tree.leaves(
            got_caches, is_leaf=lambda x: isinstance(x, torch.Tensor))
        wleaves = jax.tree.leaves(want_caches)
        assert got == want, shape
        mine = sum(_shard_bytes(t.shape, t.numel() * t.element_size(), sp,
                                mesh) for t, sp in zip(leaves, got))
        theirs = sum(math.prod(sh.shard_shape(w.shape)) * w.dtype.itemsize
                     for w, sh in zip(wleaves, jax.tree.leaves(
                         shardings, is_leaf=lambda x: hasattr(x, "spec"))))
        assert mine == theirs > 0, shape


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "decode_32k"),
                                        ("rwkv6-3b", "long_500k")])
def test_dry_run_decode_holds_the_reference_cache_shard(arch, shape):
    """The production dry run's decode donates this rank's cache shard:
    its ``alias_bytes`` equal the bytes the reference's
    ``cache_shardings`` put on one device of the (16, 16) mesh (tinyllama:
    8 rows of 32768 over 4 KV heads, ``head_dim`` sharded, 0.34 GiB;
    rwkv6-3b: the one row of ``long_500k`` on every data rank)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as JSH

    _, _, rcfg = RSHAPES.applicability(JC.get_config(arch), shape)
    caches = RSHAPES.input_specs(rcfg, shape)["caches"]
    shardings = JSH.cache_shardings(caches, AbstractMesh((16, 16),
                                                         ("data", "model")))
    want = sum(math.prod(sh.shard_shape(w.shape)) * w.dtype.itemsize
               for w, sh in zip(jax.tree.leaves(caches), jax.tree.leaves(
                   shardings, is_leaf=lambda x: hasattr(x, "spec"))))
    res = DR.dryrun_one(arch, shape, verbose=False)
    assert res["memory"]["alias_bytes"] == want
    assert res["collectives"]["per_op"]["all-gather"]["by_group"][16]


# ------------------------------------------------------------------- sweep
def _sweep(args, out):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", *args, "--out",
         str(out)], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=600)


def test_sweep_runs_skips_and_records_a_failure(tmp_path):
    """``python -m repro_torch.launch.sweep`` (the reference's CLI): a
    reduced combination (reduced tinyllama-1.1b at ``long_500k`` on the
    fake (16, 16) world, each combination a subprocess of its own) writes
    the dry run's JSON with its attempts and host seconds; one that does
    not apply writes the verdict and prints SKIP; ``--skip-existing``
    passes over written ones; an unknown arch fails every attempt, is
    written as an error record and makes the sweep exit 1."""
    ok = _sweep(["--arch", "tinyllama-1.1b-reduced,deepseek-v2-236b",
                 "--shape", "long_500k", "--meshes", "single"], tmp_path)
    assert ok.returncode == 0, ok.stdout[-3000:] + ok.stderr[-3000:]
    run = json.loads((tmp_path / "tinyllama-1.1b-reduced__long_500k__"
                      "pod16x16.json").read_text())
    assert run["applicable"] and run["kind"] == "decode"
    assert run["attempts"] == 1 and run["host_s"] > 0
    assert run["mesh"] == "pod16x16" and run["memory"]["alias_bytes"] > 0
    skip = json.loads((tmp_path / "deepseek-v2-236b__long_500k__"
                       "pod16x16.json").read_text())
    assert skip["applicable"] is False
    assert "deepseek-v2-236b__long_500k__pod16x16: SKIP" in ok.stdout
    again = _sweep(["--arch", "deepseek-v2-236b", "--shape", "long_500k",
                    "--meshes", "single", "--skip-existing"], tmp_path)
    assert again.returncode == 0 and "(exists)" in again.stdout
    bad = _sweep(["--arch", "no-such-arch", "--shape", "decode_32k",
                  "--meshes", "single"], tmp_path)
    assert bad.returncode == 1
    assert "FAIL no-such-arch__decode_32k__pod16x16" in bad.stdout
    assert bad.stdout.count("retry") == 3
    err = json.loads((tmp_path / "no-such-arch__decode_32k__pod16x16.json")
                     .read_text())
    assert "unknown arch" in err["error"] and err["mesh"] == "pod16x16"
