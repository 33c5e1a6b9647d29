"""The port's DisCo-enacted train step and gradient sync against the JAX
reference: three train steps in a one-rank gloo group against
``build_train_step(mode="ddp_tp", layout="dp")`` on a 1x1 mesh; a
two-rank ``sync_grads`` for every bucket kind against the reference's
``sync_grads`` on two forced host devices, bitwise; and Plan artifacts
saved by ``repro.plan`` enacted as the reference enacts them."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import plan as RP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed import train_step as JTS  # noqa: E402
from repro.launch.mesh import make_mesh_compat  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_three_steps_match_reference(one_rank_group):
    """Losses and grad norms of 3 AdamW steps on reduced tinyllama (f32),
    every bucket fused with 2 chunks, against the reference at dp=1.
    rtol 1e-4: the two packages sum f32 matmuls in different orders."""
    arch, B, S = "tinyllama-1.1b", 4, 32
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    base = TS.GradSyncStrategy.size_capped(params, 1 << 16)
    nb = len(base.buckets)
    strat = TS.GradSyncStrategy(base.buckets, comms=["ar"] * nb,
                                chunks=[2] * nb, fused=[1] * nb)
    ds = SyntheticLMDataset(cfg.vocab, S, B, seed=0)

    mesh = make_mesh_compat((1, 1), ("data", "model"))
    jinit, jupdate = jax_adamw(1e-3, weight_decay=0.01)
    jopt = jinit(jax.tree.map(lambda p: p.astype(jnp.float32), jparams))
    jstep = JTS.build_train_step(
        jcfg, mesh, mode="ddp_tp", layout="dp", optimizer=(jinit, jupdate),
        strategy=JTS.GradSyncStrategy(strat.buckets, comms=strat.comms,
                                      chunks=strat.chunks, fused=strat.fused))
    specs = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    jf = JTS.jit_train_step(jstep, jcfg, mesh, jparams, jopt, specs,
                            layout="dp")

    step = TS.build_train_step(cfg, mode="ddp_tp", layout="dp",
                               strategy=strat, lr=1e-3)
    init, _ = adamw(1e-3, weight_decay=0.01)
    opt = init(T.leaves(params))
    K.reset_launches()
    TS.reset_collectives()
    for s in range(3):
        tokens = ds.global_step_batch(s) % cfg.vocab
        jparams, jopt, jm = jf(jparams, jopt,
                               {"tokens": jnp.asarray(tokens)})
        params, opt, m = step(params, opt,
                              {"tokens": torch.from_numpy(
                                  tokens.astype(np.int64))})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    # the fused path ran at dp=1: one RS and one AG per chunk per bucket
    assert TS.COLLECTIVES["reduce_scatter"] == 3 * 2 * nb
    assert TS.COLLECTIVES["all_gather"] == 3 * 2 * nb
    assert TS.COLLECTIVES["all_reduce"] == 0


def test_grad_accum_matches_single_batch(one_rank_group):
    """Two micro-batches of 2 give the loss of one batch of 4 (the CE is a
    per-token mean over equal-sized micro-batches)."""
    cfg = get_config("qwen2-0.5b").reduced()
    ds = SyntheticLMDataset(cfg.vocab, 16, 4, seed=1)
    batch = {"tokens": torch.from_numpy(
        (ds.global_step_batch(0) % cfg.vocab).astype(np.int64))}
    losses = []
    for accum in (1, 2):
        params = ST.init_params(cfg, seed=1, device="cpu")
        step = TS.build_train_step(cfg, grad_accum=accum, remat=False)
        init, _ = adamw(3e-4, weight_decay=0.01)
        _, _, m = step(params, init(T.leaves(params)), batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


# ------------------------------------------------ two-rank sync_grads
SHAPES = [(17,), (31, 64), (5,), (1000,), (3, 3)]
DTYPES = ["float32", "bfloat16", "bfloat16", "bfloat16", "float32"]
BUCKETS = [[0, 1], [2, 3, 4]]   # both buckets mix f32 and bf16 leaves
CASES = {"ar_k1": ("ar", 1, 0), "ar_k4": ("ar", 4, 0),
         "rs_ag_k2": ("rs_ag", 2, 0), "fused_k2": ("ar", 2, 1)}

_JAX_SYNC = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_compat
from repro.launch.mesh import make_mesh_compat
from repro.distributed.train_step import GradSyncStrategy, sync_grads
d, meta = sys.argv[1], json.load(open(sys.argv[2]))
data = np.load(f"{d}/inputs.npz")
xs = []
for i, dt in enumerate(meta["dtypes"]):
    a = np.stack([data[f"r{r}_{i}"] for r in range(2)])
    xs.append(jnp.asarray(a.view(jnp.bfloat16) if dt == "bfloat16" else a))
mesh = make_mesh_compat((2,), ("data",))
out = {}
for name, (kind, k, fused) in meta["cases"].items():
    nb = len(meta["buckets"])
    strat = GradSyncStrategy(meta["buckets"], comms=[kind] * nb,
                             chunks=[k] * nb, fused=[fused] * nb)
    fn = shard_map_compat(
        lambda *ls: tuple(sync_grads([l[0] for l in ls], strat, ("data",),
                                     full_manual=True)),
        mesh=mesh, in_specs=tuple(P("data") for _ in xs),
        out_specs=tuple(P() for _ in xs), axis_names={"data"}, check=False)
    for i, o in enumerate(jax.jit(fn)(*xs)):
        a = np.asarray(o)
        out[f"{name}_{i}"] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        out[f"{name}_{i}_dtype"] = np.array(a.dtype.name)
np.savez(f"{d}/jax.npz", **out)
"""

_TORCH_SYNC = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import train_step as TS
d, meta, rank = sys.argv[1], json.load(open(sys.argv[2])), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=2)
data = np.load(f"{d}/inputs.npz")
grads = []
for i, dt in enumerate(meta["dtypes"]):
    a = data[f"r{rank}_{i}"]
    t = torch.from_numpy(a.view(np.int16) if dt == "bfloat16" else a)
    grads.append(t.view(torch.bfloat16) if dt == "bfloat16" else t)
out = {}
for name, (kind, k, fused) in meta["cases"].items():
    nb = len(meta["buckets"])
    strat = TS.GradSyncStrategy(meta["buckets"], comms=[kind] * nb,
                                chunks=[k] * nb, fused=[fused] * nb)
    TS.reset_collectives()
    synced = TS.sync_grads([g.clone() for g in grads], strat)
    out[f"{name}_collectives"] = np.array(json.dumps(TS.COLLECTIVES))
    for i, o in enumerate(synced):
        o = o.contiguous()
        if o.dtype == torch.bfloat16:
            out[f"{name}_{i}"] = o.view(torch.int16).numpy().view(np.uint16)
        else:
            out[f"{name}_{i}"] = o.numpy()
        out[f"{name}_{i}_dtype"] = np.array(str(o.dtype).replace("torch.", ""))
np.savez(f"{d}/torch_{rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_rank_sync(tmp_path_factory):
    """Runs the reference (2 forced host devices) and the port (2 gloo
    ranks) on the same per-rank gradients, all three processes at once."""
    d = tmp_path_factory.mktemp("sync2")
    rng = np.random.default_rng(7)
    inputs = {}
    for r in range(2):
        for i, (shape, dt) in enumerate(zip(SHAPES, DTYPES)):
            a = jnp.asarray(rng.standard_normal(shape), dt)
            a = np.asarray(a)
            inputs[f"r{r}_{i}"] = a.view(np.uint16) if dt == "bfloat16" else a
    np.savez(d / "inputs.npz", **inputs)
    meta = d / "meta.json"
    meta.write_text(json.dumps({"dtypes": DTYPES, "buckets": BUCKETS,
                                "cases": CASES}))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_SYNC, str(d),
                               str(meta)], env=env, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _TORCH_SYNC, str(d),
                                str(meta), str(r)], env=env,
                               stderr=subprocess.PIPE, text=True)
              for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return (dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"torch_{r}.npz")) for r in range(2)])


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_sync_grads_bitwise(two_rank_sync, case):
    ref, ranks = two_rank_sync
    kind, k, fused = CASES[case]
    for out in ranks:
        for i in range(len(SHAPES)):
            assert str(out[f"{case}_{i}_dtype"]) == str(ref[f"{case}_{i}_dtype"])
            np.testing.assert_array_equal(out[f"{case}_{i}"],
                                          ref[f"{case}_{i}"])
        counts = json.loads(str(out[f"{case}_collectives"]))
        n = len(BUCKETS) * k
        if kind == "ar" and not fused:
            assert counts == {"all_reduce": n, "reduce_scatter": 0,
                              "all_gather": 0}
        else:
            assert counts == {"all_reduce": 0, "reduce_scatter": n,
                              "all_gather": n}


# ------------------------------------------------------- plan loading
def test_loads_plans_as_the_reference_enacts_them(tmp_path):
    """A Plan compiled by ``repro.plan`` on reduced tinyllama, and a variant
    with every per-bucket field set, lower to the reference's
    ``Plan.grad_sync(params)``; a legacy ``strategy.json`` loads as the
    reference's ``GradSyncStrategy.load``."""
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    plan = RP.compile_plan("tinyllama-1.1b", reduced=True, batch=2, seq=16,
                           unchanged_limit=5, max_steps=5, n_devices=2)
    variant = dataclasses.replace(
        plan, buckets=((11, 1), (2, 3, 4, 40)), bucket_algos=("ring",) * 2,
        bucket_comm=("ar", "rs_ag"), bucket_chunks=(2, 3), bucket_bytes=(),
        bucket_fused=(1, 0), barriers=True)
    for i, p in enumerate((plan, variant)):
        path = str(tmp_path / f"plan{i}.json")
        p.save(path)
        want = RP.Plan.load(path).grad_sync(jparams)
        got = TS.GradSyncStrategy.load(path, params=params)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    legacy = JTS.GradSyncStrategy([[0, 1], [2]], comms=["rs_ag", "ar"],
                                  chunks=[2, 1], fused=[1, 0])
    legacy.save(str(tmp_path / "legacy.json"))
    got = TS.GradSyncStrategy.load(str(tmp_path / "legacy.json"))
    want = JTS.GradSyncStrategy.load(str(tmp_path / "legacy.json"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_launcher_trains_saves_and_resumes(tmp_path):
    """``launch.train.main`` on the CPU: trains, checkpoints in the
    reference's layout, and a second run resumes from the last step."""
    from repro_torch.launch import train as TRAIN

    strat = tmp_path / "strategy.json"
    TS.GradSyncStrategy([[0, 1, 2], [3, 4, 5, 6, 7], [8, 9, 10, 11]],
                        comms=["ar", "rs_ag", "ar"], chunks=[1, 2, 3],
                        fused=[0, 0, 1]).save(str(strat))
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--strategy-file", str(strat),
            "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "100"]
    first = TRAIN.main(argv + ["--steps", "2"])
    assert len(first["losses"]) == 2
    assert all(np.isfinite(first["losses"]))
    meta = json.load(open(tmp_path / "ck" / "step_00000002" / "meta.json"))
    assert meta["leaves"]["leaf_0"]["path"] == "[0]['embed']"
    assert meta["leaves"]["leaf_12"]["path"] == "[1].mu['embed']"
    resumed = TRAIN.main(argv + ["--steps", "3"])
    assert len(resumed["losses"]) == 1     # step 2 only
    assert not dist.is_initialized()
