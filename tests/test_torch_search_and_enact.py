"""The search -> save -> enact workflow of the port
(``repro_torch.examples.search_and_enact``) against the reference's, on
the CPU:

* a Plan the reference searches (``repro.plan.compile`` of reduced
  qwen2-0.5b on ``a100_nvlink_ib`` with 4 streams) loads in the port and
  lowers to the reference's buckets, comm kinds, chunks and fused flags;
* on a fake (4, 2) world, one rank's ``ddp_tp`` step under the
  per-tensor strategy, under that Plan and under a hand-built strategy
  (unfused ``ar`` and ``rs_ag`` buckets cut into chunks, and a fused
  bucket, which the searched Plan lacks): the data group's collectives
  are what each strategy implies chunk by chunk, its all-reduces no more
  than per-tensor's, and the model group's the same under every
  strategy;
* four gloo ranks on a (2, 2) mesh run the same steps on real tensors
  (one group spawned for the module): ``StepCounter`` sees exactly the
  fake (2, 2) world's collectives, op by op, and the parameters after the
  step equal per-tensor's;
* the twin's ``main`` runs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.plan as RP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import stacked as JST  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.train_step import GradSyncStrategy  # noqa: E402
from repro_torch.examples import search_and_enact as SE  # noqa: E402
from repro_torch.plan import Plan  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
SEARCH_STEPS = 8
MESH22 = {"data": 2, "model": 2}
# reduced qwen2-0.5b has 14 leaves: unfused ar in 3 chunks, unfused rs_ag
# in 2, a fused bucket (its rs and ag per chunk) in 1, rs_ag in 4
HAND = dict(buckets=[[0, 1, 2], [3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13]],
            comms=["ar", "rs_ag", "ar", "rs_ag"], chunks=[3, 2, 1, 4],
            fused=[0, 0, 1, 0])
STRATEGIES = ("per-tensor", "plan", "hand")


def _cfg():
    return get_config(SE.ARCH).reduced()


def _strategy(name, plan_path):
    leaves = SE.meta_leaves(_cfg())
    if name == "per-tensor":
        return GradSyncStrategy.per_tensor(leaves)
    if name == "plan":
        return Plan.load(plan_path).grad_sync(leaves)
    return GradSyncStrategy.from_buckets(params=leaves, **HAND)


_WORKER = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.data.pipeline import make_batch_specs, materialize_batch
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
mesh = make_mesh(meta["mesh"], device="cpu")
sys.path.insert(0, meta["tests"])
from test_torch_search_and_enact import _cfg, _strategy
cfg = _cfg()
counts, params = {}, {}
for name in meta["strategies"]:
    step, (p, opt, batch), _ = DR.build_dryrun_train(
        cfg, mesh, meta["arch"], specs=make_batch_specs(cfg, 8, 64),
        strategy=_strategy(name, meta["plan"]))
    batch = materialize_batch(cfg, 8, 64, device="cpu")
    with DR.StepCounter() as count:
        p, _, _ = step(p, opt, batch)
    counts[name] = count.coll
    for i, leaf in enumerate(T.leaves(TP.gather_params(p, step.tp))):
        params[f"{name}_{i}"] = leaf.numpy()
if rank == 0:
    json.dump(counts, open(f"{d}/counts.json", "w"))
    np.savez(f"{d}/params.npz", **params)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ref_plan(tmp_path_factory):
    """The reference's searched Plan, saved, and its lowering on the
    reference's parameter tree."""
    path = str(tmp_path_factory.mktemp("plan") / "plan.json")
    plan = RP.compile(SE.ARCH, cluster="a100_nvlink_ib", streams=4,
                      n_devices=4, max_steps=SEARCH_STEPS, seed=0)
    plan.save(path)
    jcfg = jax_config(SE.ARCH).reduced()
    shapes = jax.eval_shape(lambda: JST.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return path, plan.grad_sync(shapes)


@pytest.fixture(scope="module")
def gloo_steps(ref_plan, tmp_path_factory):
    """Each strategy's step on four gloo ranks on a (2, 2) mesh: rank 0's
    ``StepCounter`` collectives and the gathered parameters after it."""
    d = tmp_path_factory.mktemp("enact")
    (d / "meta.json").write_text(json.dumps(
        {"mesh": MESH22, "arch": SE.ARCH, "plan": ref_plan[0],
         "strategies": STRATEGIES,
         "tests": os.path.dirname(os.path.abspath(__file__))}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return (json.loads((d / "counts.json").read_text()),
            dict(np.load(d / "params.npz")))


def test_reference_plan_lowers_as_in_the_reference(ref_plan):
    """The reference's Plan, loaded by the port, lowers to the
    reference's buckets, comm kinds, chunk counts and fused flags."""
    path, want = ref_plan
    got = Plan.load(path).grad_sync(SE.meta_leaves(_cfg()))
    assert got.buckets == want.buckets
    assert [got.comm_kind(i) for i in range(len(got.buckets))] == \
        [want.comm_kind(i) for i in range(len(want.buckets))]
    assert [got.chunk_count(i) for i in range(len(got.buckets))] == \
        [want.chunk_count(i) for i in range(len(want.buckets))]
    assert [got.is_fused(i) for i in range(len(got.buckets))] == \
        [want.is_fused(i) for i in range(len(want.buckets))]
    assert got.barriers == want.barriers


@pytest.fixture(scope="module")
def fake_counts(ref_plan):
    """Each strategy's collectives on a fake (4, 2) world."""
    return {name: SE.count_collectives(_cfg(), _strategy(name, ref_plan[0]))
            for name in STRATEGIES}


@pytest.mark.parametrize("name", STRATEGIES[1:])
def test_fake_world_counts_are_what_the_strategy_implies(fake_counts,
                                                         ref_plan, name):
    """On the fake (4, 2) world the data group (4 ranks) runs exactly
    the strategy's implied collectives (per chunk: an all-reduce for an
    unfused ``ar`` bucket, else a reduce-scatter and an all-gather; the
    loss's all-reduce), no more all-reduces than per-tensor's one a leaf,
    and the model group (2 ranks) the same collectives as under
    per-tensor."""
    strat = _strategy(name, ref_plan[0])
    implied = SE.implied_data_counts(strat, SE.meta_leaves(_cfg()))
    data = SE.by_group(fake_counts[name], 4)
    pt = SE.by_group(fake_counts["per-tensor"], 4)
    assert data == implied
    assert pt == {"all-reduce": 14 + 1}
    assert data["all-reduce"] <= pt["all-reduce"]
    assert SE.by_group(fake_counts[name], 2) == \
        SE.by_group(fake_counts["per-tensor"], 2)
    if name == "hand":
        # the ar bucket's 3 chunks and the loss; the rs_ag and fused
        # buckets' 2 + 1 + 4 chunks
        assert implied == {"all-reduce": 3 + 1, "reduce-scatter": 7,
                           "all-gather": 7}


@pytest.mark.parametrize("name", STRATEGIES)
def test_gloo_counts_equal_the_fake_world(gloo_steps, ref_plan, name):
    """The step on four gloo ranks runs what the fake (2, 2) world
    counts, op by op: count, bytes, ring traffic and group sizes."""
    counts, _ = gloo_steps
    fake = SE.count_collectives(_cfg(), _strategy(name, ref_plan[0]),
                                mesh_shape=MESH22)
    assert json.loads(json.dumps(fake)) == counts[name]


@pytest.mark.parametrize("name", STRATEGIES[1:])
def test_gloo_params_after_a_step_equal_per_tensor(gloo_steps, name):
    """After one step on the (2, 2) mesh the parameters under the
    strategy equal those under per-tensor syncing within 1e-6 (f32; every
    bucketing sums the same two addends per element)."""
    _, params = gloo_steps
    keys = [k for k in params if k.startswith("per-tensor_")]
    assert len(keys) == 14
    for k in keys:
        np.testing.assert_allclose(params[k.replace("per-tensor", name)],
                                   params[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_twin_main_runs(capsys):
    """``main(["--device", "cpu", "--steps", "5"])``: search, round trip,
    counts on the fake (4, 2) world as the Plan implies, one step of the
    loaded Plan on a one-rank gloo mesh."""
    out = SE.main(["--device", "cpu", "--steps", "5"])
    assert out["loaded"] == out["plan"]
    data = SE.by_group(out["collectives"]["DisCo"], 4)
    assert data == out["implied"]
    assert data["all-reduce"] <= \
        SE.by_group(out["collectives"]["per-tensor"], 4)["all-reduce"]
    assert np.isfinite(out["step"]["loss"])
    text = capsys.readouterr().out
    assert "plan round-trips bit-for-bit" in text
    assert "data-group all-reduce count: per-tensor=15" in text
