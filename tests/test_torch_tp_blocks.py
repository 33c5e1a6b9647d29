"""The port's tensor-parallel layout over the blocks that are not dense
attention: the RG-LRU block and the hybrid's groups (recurrentgemma-9b),
RWKV-6's time and channel mix (rwkv6-3b), MLA with both query variants and
the routed experts sharded by expert (deepseek-v2-lite-16b and
deepseek-v2-236b), against the JAX reference and the port's ``layout="dp"``
step, on the CPU with gloo ranks.

One group of 4 ranks is spawned for the module (a ``file://`` rendezvous in
a temporary directory); every rank runs every case and rank 0 writes the
results, which the tests read.  For each reduced model, on the reference's
weights and one batch:

* the TP step on a (2, 2) mesh and on a (1, 2) mesh (the (2, 2) mesh's
  model group with a data group of one rank): 3 AdamW steps' losses and
  gradient norms, the parameters after them, and the first step's synced
  gradients (one SGD step at lr 1 with no clip);
* the port's one-rank ``layout="dp"`` step (rank 0), and for the MoE
  models the ``layout="dp"`` step over the (2, 2) mesh's data group, whose
  ranks route their own rows as the TP step's data ranks do (ROADMAP
  C21).
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import apply_updates as jax_apply  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

ARCHS = ["recurrentgemma-9b", "rwkv6-3b", "deepseek-v2-lite-16b",
         "deepseek-v2-236b"]
MOE = [a for a in ARCHS if a.startswith("deepseek")]
B, S, STEPS = 8, 32, 3
TOKENS = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int64)
# AdamW's eps in every step here, the port's and the reference's.  An
# element whose exact gradient is about 0 gets an f32 rounding residue of
# 1e-8 or so, which the layouts round differently; at the default eps of
# 1e-8 AdamW moves such an element by a large fraction of lr either way
# (rwkv6-3b's squared-ReLU channel mix has many: its parameters measured
# up to 2.6e-4 apart after 3 steps).  At 1e-6 a residue moves it by about
# 1% of lr, and a gradient of 1e-5 or more still by about lr.
EPS = 1e-6

_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import train_step as TS
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import stacked as ST
from repro_torch.optim import adamw, sgd

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
inp = np.load(f"{d}/inputs.npz")
tokens = {"tokens": torch.from_numpy(inp["tokens"])}
out = {}

mesh22 = make_debug_mesh((2, 2), device="cpu")
# a (1, 2) mesh: the (2, 2) mesh's model group, a data group of one rank
single = [dist.new_group([r]) for r in range(4)]
mesh12 = Mesh(None, {"data": 1, "model": 2}, single[rank], mesh22.model)
g0 = single[0]


def setup(arch):
    cfg = get_config(arch).reduced()
    full = ST.init_params(cfg, seed=0, device="cpu")
    n = len(T.leaves(full))
    return cfg, T.unflatten(full, [torch.from_numpy(inp[f"{arch}_{i}"])
                                   for i in range(n)])


def run(cfg, full, steps, mesh=None, group=None, opt=None, clip=1.0):
    opt = opt or adamw(1e-3, weight_decay=0.01, eps=meta["eps"])
    step = TS.build_train_step(
        cfg, layout="dp" if mesh is None else "tp", mesh=mesh, group=group,
        strategy=TS.GradSyncStrategy.size_capped(full, 1 << 16),
        optimizer=opt, clip_norm=clip)
    params = T.map(torch.clone, full)
    if step.tp is not None:
        params = TP.shard_params(params, step.tp)
    state = opt[0](T.leaves(params))
    hist = []
    for _ in range(steps):
        params, state, m = step(params, state, tokens)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    if step.tp is not None:
        params = TP.gather_params(params, step.tp)
    return np.array(hist), [p.detach() for p in T.leaves(params)]


def grads(cfg, full, **kw):
    # one SGD step at lr 1 with no clipping moves each parameter by minus
    # its synced gradient
    _, new = run(cfg, full, 1, opt=sgd(1.0), clip=1e9, **kw)
    return [(p - q).numpy() for p, q in zip(T.leaves(full), new)]


def save(key, hist, params, gr):
    out[f"{key}_hist"] = hist
    for i, (p, g) in enumerate(zip(params, gr)):
        out[f"{key}_params_{i}"] = p.numpy()
        out[f"{key}_grads_{i}"] = g


runs = {"tp22": dict(mesh=mesh22), "tp12": dict(mesh=mesh12),
        "dp2": dict(group=mesh22.data)}
for arch in meta["archs"]:
    cfg, full = setup(arch)
    for key, kw in runs.items():
        if key == "dp2" and arch not in meta["moe"]:
            continue
        hist, params = run(cfg, full, meta["steps"], **kw)
        save(f"{arch}_{key}", hist, params, grads(cfg, full, **kw))
if rank == 0:
    for arch in meta["archs"]:
        cfg, full = setup(arch)
        hist, params = run(cfg, full, meta["steps"], group=g0)
        save(f"{arch}_dp1", hist, params, grads(cfg, full, group=g0))
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_setup(arch):
    jcfg = JC.get_config(arch).reduced()
    return jcfg, JST.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's weights of each reduced model and one batch, and
    the 4-rank group's results."""
    d = tmp_path_factory.mktemp("tpblocks")
    inputs = {"tokens": TOKENS}
    for arch in ARCHS:
        _, jparams = _jax_setup(arch)
        inputs.update({f"{arch}_{i}": np.asarray(l)
                       for i, l in enumerate(jax.tree.leaves(jparams))})
    np.savez(d / "inputs.npz", **inputs)
    (d / "meta.json").write_text(json.dumps(
        {"archs": ARCHS, "moe": MOE, "steps": STEPS, "eps": EPS}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return inputs, dict(np.load(d / "out.npz"))


def _leaves(out, key):
    n = len([k for k in out if k.startswith(key + "_")])
    return [out[f"{key}_{i}"] for i in range(n)]


def _paths(arch):
    with torch.device("meta"):
        from repro_torch.models import stacked as ST
        full = ST.init_params(get_config(arch).reduced(), device="meta")
    return [p for p, _ in T.leaves_with_paths(full)]


@functools.lru_cache(maxsize=None)
def _reference_losses(arch, parts: int = 1):
    """3 steps of the reference's plain single-device step on
    :data:`TOKENS` (remat, clip 1.0, AdamW at 1e-3 with weight decay 0.01
    and eps :data:`EPS`); with ``parts`` > 1 its loss is the mean of the
    losses of that many equal parts of the batch, each routed alone, as
    its ``layout="dp"`` step over ``parts`` data ranks computes it."""
    jcfg, jparams = _jax_setup(arch)
    init, update = jax_adamw(1e-3, weight_decay=0.01, eps=EPS)
    opt = init(jax.tree.map(lambda p: p.astype(jnp.float32), jparams))
    toks = jnp.asarray(TOKENS, jnp.int32).reshape(parts, -1, S)

    def loss_fn(p):
        return sum(JST.loss_fn(p, jcfg, {"tokens": t}, remat=True)
                   for t in toks) / parts

    @jax.jit
    def ref_step(params, opt):
        loss, g = jax.value_and_grad(loss_fn)(params)
        g, _ = jax_clip(g, 1.0)
        updates, opt = update(g, opt, params)
        return jax_apply(params, updates), opt, loss

    params, losses = jparams, []
    for _ in range(STEPS):
        params, opt, loss = ref_step(params, opt)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("mesh", ["tp12", "tp22"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_reference_single_device(four_ranks, arch, mesh):
    """3 steps' losses on a (1, 2) and a (2, 2) mesh against the
    reference's single-device step with the same clip and AdamW, rtol/atol
    2e-4, as the reference holds its own TP step.  At (2, 2) the MoE
    models' data ranks route their own rows (ROADMAP C21), so there the
    reference's loss is the mean over the batch's halves, each routed
    alone, as in its ``layout="dp"`` step over two data ranks; against
    its whole-batch step the loss of step 2 moved by 1.6e-3 on
    deepseek-v2-236b (a router moved by other aux gradients routes other
    tokens), and :func:`test_moe_routing_per_data_rank_gap` measures the
    first step's gap."""
    _, out = four_ranks
    parts = 2 if mesh == "tp22" and arch in MOE else 1
    np.testing.assert_allclose(out[f"{arch}_{mesh}_hist"][:, 0],
                               _reference_losses(arch, parts),
                               rtol=2e-4, atol=2e-4)


def _want(arch, mesh):
    """The port's ``layout="dp"`` step that routes as ``mesh``'s TP step:
    one rank, or for the MoE models at (2, 2) the mesh's two data ranks."""
    return f"{arch}_dp2" if mesh == "tp22" and arch in MOE else f"{arch}_dp1"


@pytest.mark.parametrize("mesh", ["tp12", "tp22"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_dp_step(four_ranks, arch, mesh):
    """The TP step against the port's ``layout="dp"`` step on the same
    weights and batch (one rank; two data ranks for the MoE models at
    (2, 2), which route each rank's rows): the synced gradients of the
    first step within 2e-5 (only the order of f32 sums differs), 3 steps'
    losses and the first step's grad norm within 2e-5 relative, and the
    parameters after 3 AdamW steps at lr 1e-3 within 1e-4 (a wrong
    gradient moves elements by about lr).  Every leaf's gradient is
    whole: a replicated leaf's equal on every rank, a sharded one's this
    rank's slice, gathered here.  The later steps' grad norms are not
    compared: reduced rwkv6-3b's moves by 0.6% when every weight moves by
    a random 1e-5, and the layouts' weights differ by up to 5e-5 after a
    step."""
    _, out = four_ranks
    want = _want(arch, mesh)
    paths = _paths(arch)
    for path, g, w in zip(paths, _leaves(out, f"{arch}_{mesh}_grads"),
                          _leaves(out, f"{want}_grads")):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=path)
    got, hist = out[f"{arch}_{mesh}_hist"], out[f"{want}_hist"]
    np.testing.assert_allclose(got[:, 0], hist[:, 0], rtol=2e-5)
    np.testing.assert_allclose(got[0, 1], hist[0, 1], rtol=2e-5)
    for path, p, w in zip(paths, _leaves(out, f"{arch}_{mesh}_params"),
                          _leaves(out, f"{want}_params")):
        assert p.shape == w.shape
        np.testing.assert_allclose(p, w, rtol=0, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", MOE)
def test_router_gradient_whole_under_expert_parallelism(four_ranks, arch):
    """The router's gradient at (1, 2), whose two ranks each run half the
    experts: nonzero, and equal to the one-rank step's within 2e-6 (the
    aux loss's part is whole on every rank and summed once; the combine
    weights' part is each rank's experts' share, summed over the group)."""
    _, out = four_ranks
    for path, g, w in zip(_paths(arch), _leaves(out, f"{arch}_tp12_grads"),
                          _leaves(out, f"{arch}_dp1_grads")):
        if "router" in path:
            assert np.abs(w).max() > 1e-4
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6,
                                       err_msg=path)


def _aux_terms(arch):
    """The reference's loss on the whole batch (one routing) and the mean
    of its losses on each half (each data rank routing its own rows)."""
    jcfg, jparams = _jax_setup(arch)
    loss = jax.jit(lambda t: JST.loss_fn(jparams, jcfg, {"tokens": t}))
    toks = jnp.asarray(TOKENS, jnp.int32)
    half = B // 2
    return (float(loss(toks)),
            (float(loss(toks[:half])) + float(loss(toks[half:]))) / 2)


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_per_data_rank_gap(four_ranks, arch):
    """ROADMAP C21: at (2, 2) each data rank routes its own rows, as the
    reference's ``layout="dp"`` does, where the reference's ``layout="tp"``
    routes the global batch.  With capacity dropping nothing only the aux
    loss differs: the first step's loss at (2, 2) minus the one-rank
    step's equals the reference's mean of per-half losses minus its
    whole-batch loss (the cross-entropy means agree), within 3e-6 (the
    losses are about 6.3 in f32, whose rounding is 4.8e-7, summed in
    different orders); at (1, 2) (data degree 1) the gap is 0 within
    that."""
    _, out = four_ranks
    whole, halves = _aux_terms(arch)
    gap_ref = halves - whole
    tp22, tp12, dp1 = (out[f"{arch}_{k}_hist"][0, 0]
                       for k in ("tp22", "tp12", "dp1"))
    assert abs(gap_ref) > 5e-6
    np.testing.assert_allclose(tp22 - dp1, gap_ref, rtol=0, atol=3e-6)
    np.testing.assert_allclose(tp12 - dp1, 0.0, rtol=0, atol=3e-6)
    print(f"{arch}: per-data-rank routing moves the first loss by "
          f"{tp22 - dp1:.3e} (reference {gap_ref:.3e})")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b",
                                  "deepseek-v2-lite-16b"])
def test_launcher_trains_under_mesh_single(arch):
    """``launch.train --reduced --mesh single --device cpu`` (the
    tensor-parallel layout on a (1, 1) mesh, on the launcher's own
    free-port rendezvous): finite losses and gradient norms, equal to
    ``--mesh dp``'s within 1e-4."""
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--log-every", "100"]
    single = TRAIN.main(argv + ["--mesh", "single"])
    dp = TRAIN.main(argv)
    assert single["tp_collectives"] is not None
    assert all(np.isfinite(single["losses"] + single["grad_norms"]))
    np.testing.assert_allclose(single["losses"], dp["losses"], rtol=1e-4)
    np.testing.assert_allclose(single["grad_norms"], dp["grad_norms"],
                               rtol=1e-4)
