"""ZeRO-3, the port's ``mode="fsdp_tp"``, on the CPU with four gloo ranks
on a (2, 2) mesh, against the reference's single-device step and the
port's ``ddp_tp`` step under ``layout="tp"``.

Reduced deepseek-coder-33b (dense GQA) and reduced deepseek-v2-236b (MLA
with routed experts, which ZeRO-3's rules shard over the data ranks, each
expert's FFN dim over ``model``) each take 2 AdamW steps from the
reference's weights and one batch in both modes.  One group of 4 ranks is
spawned for the module (a ``file://`` rendezvous in a temporary
directory); rank 0 writes the results.
"""
import functools
import json
import subprocess
import sys
import os

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
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ARCHS = ["deepseek-coder-33b", "deepseek-v2-236b"]
MOE = ["deepseek-v2-236b"]
B, S, STEPS = 8, 32, 2
TOKENS = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int64)
MESH = {"data": 2, "model": 2}
# AdamW's eps here, the port's and the reference's, as in
# ``test_torch_tp_blocks.py`` (its ``EPS`` says why)
EPS = 1e-6

_WORKER = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import train_step as TS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import stacked as ST
from repro_torch.optim import adamw

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
mesh = make_debug_mesh((2, 2), device="cpu")
inp = np.load(f"{d}/inputs.npz")
tokens = {"tokens": torch.from_numpy(inp["tokens"])}
out = {}
for arch in meta["archs"]:
    cfg = get_config(arch).reduced()
    full = ST.init_params(cfg, seed=0, device="cpu")
    full = T.unflatten(full, [torch.from_numpy(inp[f"{arch}_{i}"])
                              for i in range(len(T.leaves(full)))])
    for mode in ("ddp_tp", "fsdp_tp"):
        opt = adamw(1e-3, weight_decay=0.01, eps=meta["eps"])
        step = TS.build_train_step(cfg, mode=mode, layout="tp", mesh=mesh,
                                   optimizer=opt)
        params = TP.shard_params(T.map(torch.clone, full), step.tp)
        state = opt[0](T.leaves(params))
        key = f"{arch}_{mode}"
        out[f"{key}_local"] = json.dumps(
            [list(p.shape) for p in T.leaves(params)])
        out[f"{key}_moments"] = json.dumps(
            [list(m.shape) for m in state.mu])
        hist, calls = [], []
        for _ in range(meta["steps"]):
            before = dict(getattr(step.tp, "data_calls", {}))
            params, state, m = step(params, state, tokens)
            hist.append([float(m["loss"]), float(m["grad_norm"])])
            calls.append({k: v - before.get(k, 0) for k, v in
                          getattr(step.tp, "data_calls", {}).items()})
        out[f"{key}_hist"] = np.array(hist)
        out[f"{key}_calls"] = json.dumps(calls)
        for i, p in enumerate(T.leaves(TP.gather_params(params, step.tp))):
            out[f"{key}_params_{i}"] = p.detach().numpy()
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_setup(arch):
    jcfg = JC.get_config(arch).reduced()
    return jcfg, JST.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank group's results on the reference's weights of each
    reduced model and :data:`TOKENS`."""
    d = tmp_path_factory.mktemp("fsdp")
    inputs = {"tokens": TOKENS}
    for arch in ARCHS:
        _, jparams = _jax_setup(arch)
        inputs.update({f"{arch}_{i}": np.asarray(l)
                       for i, l in enumerate(jax.tree.leaves(jparams))})
    np.savez(d / "inputs.npz", **inputs)
    (d / "meta.json").write_text(json.dumps({"archs": ARCHS, "steps": STEPS,
                                             "eps": EPS}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return dict(np.load(d / "out.npz"))


def _full(arch):
    with torch.device("meta"):
        return ST.init_params(get_config(arch).reduced(), device="meta")


def _specs(arch):
    return SH.param_specs(_full(arch), MESH, fsdp=True,
                          cfg=get_config(arch).reduced())


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """:data:`STEPS` steps of the reference's plain single-device step on
    :data:`TOKENS` (``jax.value_and_grad``, remat, clip 1.0, AdamW at 1e-3
    with weight decay 0.01 and eps :data:`EPS`): the losses and gradient
    norms, and the parameters after them.  For the MoE model the loss is
    the mean of the losses of the batch's two halves, each routed alone,
    as the (2, 2) mesh's data ranks route their own rows (ROADMAP C21)."""
    jcfg, params = _jax_setup(arch)
    parts = 2 if arch in MOE else 1
    init, update = jax_adamw(1e-3, weight_decay=0.01, eps=EPS)
    opt = init(jax.tree.map(lambda p: p.astype(jnp.float32), params))
    toks = jnp.asarray(TOKENS, jnp.int32).reshape(parts, -1, S)

    def loss_fn(p):
        return sum(JST.loss_fn(p, jcfg, {"tokens": t}, remat=True)
                   for t in toks) / parts

    @jax.jit
    def ref_step(params, opt):
        loss, g = jax.value_and_grad(loss_fn)(params)
        g, gnorm = jax_clip(g, 1.0)
        updates, opt = update(g, opt, params)
        return jax_apply(params, updates), opt, loss, gnorm

    hist = []
    for _ in range(STEPS):
        params, opt, loss, gnorm = ref_step(params, opt)
        hist.append([float(loss), float(gnorm)])
    return np.array(hist), [np.asarray(p) for p in jax.tree.leaves(params)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_matches_reference_single_device(four_ranks, arch):
    """The (2, 2) ``fsdp_tp`` step against the reference's single-device
    ``value_and_grad`` and AdamW on the same weights and batch, at
    ``test_torch_tp_blocks.py``'s tolerances: 2 steps' losses within
    2e-4 (rtol and atol, as the reference holds its own TP step), the
    first gradient norm within 2e-5 relative, and the parameters after 2
    steps within 1e-4 (a wrong gradient moves elements by about lr,
    1e-3).  The later grad norm is not compared, as there."""
    out = four_ranks
    hist, params = _reference(arch)
    got = out[f"{arch}_fsdp_tp_hist"]
    np.testing.assert_allclose(got[:, 0], hist[:, 0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0, 1], hist[0, 1], rtol=2e-5)
    for (path, _), i in zip(T.leaves_with_paths(_full(arch)),
                            range(len(params))):
        p = out[f"{arch}_fsdp_tp_params_{i}"]
        assert p.shape == params[i].shape, path
        np.testing.assert_allclose(p, params[i], rtol=0, atol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_matches_ddp_tp(four_ranks, arch):
    """2 steps' losses and gradient norms within 1e-5 relative, and the
    parameters after them within 1e-5 (f32; only the order of sums
    differs: ZeRO-3 gathers each layer's weights and reduce-scatters their
    gradients where ``ddp_tp`` all-reduces them)."""
    out = four_ranks
    f, d = out[f"{arch}_fsdp_tp_hist"], out[f"{arch}_ddp_tp_hist"]
    np.testing.assert_allclose(f, d, rtol=1e-5)
    n = len(T.leaves(_full(arch)))
    for (path, _), i in zip(T.leaves_with_paths(_full(arch)), range(n)):
        np.testing.assert_allclose(out[f"{arch}_fsdp_tp_params_{i}"],
                                   out[f"{arch}_ddp_tp_params_{i}"],
                                   rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_holds_zero3_shards(four_ranks, arch):
    """Each leaf and both AdamW moments are held as this rank's slice
    under the rules' ``fsdp=True`` specs: every dim over ``model`` or the
    data dims halved; the experts over the data ranks."""
    out = four_ranks
    local = json.loads(str(out[f"{arch}_fsdp_tp_local"]))
    moments = json.loads(str(out[f"{arch}_fsdp_tp_moments"]))
    specs = _specs(arch)
    want = [[s // 2 if e is not None else s for s, e in zip(p.shape, sp)]
            for p, sp in zip(T.leaves(_full(arch)), specs)]
    assert local == want == moments
    n_data = sum(SH.spec_dim(sp, "data") is not None for sp in specs)
    assert 0 < n_data < len(specs)
    if "moe" in json.dumps([p for p, _ in
                            T.leaves_with_paths(_full(arch))]):
        for (path, _), sp in zip(T.leaves_with_paths(_full(arch)), specs):
            if "['moe']['w_" in path:
                assert sp[1] == "data" and sp[-1] == "model", path


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_collectives_per_step(four_ranks, arch):
    """Per step, over the data group: one reduce-scatter per data-sharded
    leaf per layer (the gather's backward, its mean over the data ranks),
    and one all-gather per data-sharded leaf per layer twice (forward and
    remat's recompute) or once for a leaf outside the layers (the final
    norm); one all-reduce for the clip's norm.  For reduced
    deepseek-coder-33b (2 layers of 9 data-sharded leaves, and the final
    norm) that is 19 reduce-scatters and 37 all-gathers."""
    out = four_ranks
    calls = json.loads(str(out[f"{arch}_fsdp_tp_calls"]))
    rs = ag = 0
    for (path, leaf), sp in zip(T.leaves_with_paths(_full(arch)),
                                _specs(arch)):
        if SH.spec_dim(sp, "data") is None:
            continue
        layers = leaf.shape[0] if path.startswith("['groups']") else 1
        rs += layers
        ag += 2 * layers if path.startswith("['groups']") else 1
    assert calls == [{"reduce_scatter": rs, "all_gather": ag,
                      "all_reduce": 1}] * STEPS
    if arch == "deepseek-coder-33b":
        assert (rs, ag) == (19, 37)


def test_fsdp_refuses_a_strategy():
    """ZeRO-3 enacts no DisCo buckets, as in the reference: a strategy
    (or ZeRO-1) raises rather than being ignored; the mode needs a
    mesh."""
    cfg = get_config("deepseek-coder-33b").reduced()
    strat = TS.GradSyncStrategy.per_tensor(_full("deepseek-coder-33b"))
    with pytest.raises(ValueError, match="no strategy"):
        TS.build_train_step(cfg, mode="fsdp_tp", strategy=strat)
    with pytest.raises(ValueError, match="no strategy"):
        TS.build_train_step(cfg, mode="fsdp_tp", zero1=True)
    with pytest.raises(ValueError, match="mesh"):
        TS.build_train_step(cfg, mode="fsdp_tp")
