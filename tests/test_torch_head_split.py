"""RWKV-6 heads split across model ranks (ROADMAP A5c): the port's
tensor-parallel time mix where a rank's columns cut a head, against the
reference's single-device ``jax.value_and_grad`` on the CPU.

Reduced rwkv6-3b is widened to ``d_model=320`` with 5 heads of 64 in both
packages, so that 2 model ranks hold 2.5 heads each, as production's 40
heads over 16 ranks do, and 4 ranks 1.25 each.  One group of 4 gloo ranks
is spawned for the module; on a (1, 2) mesh (two of the ranks, a data
group of one) and a (1, 4) mesh each runs, from the reference's weights:
the loss and gradients (one SGD step at lr 1 with no clip moves each
parameter by minus its gradient), and one AdamW step with the clip.
"""
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

from repro import configs as JC  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import apply_updates as jax_apply  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
WIDE = dict(d_model=320, n_heads=5, n_kv_heads=5)
B, S = 4, 32
TOKENS = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int64)
EPS = 1e-6   # AdamW's eps, as tests/test_torch_tp_blocks.py sets it

_WORKER = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
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
cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), **meta["wide"])
n = len(T.leaves(ST.init_params(cfg, device="meta")))
full = T.unflatten(ST.init_params(cfg, device="meta"),
                   [torch.from_numpy(inp[f"p{i}"]) for i in range(n)])
mesh14 = make_debug_mesh((1, 4), device="cpu")
single = [dist.new_group([r]) for r in range(4)]
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
mesh12 = Mesh(None, {"data": 1, "model": 2}, single[rank], pairs[rank // 2])
out = {}
for key, mesh in (("m2", mesh12), ("m4", mesh14)):
    for what, opt, clip in (("grads", sgd(1.0), 1e9),
                            ("adamw", adamw(1e-3, weight_decay=0.01,
                                            eps=meta["eps"]), 1.0)):
        step = TS.build_train_step(cfg, layout="tp", mesh=mesh,
                                   optimizer=opt, clip_norm=clip)
        params = TP.shard_params(T.map(torch.clone, full), step.tp)
        state = opt[0](T.leaves(params))
        params, state, m = step(params, state, tokens)
        out[f"{key}_{what}_loss"] = float(m["loss"])
        new = T.leaves(TP.gather_params(params, step.tp))
        for i, (p, q) in enumerate(zip(T.leaves(full), new)):
            out[f"{key}_{what}_{i}"] = (
                (p - q) if what == "grads" else q).detach().numpy()
    out[f"{key}_calls"] = json.dumps(step.tp.calls)
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_setup():
    jcfg = dataclasses.replace(JC.get_config("rwkv6-3b").reduced(), **WIDE)
    return jcfg, JST.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("headsplit")
    _, jparams = _jax_setup()
    inputs = {"tokens": TOKENS}
    inputs.update({f"p{i}": np.asarray(l)
                   for i, l in enumerate(jax.tree.leaves(jparams))})
    np.savez(d / "inputs.npz", **inputs)
    (d / "meta.json").write_text(json.dumps({"wide": WIDE, "eps": EPS}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device loss and gradients (remat, as the
    port's step runs), and its parameters after one AdamW step with the
    clip."""
    jcfg, jparams = _jax_setup()
    toks = {"tokens": jnp.asarray(TOKENS, jnp.int32)}
    loss, grads = jax.value_and_grad(
        lambda p: JST.loss_fn(p, jcfg, toks, remat=True))(jparams)
    init, update = jax_adamw(1e-3, weight_decay=0.01, eps=EPS)
    opt = init(jax.tree.map(lambda p: p.astype(jnp.float32), jparams))
    clipped, _ = jax_clip(grads, 1.0)
    upd, _ = update(clipped, opt, jparams)
    params = jax_apply(jparams, upd)
    return (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            [np.asarray(p) for p in jax.tree.leaves(params)])


def _paths():
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), **WIDE)
    return [p for p, _ in T.leaves_with_paths(
        ST.init_params(cfg, device="meta"))]


@pytest.mark.parametrize("key,size", [("m2", 2), ("m4", 4)])
def test_split_heads_match_reference_gradients(four_ranks, reference, key,
                                               size):
    """The loss within 2e-4 (``tests/test_torch_tp_blocks.py``'s
    tolerance against the reference; measured equal at 2 ranks and 1e-6
    apart at 4); every gradient within 1e-3 of the largest element of the
    reference's leaf plus 1e-5 (f32 sums in another order; a head's
    columns lost or counted twice move a gradient by its own scale); and
    the model group's gathers: r, k and v per layer for the forward and
    remat's recompute."""
    out = four_ranks
    loss, grads, _ = reference
    np.testing.assert_allclose(out[f"{key}_grads_loss"], loss, rtol=2e-4,
                               atol=2e-4)
    for i, (path, g) in enumerate(zip(_paths(), grads)):
        got = out[f"{key}_grads_{i}"]
        assert got.shape == g.shape, path
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-3 * np.abs(g).max() + 1e-5,
                                   err_msg=path)
    calls = json.loads(str(out[f"{key}_calls"]))
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), **WIDE)
    # r, k, v of every layer, forward and recompute, and the channel mix's
    # receptance; plus the gather of the parameters at the end
    assert calls["all_gather"] >= 2 * 3 * cfg.n_layers


@pytest.mark.parametrize("key", ["m2", "m4"])
def test_split_heads_adamw_step_matches_reference(four_ranks, reference,
                                                  key):
    """One AdamW step (lr 1e-3, weight decay 0.01, clip 1.0): the
    parameters within 1e-4 of the reference's (a wrong gradient moves an
    element by about lr), as ``tests/test_torch_tp_blocks.py`` holds
    them; measured within 2.8e-5."""
    out = four_ranks
    _, _, params = reference
    np.testing.assert_allclose(out[f"{key}_adamw_loss"],
                               out[f"{key}_grads_loss"], rtol=0, atol=0)
    for i, (path, p) in enumerate(zip(_paths(), params)):
        np.testing.assert_allclose(out[f"{key}_adamw_{i}"], p, rtol=0,
                                   atol=1e-4, err_msg=path)


def test_check_heads_raises_only_for_mla():
    """RWKV-6 takes any head count the rules shard; MLA still computes
    each head whole on one rank, so a non-dividing count raises (no config
    meets it: 16 and 128 heads both divide the production degree 16)."""
    rwkv = get_config("rwkv6-3b")
    TP.check_heads(rwkv, 16)
    assert rwkv.n_heads % 16 and rwkv.d_model % 16 == 0
    for arch in ("deepseek-v2-lite-16b", "deepseek-v2-236b"):
        cfg = get_config(arch)
        TP.check_heads(cfg, 16)
        assert cfg.n_heads % 16 == 0
    odd = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              n_heads=3)
    with pytest.raises(NotImplementedError, match="MLA"):
        TP.check_heads(odd, 2)
