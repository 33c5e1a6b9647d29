"""The int8 KV cache under the tensor-parallel layout: the port's
``decode_step`` with ``tp=`` on a sharded ``init_cache`` of reduced
qwen2-0.5b (4 query heads over 2 KV heads, f32, ``kv_cache_dtype="int8"``)
against the port's single-device int8 decode and the reference's, on the
CPU with gloo ranks.

One group of 4 ranks is spawned for the module (a ``file://`` rendezvous
in a temporary directory) while the test process runs the reference's
single-device int8 ``decode_step``.  Each rank decodes on two meshes:

* (1, 2), each pair a model group: the 2 KV heads divide the group, so
  ``k``, ``v`` and their scales are sharded by KV head and each rank
  quantises its own heads whole;
* (1, 4), the world one model group: 2 KV heads do not divide 4, so ``k``
  and ``v`` are sharded on ``head_dim`` and the scales are whole on every
  rank; each rank quantises its slice with its head's whole scale, the
  max of the slices' maxima all-reduced over the group.

Rank 0 writes, per mesh and step, the logits (whole on every rank),
``gather_caches`` of the int8 entries and scales, the model group's
all-reduces that ``StepCounter`` sees in the step and in the same step
of the non-int8 config, and the prefill's cache shards under both
configs.
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

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

ARCH, B, CACHE, STEPS, PROMPT = "qwen2-0.5b", 4, 16, 12, 6
MESHES = {"m12": 2, "m14": 4}
# an int8 entry rounded the other way moves a logit by about its scale
# times a weight (measured 5.6e-4; the port's own single-device decode is
# that far from the reference's, which rounds another entry apart), as in
# tests/test_torch_kv_int8.py; before any such entry is read, the paths
# agree to f32 rounding (measured 1.1e-6)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
EXACT_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_FLIPS = 4

_WORKER = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.dryrun import StepCounter
from repro_torch.launch.mesh import Mesh
from repro_torch.models import stacked as ST

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
inp = np.load(f"{d}/inputs.npz")
single = [dist.new_group([r]) for r in range(4)]
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
meshes = {"m12": Mesh(None, {"data": 1, "model": 2}, single[rank],
                      pairs[rank // 2]),
          "m14": Mesh(None, {"data": 1, "model": 4}, single[rank],
                      dist.group.WORLD)}
cfg8 = dataclasses.replace(get_config(meta["arch"]).reduced(),
                           kv_cache_dtype="int8")
cfg = dataclasses.replace(cfg8, kv_cache_dtype="")
with torch.device("meta"):
    tmpl = ST.init_params(cfg8, device="meta")
full = T.unflatten(tmpl, [torch.from_numpy(inp[f"p{i}"])
                          for i in range(len(T.leaves(tmpl)))])
toks = torch.from_numpy(inp["tokens"])
out = {}


def model_all_reduces(count, size):
    per = count.coll["per_op"].get("all-reduce", {"by_group": {}})
    return per["by_group"].get(size, {"count": 0})["count"]


with torch.no_grad():
    caches = ST.init_cache(cfg8, meta["B"], meta["cache"], device="cpu")
    for t in range(meta["steps"]):
        logits, caches = ST.decode_step(full, cfg8, caches, toks[:, t], t)
        out[f"dp_logits_{t}"] = logits.numpy()
    for i, c in enumerate(T.leaves(caches)):
        out[f"dp_cache_{i}"] = c.float().numpy()
    for key, mesh in meshes.items():
        size = mesh.shape["model"]
        runs = {}
        for name, c in (("int8", cfg8), ("plain", cfg)):
            tp = TP.TPContext(c, mesh.model)
            params = TP.shard_params(full, tp)
            caches = TP.shard_caches(
                ST.init_cache(c, meta["B"], meta["cache"], device="cpu"), tp)
            counts = []
            for t in range(meta["steps"]):
                with StepCounter() as count:
                    logits, caches = ST.decode_step(params, c, caches,
                                                    toks[:, t], t, tp=tp)
                counts.append(model_all_reduces(count, size))
                if name == "int8":
                    out[f"{key}_logits_{t}"] = logits.numpy()
            runs[name] = (counts, TP.gather_caches(caches, tp))
            _, pre = ST.prefill(params, c, toks[:, :meta["prompt"]],
                                meta["cache"], tp=tp)
            for i, leaf in enumerate(T.leaves(pre)):
                out[f"{key}_prefill_{name}_{i}"] = leaf.numpy()
        out[f"{key}_ar_int8"] = np.array(runs["int8"][0])
        out[f"{key}_ar_plain"] = np.array(runs["plain"][0])
        for i, c in enumerate(T.leaves(runs["int8"][1])):
            out[f"{key}_cache_{i}"] = c.float().numpy()
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jcfg():
    return dataclasses.replace(JC.get_config(ARCH).reduced(),
                               kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """The reference's single-device int8 logits and caches, and the
    4-rank group's results."""
    d = tmp_path_factory.mktemp("tpint8")
    jcfg = _jcfg()
    jparams = jax.jit(JST.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(28).integers(
        0, jcfg.vocab, (B, STEPS)).astype(np.int64)
    inputs = {f"p{i}": np.asarray(l)
              for i, l in enumerate(jax.tree.leaves(jparams))}
    np.savez(d / "inputs.npz", tokens=toks, **inputs)
    (d / "meta.json").write_text(json.dumps(
        {"arch": ARCH, "B": B, "cache": CACHE, "steps": STEPS,
         "prompt": PROMPT}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t,
                                                       p))
        caches = JST.init_cache(jcfg, B, CACHE)
        ref = []
        for t in range(STEPS):
            lg, caches = step(caches, jnp.asarray(toks[:, t], jnp.int32),
                              jnp.int32(t))
            ref.append(np.asarray(lg, np.float32))
    finally:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return ref, dict(np.load(d / "out.npz")), jcfg


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_int8_logits_match_dp_and_reference(decoded, mesh):
    """Each of 12 steps from a sharded ``init_cache``: the logits within
    ``LOGIT_TOL`` of the port's single-device int8 decode and of the
    reference's, and the first step's within ``EXACT_TOL`` (no entry it
    reads was rounded apart; measured: every step until step 2 on (1, 4)
    and step 4 on (1, 2), where dp's and the reference's part)."""
    ref, got, _ = decoded
    for t, want in enumerate(ref):
        lg = got[f"{mesh}_logits_{t}"]
        for other in (got[f"dp_logits_{t}"], want):
            np.testing.assert_allclose(
                lg, other, err_msg=f"step {t}",
                **(EXACT_TOL if t == 0 else LOGIT_TOL))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_int8_cache_equals_dp(decoded, mesh):
    """After 12 steps, the gathered int8 entries and bf16 scales against
    the single-device decode's.  The first layer's k and v reach the
    quantiser bit for bit equal on every layout (its input is the
    embedding, which the vocab-parallel lookup gives exactly), so its
    entries and scales are exactly dp's: on the ``head_dim`` layout each
    rank rounded its slice with its whole head's scale.  The second
    layer's k and v differ from dp's by the row-parallel sums' order, so
    an entry at .5 may round the other way: within 1, at most
    ``MAX_FLIPS`` of them (measured: 1 of its 16384 k and v entries a
    mesh), the scales exactly equal."""
    _, got, _ = decoded
    n = len([k for k in got if k.startswith("dp_cache_")])
    assert n == 4          # the stacked k, k_scale, v and v_scale
    flips = 0
    for i in range(n):
        g, w = got[f"{mesh}_cache_{i}"], got[f"dp_cache_{i}"]
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"leaf {i}")
        if i % 2:          # a scale
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
            continue
        assert np.abs(g - w).max() <= 1, i
        flips += int((g != w).sum())
    assert flips <= MAX_FLIPS


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_int8_max_all_reduces(decoded, mesh):
    """The model group's all-reduces a step, as ``StepCounter`` sees them:
    on the ``head_dim`` layout (1, 4) the int8 step adds one MAX
    all-reduce for k and one for v a layer to the non-int8 step's; on the
    head layout (1, 2) it adds none."""
    _, got, jcfg = decoded
    extra = got[f"{mesh}_ar_int8"] - got[f"{mesh}_ar_plain"]
    want = 2 * jcfg.n_layers if mesh == "m14" else 0
    assert extra.tolist() == [want] * STEPS
    assert (got[f"{mesh}_ar_plain"] > 0).all()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_int8_prefill_returns_plain_caches(decoded, mesh):
    """``prefill(tp=)`` under the int8 config returns the non-int8
    config's cache shards, ``k`` and ``v`` unquantised, as the
    reference's prefill does."""
    _, got, _ = decoded
    keys = sorted(k for k in got if k.startswith(f"{mesh}_prefill_int8_"))
    assert len(keys) == 2
    for k in keys:
        np.testing.assert_array_equal(got[k],
                                      got[k.replace("_int8_", "_plain_")])
