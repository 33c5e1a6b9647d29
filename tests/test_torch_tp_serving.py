"""Serving under the tensor-parallel layout: the port's ``prefill`` and
``decode_step`` with ``tp=`` on model-sharded weights and caches, against
the reference's single-device ``stacked.prefill`` and ``decode_step``, on
the CPU with gloo ranks.

One group of 4 ranks is spawned for the module (a ``file://`` rendezvous
in a temporary directory) while the test process runs the reference.  Each
rank runs every case on a (1, 2) mesh (its pair's model group, a data group
of one rank: both pairs serve every row) and on a (2, 2) mesh (each data
rank serving its half of the rows): from the reference's weights, a
``prefill`` through the kernels' plain versions, then 4 greedy
``decode_step`` calls, each fed the token its own logits pick.  The model
group's first rank writes, after the prefill and after each step, the
logits (whole on every rank) and ``gather_caches`` of its rows.

The cases cover every serving layout of the rules:

* ``qwen2``: 4 query heads over 2 KV heads, aligned at degree 2: the
  caches hold each rank's KV heads (with the QKV biases);
* ``paligemma``: 1 KV head, so the caches hold each rank's slice of
  ``head_dim`` (partial scores summed over the group), after the VLM
  prefix;
* ``q3kv1``: 3 query heads over 1 KV head, unaligned: q from a sharded
  input dim, every rank attending with every head over its ``head_dim``
  slice;
* ``recurrentgemma``: the RG-LRU block's ``h`` and ``conv`` sharded on
  the width, and local attention over 1 KV head with its window of 64,
  decoded past the window (the ring buffer wraps);
* ``rwkv6``: 5 heads of 64 (2.5 a rank): ``prev`` sharded on the width,
  ``wkv`` whole on every rank, every head run where a state is kept;
* ``deepseek``: MLA's ``c_kv`` and ``k_rope`` sharded on their last dim,
  the experts sharded by expert, each data rank routing its own rows
  (ROADMAP C21: the capacity drops no token here, so that routing equals
  the reference's over the whole batch);
* ``deepseek236``: the same block under ZeRO-3 (``mode="fsdp_tp"``'s
  layout: experts over the data ranks, each expert's FFN dim over
  ``model``; each layer gathered over the data ranks where it runs), as
  the dry run decodes deepseek-v2-236b;
* ``seamless``: the encoder under TP and each decode step's
  cross-attention over this data rank's rows of ``memory``.
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

# name -> (arch, config changes, prompt length, cache length)
CASES = {
    "qwen2": ("qwen2-0.5b", {}, 12, 20),
    "paligemma": ("paligemma-3b", {}, 12, 28),
    "q3kv1": ("qwen2-0.5b", dict(n_heads=3, n_kv_heads=1), 12, 20),
    "recurrentgemma": ("recurrentgemma-9b", {}, 62, 64),
    "rwkv6": ("rwkv6-3b", dict(d_model=320, n_heads=5, n_kv_heads=5), 12,
              20),
    "deepseek": ("deepseek-v2-lite-16b", {}, 12, 20),
    "deepseek236": ("deepseek-v2-236b", {}, 12, 20),
    "seamless": ("seamless-m4t-medium", {}, 12, 20),
}
FSDP = {"deepseek236"}
B, STEPS = 4, 4
MESHES = ("m12", "m22")
TOL = dict(rtol=1e-4, atol=1e-4)

_WORKER = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import stacked as ST

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
inp = np.load(f"{d}/inputs.npz")
mesh22 = make_debug_mesh((2, 2), device="cpu")
single = [dist.new_group([r]) for r in range(4)]
mesh12 = Mesh(None, {"data": 1, "model": 2}, single[rank], mesh22.model)
out = {}
for name, (arch, kw, S, CL) in meta["cases"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    with torch.device("meta"):
        tmpl = ST.init_params(cfg, device="meta")
    full = T.unflatten(tmpl, [torch.from_numpy(inp[f"{name}_{i}"])
                              for i in range(len(T.leaves(tmpl)))])
    for key, mesh in (("m12", mesh12), ("m22", mesh22)):
        if name in meta["fsdp"]:
            tp = TP.TPContext(cfg, mesh.model, data=mesh.data,
                              mesh_shape=mesh.shape)
        else:
            tp = TP.TPContext(cfg, mesh.model)
        params = TP.shard_params(full, tp)
        n = meta["B"] // mesh.shape["data"]
        rows = slice(dist.get_rank(mesh.data) * n,
                     (dist.get_rank(mesh.data) + 1) * n)
        stubs = {k: torch.from_numpy(inp[f"{name}_{k}"])[rows]
                 for k in ("prefix_emb", "enc_frames")
                 if f"{name}_{k}" in inp}
        toks = torch.from_numpy(inp[f"{name}_tokens"])[rows]
        with torch.no_grad():
            logits, caches = ST.prefill(params, cfg, toks, CL,
                                        use_kernels=True, tp=tp, **stubs)
            memory = (ST.encode(params, cfg, stubs["enc_frames"], tp)
                      if "enc_frames" in stubs else None)
            pos = cfg.vlm_prefix_len + S
            hist = [(logits, TP.gather_caches(caches, tp))]
            for t in range(meta["steps"]):
                nxt = logits.argmax(-1)
                logits, caches = ST.decode_step(params, cfg, caches, nxt,
                                                pos + t, memory=memory,
                                                tp=tp)
                hist.append((logits, TP.gather_caches(caches, tp)))
        for t, (lg, cs) in enumerate(hist):
            out[f"{name}_{key}_logits_{t}"] = lg.numpy()
            for i, c in enumerate(T.leaves(cs)):
                out[f"{name}_{key}_cache_{t}_{i}"] = c.numpy()
if dist.get_rank(mesh22.model) == 0:
    np.savez(f"{d}/out_{dist.get_rank(mesh22.data)}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jcfg(name):
    arch, kw, _, _ = CASES[name]
    return dataclasses.replace(JC.get_config(arch).reduced(), **kw)


def _inputs(name, jcfg):
    """The case's prompt (and stub frontend inputs), drawn from a seed."""
    _, _, S, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    out = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int64)}
    if jcfg.vlm_prefix_len:
        out["prefix_emb"] = rng.standard_normal(
            (B, jcfg.vlm_prefix_len, jcfg.d_model)).astype(np.float32)
    if jcfg.encdec is not None:
        out["enc_frames"] = rng.standard_normal(
            (B, jcfg.encdec.enc_seq, jcfg.encdec.frontend_dim)
        ).astype(np.float32)
    return out


def _reference(name, jcfg, jparams, inp):
    """The reference's single-device prefill and 4 greedy decode steps:
    the logits and caches after each, and the tokens it picked."""
    _, _, S, CL = CASES[name]
    stubs = {k: jnp.asarray(v) for k, v in inp.items() if k != "tokens"}
    logits, caches = jax.jit(lambda t: JST.prefill(
        jparams, jcfg, t, CL, prefix_emb=stubs.get("prefix_emb"),
        enc_frames=stubs.get("enc_frames")))(
            jnp.asarray(inp["tokens"], jnp.int32))
    memory = (JST.encode(jparams, jcfg, stubs["enc_frames"])
              if "enc_frames" in stubs else None)
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p,
                                                   memory=memory))
    hist, picked = [(logits, caches)], []
    pos = jcfg.vlm_prefix_len + S
    for t in range(STEPS):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        picked.append(np.asarray(nxt))
        logits, caches = step(caches, nxt, jnp.int32(pos + t))
        hist.append((logits, caches))
    return ([(np.asarray(lg), [np.asarray(c) for c in jax.tree.leaves(cs)])
             for lg, cs in hist], picked)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's reference results, and the 4-rank group's: the rows
    of both data ranks joined, per mesh."""
    d = tmp_path_factory.mktemp("tpserve")
    inputs, jsetup = {}, {}
    for name in CASES:
        jcfg = _jcfg(name)
        jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
        inp = _inputs(name, jcfg)
        inputs.update({f"{name}_{k}": v for k, v in inp.items()})
        inputs.update({f"{name}_{i}": np.asarray(l)
                       for i, l in enumerate(jax.tree.leaves(jparams))})
        jsetup[name] = (jcfg, jparams, inp)
    np.savez(d / "inputs.npz", **inputs)
    (d / "meta.json").write_text(json.dumps(
        {"cases": CASES, "fsdp": sorted(FSDP), "B": B, "steps": STEPS}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r)],
                              env=ENV, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        ref = {name: _reference(name, *jsetup[name]) for name in CASES}
    finally:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    parts = [dict(np.load(d / f"out_{i}.npz")) for i in range(2)]
    got = {}
    for key in parts[0]:
        mesh = key.split("_")[1]
        got[key] = (parts[0][key] if mesh == "m12" else np.concatenate(
            [parts[0][key], parts[1][key]], axis=_row_axis(key)))
    # both pairs of the (1, 2) mesh serve every row: they must agree
    for key in parts[0]:
        if key.split("_")[1] == "m12":
            np.testing.assert_array_equal(parts[0][key], parts[1][key])
    return ref, got


def _row_axis(key: str) -> int:
    """The batch dim of a result: 0 for logits, 1 for a stacked cache
    leaf (behind the layer dim)."""
    return 0 if "_logits_" in key else 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(CASES))
def test_tp_serving_matches_reference(served, name, mesh):
    """After the prefill and after each of 4 decode steps: the logits
    (whole on every rank) and every leaf of ``gather_caches`` within
    rtol/atol 1e-4 of the reference's single-device prefill and decode
    steps, and the greedy token each step feeds equal to the one the
    reference picks."""
    ref, got = served
    hist, picked = ref[name]
    for t, (jl, jcs) in enumerate(hist):
        lg = got[f"{name}_{mesh}_logits_{t}"]
        np.testing.assert_allclose(lg, jl, err_msg=f"step {t}", **TOL)
        if t < STEPS:
            np.testing.assert_array_equal(lg.argmax(-1), picked[t])
        assert len([k for k in got
                    if k.startswith(f"{name}_{mesh}_cache_{t}_")]) == len(jcs)
        for i, jc in enumerate(jcs):
            c = got[f"{name}_{mesh}_cache_{t}_{i}"]
            assert c.shape == jc.shape, (t, i)
            np.testing.assert_allclose(c, jc, err_msg=f"step {t} leaf {i}",
                                       **TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_prefill_states_hold_no_activations(arch):
    """Every leaf of a per-layer prefill's caches owns exactly its own
    bytes: the RG-LRU's ``h`` and ``conv`` and RWKV-6's ``prev`` were views
    of each layer's last position, which kept the layer's whole (B, S,
    width) activations alive as long as the caches (the dry run of
    rwkv6-3b's ``prefill_32k`` counted a temp of 25.4 GiB a device so, 6.0
    with copies)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    with torch.no_grad():
        _, caches = M.prefill(params, cfg, toks, 64)
    for path, leaf in T.leaves_with_paths(caches):
        assert leaf.untyped_storage().nbytes() == \
            leaf.numel() * leaf.element_size(), path
