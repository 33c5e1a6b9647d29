"""The port's tensor-parallel training layout (``build_train_step(...,
layout="tp", mesh=...)``) against the JAX reference and against the
port's one-rank ``layout="dp"`` step, on the CPU with gloo ranks.

One group of 4 ranks is spawned for the module (a ``file://`` rendezvous
in a temporary directory); it runs every case in turn and rank 0 writes
the results, which the tests read:

* vocab-parallel embedding and cross-entropy at 4 model ranks against
  the dense versions and against ``repro.models.vocab_parallel`` (the
  twin of ``test_vocab_parallel_matches_dense``);
* the TP step on a (2, 2) mesh on reduced qwen2-0.5b: 3 steps' losses
  against the reference's single-device step (the twin of
  ``test_ddp_tp_step_matches_single_device``), and gradients, losses and
  parameters against the port's one-rank step; the same for unaligned
  heads (3 heads over 1 KV head, and 4 heads over 1 KV head) and for a
  vocab that the model group does not divide;
* gradient-sync strategies at (2, 2) on reduced tinyllama-1.1b (the twin
  of ``test_bucketing_strategies_equivalent``), fused and chunked
  ``rs_ag`` buckets included;
* ZeRO-1 at (2, 2) and in the 4-rank ``layout="dp"``: parameters
  bit-equal to the unsharded update, each moment 1/dp per rank, the
  layouts' losses equal (the twin of ``test_dp_layout_and_zero1``);
* full logits under TP;
* a ``TPContext`` at degree 2 for every architecture's reduced config.

A group of 8 ranks runs the launcher under ``--mesh debug`` from a
checkpoint that ``--mesh dp`` saved, and ``--mesh dp`` resumes from its
checkpoint."""
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

from repro import configs as JC  # noqa: E402
from repro.data.pipeline import materialize_batch  # noqa: E402
from repro.launch.mesh import make_mesh_compat  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.models import vocab_parallel as JVP  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import apply_updates as jax_apply  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHS as ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import train_step as TS  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

# name -> (arch, n_heads, n_kv_heads, vocab); 0 keeps the reduced config's
CONFIGS = {"qwen2": ("qwen2-0.5b", 0, 0, 0),
           "q3kv1": ("qwen2-0.5b", 3, 1, 0),      # q, kv unaligned at TP 2
           "q4kv1": ("tinyllama-1.1b", 4, 1, 0),  # q aligned, kv replicated
           "vocab511": ("tinyllama-1.1b", 0, 0, 511),  # head replicated
           "tinyllama": ("tinyllama-1.1b", 0, 0, 0)}
ONE_RANK = ["qwen2", "q3kv1", "q4kv1", "vocab511"]
STRATEGIES = ["per_tensor", "size_capped", "single_bucket", "fused",
              "rs_ag_chunked"]
B, S = 8, 32                  # the reference tests' batch
V, D, VB, VS = 64, 16, 2, 8   # the vocab-parallel case's shapes

_WORKER = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import train_step as TS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import stacked as ST
from repro_torch.models import vocab_parallel as VP
from repro_torch.optim import adamw, sgd

d, rank = sys.argv[1], int(sys.argv[2])
meta = json.load(open(f"{d}/meta.json"))
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
inp = np.load(f"{d}/inputs.npz")
batch = {"tokens": torch.from_numpy(inp["tokens"])}
out = {}


def setup(name):
    arch, h, kv, vocab = meta["configs"][name]
    cfg = get_config(arch).reduced()
    if h:
        cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    full = ST.init_params(cfg, seed=0, device="cpu")
    if name == "qwen2":   # the reference's weights
        full = T.unflatten(full, [torch.from_numpy(inp[f"qwen2_{i}"])
                                  for i in range(len(T.leaves(full)))])
    return cfg, full


def run(cfg, full, steps, mesh=None, group=None, strat=None, opt=None,
        clip=1.0, zero1=False):
    opt = opt or adamw(1e-3, weight_decay=0.01)
    step = TS.build_train_step(
        cfg, layout="dp" if mesh is None else "tp", mesh=mesh, group=group,
        strategy=strat or TS.GradSyncStrategy.size_capped(full, 1 << 16),
        optimizer=opt, clip_norm=clip, zero1=zero1)
    params = T.map(torch.clone, full)
    if step.tp is not None:
        params = TP.shard_params(params, step.tp)
    state = opt[0](T.leaves(params))
    hist = []
    tokens = {"tokens": batch["tokens"] % cfg.vocab}
    for _ in range(steps):
        params, state, m = step(params, state, tokens)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    if step.tp is not None:
        params = TP.gather_params(params, step.tp)
    return np.array(hist), [p.detach() for p in T.leaves(params)], state


def grads(cfg, full, **kw):
    # one SGD step at lr 1 with no clipping moves each parameter by minus
    # its synced gradient
    _, new, _ = run(cfg, full, 1, opt=sgd(1.0), clip=1e9, **kw)
    return [(p - q).numpy() for p, q in zip(T.leaves(full), new)]


def save(key, arrays):
    for i, a in enumerate(arrays):
        out[f"{key}_{i}"] = np.asarray(a)


# ---- vocab parallel at 4 model ranks
mesh14 = make_debug_mesh((1, 4), device="cpu")
g = TP.ModelGroup(mesh14.model)
toks = torch.from_numpy(inp["vp_toks"])
e_loc = g.local(torch.from_numpy(inp["vp_embed"]), 0).clone()
e_loc.requires_grad_(True)
x = VP.embed_lookup(e_loc, toks, g)
(x * torch.from_numpy(inp["vp_cot"])).sum().backward()
out["vp_embed_x"] = x.detach().numpy()
out["vp_embed_grad"] = TP.gather_leaf(e_loc.grad, 0, g.group).numpy()
for tied in (False, True):
    h = torch.from_numpy(inp["vp_h"]).requires_grad_(True)
    head = torch.from_numpy(inp["vp_embed" if tied else "vp_head"])
    loc = g.local(head, 0 if tied else 1).clone().requires_grad_(True)
    ce, cnt = VP.ce_chunk(h, loc, toks, torch.from_numpy(inp["vp_w"]), g,
                          transpose_head=tied)
    ce.backward()
    out[f"vp_ce_{tied}"] = np.array([float(ce), float(cnt)])
    out[f"vp_ce_dh_{tied}"] = h.grad.numpy()
    out[f"vp_ce_dhead_{tied}"] = TP.gather_leaf(
        loc.grad, 0 if tied else 1, g.group).numpy()

# ---- the TP step at (2, 2)
mesh22 = make_debug_mesh((2, 2), device="cpu")
# a context for every architecture: each leaf's sharded or not, and the
# leaves each decoder layer's view finds
for arch in meta["archs"]:
    cfg = get_config(arch).reduced()
    tp = TP.TPContext(cfg, mesh22.model)
    out[f"ctx_{arch}"] = np.array([d is not None for d in tp.dims])
    out[f"ctx_{arch}_layers"] = np.array(json.dumps(
        [sorted(tp.layer(li)._dims) for li in range(cfg.n_layers)]))
for name in meta["one_rank"]:
    cfg, full = setup(name)
    out[f"{name}_hist"], params, _ = run(cfg, full, 3, mesh=mesh22)
    save(f"{name}_params", params)
    save(f"{name}_grads", grads(cfg, full, mesh=mesh22))

cfg, full = setup("qwen2")
tp = TP.TPContext(cfg, mesh22.model)
with torch.no_grad():
    out["qwen2_logits"] = ST.forward(TP.shard_params(full, tp), cfg,
                                     batch["tokens"][:2], tp=tp).numpy()

# ---- gradient-sync strategies at (2, 2)
cfg, full = setup("tinyllama")
n = len(T.leaves(full))
strategies = {
    "per_tensor": TS.GradSyncStrategy.per_tensor(full),
    "size_capped": TS.GradSyncStrategy.size_capped(full, 1 << 14),
    "single_bucket": TS.GradSyncStrategy.single_bucket(full),
    "fused": TS.GradSyncStrategy([list(range(n))], chunks=[2], fused=[1]),
    "rs_ag_chunked": TS.GradSyncStrategy([list(range(n))], comms=["rs_ag"],
                                         chunks=[3])}
for sname, strat in strategies.items():
    TS.reset_collectives()
    out[f"strat_{sname}"], _, _ = run(cfg, full, 1, mesh=mesh22, strat=strat)
    out[f"strat_{sname}_collectives"] = np.array(json.dumps(TS.COLLECTIVES))

# ---- ZeRO-1 at (2, 2)
for z in (False, True):
    out[f"zero1_{z}_hist"], params, state = run(cfg, full, 2, mesh=mesh22,
                                                zero1=z)
    save(f"zero1_{z}_params", params)
    out[f"zero1_{z}_moments"] = np.array([m.numel() for m in state.mu])
    out[f"zero1_{z}_nu"] = np.array([m.numel() for m in state.nu])
# layout "dp" over all 4 ranks, with and without ZeRO-1
for z in (False, True):
    out[f"dp4_{z}_hist"], params, state = run(cfg, full, 2, zero1=z)
    save(f"dp4_{z}_params", params)
    out[f"dp4_{z}_moments"] = np.array([m.numel() for m in state.mu])
out["full_numel"] = np.array([p.numel() for p in T.leaves(full)])
out["tp_local_numel"] = np.array(
    [p.numel() for p in T.leaves(TP.shard_params(full, TP.TPContext(
        cfg, mesh22.model)))])

# ---- the port's one-rank layout="dp" step, on rank 0
g0 = dist.new_group([0])
if rank == 0:
    for name in meta["one_rank"]:
        cfg, full = setup(name)
        out[f"{name}_dp_hist"], params, _ = run(cfg, full, 3, group=g0)
        save(f"{name}_dp_params", params)
        save(f"{name}_dp_grads", grads(cfg, full, group=g0))
    cfg, full = setup("qwen2")
    with torch.no_grad():
        out["qwen2_dp_logits"] = ST.forward(full, cfg,
                                            batch["tokens"][:2]).numpy()
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(script: str, d, n: int, *args) -> None:
    procs = [subprocess.Popen([sys.executable, "-c", script, str(d), str(r),
                               *args], env=ENV, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's reduced qwen2-0.5b weights and batch, the
    vocab-parallel inputs, and the 4-rank group's results."""
    d = tmp_path_factory.mktemp("tp4")
    jcfg = JC.get_config("qwen2-0.5b").reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.asarray(materialize_batch(jcfg, B, S, seed=0)["tokens"])
    rng = np.random.default_rng(0)
    inputs = {f"qwen2_{i}": np.asarray(l)
              for i, l in enumerate(jax.tree.leaves(jparams))}
    inputs.update(
        tokens=tokens.astype(np.int64),
        vp_embed=rng.standard_normal((V, D)).astype(np.float32),
        vp_head=rng.standard_normal((D, V)).astype(np.float32),
        vp_h=rng.standard_normal((VB, VS, D)).astype(np.float32),
        vp_toks=rng.integers(0, V, (VB, VS)).astype(np.int64),
        vp_w=np.ones((VB, VS), np.float32),
        vp_cot=rng.standard_normal((VB, VS, D)).astype(np.float32))
    np.savez(d / "inputs.npz", **inputs)
    (d / "meta.json").write_text(json.dumps({"configs": CONFIGS,
                                             "one_rank": ONE_RANK,
                                             "archs": list(ALL_ARCHS)}))
    _spawn(_WORKER, d, 4)
    return jcfg, jparams, inputs, dict(np.load(d / "out.npz"))


def _leaves(out, key):
    n = len([k for k in out if k.startswith(key + "_")])
    return [out[f"{key}_{i}"] for i in range(n)]


# ----------------------------------------------------- vocab parallel
def _dense_ce(h, head, toks, w):
    logits = h @ head
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, toks[..., None], -1)[..., 0]
    return jnp.sum((logz - gold) * w)


def test_vocab_parallel_embed_matches_dense(four_ranks):
    """The lookup at 4 model ranks against ``embed[toks]`` and against the
    reference's ``embed_lookup`` (on a 1 x 1 mesh: its dense oracle),
    values and the table's gradient."""
    _, _, inp, out = four_ranks
    embed, toks = jnp.asarray(inp["vp_embed"]), jnp.asarray(inp["vp_toks"])
    np.testing.assert_allclose(out["vp_embed_x"], inp["vp_embed"][
        inp["vp_toks"]], rtol=1e-5, atol=1e-5)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    ref = jax.jit(lambda e: JVP.embed_lookup(e, toks, mesh))(embed)
    np.testing.assert_allclose(out["vp_embed_x"], np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    cot = jnp.asarray(inp["vp_cot"])
    gref = jax.jit(jax.grad(lambda e: jnp.sum(
        JVP.embed_lookup(e, toks, mesh) * cot)))(embed)
    np.testing.assert_allclose(out["vp_embed_grad"], np.asarray(gref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["vp_embed_grad"], np.asarray(jax.grad(
        lambda e: jnp.sum(e[toks] * cot))(embed)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
def test_vocab_parallel_ce_matches_dense(four_ranks, tied):
    """The CE at 4 model ranks: value within 1e-5, the gradients of the
    input and of the head within rtol 1e-4 / atol 1e-5, against the dense
    CE and the reference's ``ce_chunk``."""
    _, _, inp, out = four_ranks
    h, toks, w = (jnp.asarray(inp[k]) for k in ("vp_h", "vp_toks", "vp_w"))
    head = jnp.asarray(inp["vp_embed" if tied else "vp_head"])
    mesh = make_mesh_compat((1, 1), ("data", "model"))

    def ref(hh, hd):
        return JVP.ce_chunk(hh, hd, toks, w, mesh, transpose_head=tied)[0]

    dense = (lambda hh, hd: _dense_ce(hh, hd.T if tied else hd, toks, w))
    ce, cnt = out[f"vp_ce_{tied}"]
    assert cnt == VB * VS
    for fn in (dense, jax.jit(ref)):
        np.testing.assert_allclose(ce, float(fn(h, head)), rtol=1e-5)
        dh, dhead = jax.jit(jax.grad(fn, argnums=(0, 1)))(h, head)
        np.testing.assert_allclose(out[f"vp_ce_dh_{tied}"], np.asarray(dh),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out[f"vp_ce_dhead_{tied}"],
                                   np.asarray(dhead), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ TP step
def test_tp_step_matches_reference_single_device(four_ranks):
    """Reduced qwen2-0.5b (GQA, qkv bias, tied embeddings) on a (2, 2)
    mesh: 3 steps' losses against the reference's plain single-device
    step with the same clip and AdamW, rtol/atol 2e-4, as the reference
    holds its own TP step."""
    jcfg, jparams, inp, out = four_ranks
    init, update = jax_adamw(1e-3, weight_decay=0.01)
    opt = init(jax.tree.map(lambda p: p.astype(jnp.float32), jparams))
    batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}

    @jax.jit
    def ref_step(params, opt):
        loss, g = jax.value_and_grad(
            lambda p: JST.loss_fn(p, jcfg, batch, remat=True))(params)
        g, _ = jax_clip(g, 1.0)
        updates, opt = update(g, opt, params)
        return jax_apply(params, updates), opt, loss

    params, losses = jparams, []
    for _ in range(3):
        params, opt, loss = ref_step(params, opt)
        losses.append(float(loss))
    np.testing.assert_allclose(out["qwen2_hist"][:, 0], losses, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", ONE_RANK)
def test_tp_step_matches_one_rank_step(four_ranks, name):
    """The (2, 2) TP step against the port's one-rank ``layout="dp"`` step
    on the same weights and batch: reduced qwen2-0.5b, unaligned heads (3
    over 1 KV head: q sharded on its input dim, kv replicated; 4 over 1:
    two local heads reading the replicated KV head), and a vocab that 2
    does not divide (embedding and head replicated, the plain CE).  The synced gradients of the first step
    agree within 2e-5 (measured: within 2e-7; only the order of f32 sums
    differs), as do 3 steps' losses and grad norms, relative.  After 3
    AdamW steps at lr 1e-3 the parameters agree within 1e-4: AdamW's first
    steps move an element by about lr whatever its gradient's size, so an
    element whose gradient is near 0 moves by a fraction of lr that f32
    rounding decides (measured up to 4.6e-5 on reduced qwen2-0.5b); a
    wrong gradient moves elements by lr."""
    _, _, _, out = four_ranks
    for g, want in zip(_leaves(out, f"{name}_grads"),
                       _leaves(out, f"{name}_dp_grads")):
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[f"{name}_hist"], out[f"{name}_dp_hist"],
                               rtol=2e-5)
    for p, want in zip(_leaves(out, f"{name}_params"),
                       _leaves(out, f"{name}_dp_params")):
        assert p.shape == want.shape
        np.testing.assert_allclose(p, want, rtol=0, atol=1e-4)


def test_tp_forward_logits_match_dense(four_ranks):
    _, _, _, out = four_ranks
    np.testing.assert_allclose(out["qwen2_logits"], out["qwen2_dp_logits"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strat", STRATEGIES[1:])
def test_strategies_agree(four_ranks, strat):
    """Per-tensor, size-capped, single-bucket, a fused bucket (2 chunks)
    and a chunked ``rs_ag`` bucket (3 chunks) give one loss and gradient
    norm within 1e-4 (tensor fusion must not change the math), each with
    the data group's collectives it implies."""
    _, _, _, out = four_ranks
    np.testing.assert_allclose(out[f"strat_{strat}"],
                               out["strat_per_tensor"], rtol=1e-4)
    counts = json.loads(str(out[f"strat_{strat}_collectives"]))
    n = {"fused": 2, "rs_ag_chunked": 3}.get(strat)
    if n:
        assert counts == {"all_reduce": 0, "reduce_scatter": n,
                          "all_gather": n}
    else:
        assert counts["reduce_scatter"] == counts["all_gather"] == 0
        assert counts["all_reduce"] > 0


def test_zero1_bit_equal_and_moments_sliced(four_ranks):
    """ZeRO-1 at (2, 2): 2 steps give parameters bit-equal to the
    unsharded update's and the same losses; every moment of a leaf with a
    dim that 2 divides holds half of the local slice's elements."""
    _, _, _, out = four_ranks
    np.testing.assert_array_equal(out["zero1_True_hist"],
                                  out["zero1_False_hist"])
    for a, b in zip(_leaves(out, "zero1_True_params"),
                    _leaves(out, "zero1_False_params")):
        np.testing.assert_array_equal(a, b)
    local = out["tp_local_numel"]
    np.testing.assert_array_equal(out["zero1_False_moments"], local)
    # every leaf of reduced tinyllama has a free dim that 2 divides
    for key in ("zero1_True_moments", "zero1_True_nu"):
        np.testing.assert_array_equal(out[key], local // 2)


def test_layouts_and_zero1_agree(four_ranks):
    """The twin of ``test_dp_layout_and_zero1``: ``layout="dp"`` over the 4
    ranks, with and without ZeRO-1, and the (2, 2) ``layout="tp"`` step,
    with and without, train 2 steps to one loss (rtol 1e-4); ZeRO-1 is
    bit-equal within each layout, and keeps a quarter of each moment per
    rank in the 4-rank ``dp`` layout (every leaf has a dim that 4
    divides)."""
    _, _, _, out = four_ranks
    np.testing.assert_array_equal(out["dp4_True_hist"], out["dp4_False_hist"])
    for a, b in zip(_leaves(out, "dp4_True_params"),
                    _leaves(out, "dp4_False_params")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out["dp4_False_hist"][:, 0],
                               out["zero1_False_hist"][:, 0], rtol=1e-4)
    np.testing.assert_array_equal(out["dp4_False_moments"], out["full_numel"])
    np.testing.assert_array_equal(out["dp4_True_moments"],
                                  out["full_numel"] // 4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dense_only_and_fsdp_tp_not_ported(four_ranks, arch):
    """No architecture is refused any more (tensor parallelism covers
    MLA, the routed experts, the RG-LRU block and RWKV-6 since ROADMAP
    A5b): ``TPContext`` builds at degree 2 on every reduced config, shards
    the leaves that the rules shard at a model dim of 2, and gives each
    decoder layer a view that finds that layer's own leaves (its group's,
    without a cycle's ``b{j}``).  ``mode="fsdp_tp"`` (ZeRO-3) is ported
    since ROADMAP A4b (``tests/test_torch_fsdp.py``); built without a
    mesh it raises ``ValueError``."""
    _, _, _, out = four_ranks
    cfg = get_config(arch).reduced()
    with torch.device("meta"):
        full = ST.init_params(cfg, device="meta")
    want = [SH.spec_dim(sp) is not None
            for sp in SH.param_specs(full, {"model": 2}, cfg=cfg)]
    assert out[f"ctx_{arch}"].tolist() == want and any(want)
    layers = [sorted(SH.path_names(p) for p, _ in T.leaves_with_paths(lp))
              for lp in ST._layers(full, cfg)]
    assert json.loads(str(out[f"ctx_{arch}_layers"])) == layers
    with pytest.raises(ValueError, match="mesh"):
        TS.build_train_step(cfg, mode="fsdp_tp")


# -------------------------------------------------------- checkpoints
_LAUNCH = r"""
import sys, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch import train
d, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{d}/pg8", rank=rank,
                        world_size=8)
out = train.main(sys.argv[3:])
if rank == 0:
    open(f"{d}/debug.txt", "w").write(repr(out["losses"]))
dist.destroy_process_group()
"""


def _main_one_rank(d, name, argv) -> list:
    dist.init_process_group("gloo", init_method=f"file://{d}/{name}",
                            rank=0, world_size=1)
    try:
        return TRAIN.main(argv)["losses"]
    finally:
        dist.destroy_process_group()


def test_checkpoint_moves_between_meshes(tmp_path):
    """``--mesh dp`` saves at step 3, ``--mesh debug`` (8 ranks, (4, 2),
    layout "tp") resumes, trains steps 3-4 and saves the full tree, and
    ``--mesh dp`` resumes from that for steps 5-6: every loss equals the
    uninterrupted ``--mesh dp`` run's (rtol 1e-5: the TP step sums in
    another order)."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "8", "--seq",
            "32", "--device", "cpu", "--log-every", "100"]
    ck = str(tmp_path / "ck")
    whole = _main_one_rank(tmp_path, "a", argv + ["--steps", "7"])
    first = _main_one_rank(tmp_path, "b", argv + ["--steps", "3",
                                                  "--ckpt-dir", ck])
    _spawn(_LAUNCH, tmp_path, 8, *argv, "--steps", "5", "--ckpt-dir", ck,
           "--mesh", "debug")
    middle = eval((tmp_path / "debug.txt").read_text())
    last = _main_one_rank(tmp_path, "c", argv + ["--steps", "7",
                                                 "--ckpt-dir", ck])
    assert len(first) == 3 and len(middle) == 2 and len(last) == 2
    np.testing.assert_allclose(first + middle + last, whole, rtol=1e-5)
    # the debug mesh wrote the full tree
    a, b = (np.load(os.path.join(ck, f"step_{s:08d}", "arrays.npz"))
            for s in (3, 5))
    assert {k: a[k].shape for k in a} == {k: b[k].shape for k in b}
