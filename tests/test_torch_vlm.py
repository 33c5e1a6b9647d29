"""The VLM prefix decoder (paligemma-3b: stub patch embeddings through
``vision_proj`` before the text tokens) against the JAX reference, on
the CPU at the reduced config in f32, with the reference's weights
(``ST.init_params(PRNGKey(0))``, bridged) and batch
(``materialize_batch(seed=0)``).

The cases marked "shared" take the module's ``arch`` fixture:
``tests/test_torch_encdec.py`` imports them and runs them on
seamless-m4t-medium through its own.  They hold the stacked and
per-layer trees (key paths, shapes, dtypes, full width and reduced), the
batch, forward logits and loss (rtol/atol 1e-5), gradients with remat
(rtol 1e-4, atol 1e-6), prefill against the reference's with its flash
kernel in interpret mode (5e-4), ``decode_step`` stepping equal to
``forward`` (2e-3, the reference's), the tracer's gradient markers and
DOT FLOPs, the launcher's ``--strategy auto`` with an npz save and
resume, and ``layout="tp"`` on a (2, 2) gloo mesh against the one-rank
step (gradients 2e-5, parameters 1e-4)."""
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.plan as RP  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import trace as RTRACE  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import stacked as JST  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DOT, OPAQUE, trace as PTRACE  # noqa: E402
from repro_torch.data import pipeline as PDP  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

ARCH = "paligemma-3b"
B, S = 2, 32
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def arch():
    return ARCH


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Reduced configs, the reference's stacked and per-layer weights and
    the port's bridged copies, the reference's batch and the port's."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jst = JST.init_params(jax.random.PRNGKey(0), jcfg)
    jlay = JM.init_params(jax.random.PRNGKey(0), jcfg)
    st, lay = (params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
               for p in (jst, jlay))
    jbatch = JP.materialize_batch(jcfg, B, S, seed=0)
    batch = PDP.materialize_batch(cfg, B, S, seed=0, device="cpu")
    return jcfg, cfg, jst, jlay, st, lay, jbatch, batch


def _stubs(batch) -> dict:
    return {k: v for k, v in batch.items() if k != "tokens"}


def _paths(pairs) -> list:
    return [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in pairs]


def _jax_paths(tree) -> list:
    return _paths((jax.tree_util.keystr(p), l) for p, l in
                  jax.tree_util.tree_flatten_with_path(tree)[0])


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------ shared cases
@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("model", ["stacked", "layers"])
def test_tree_matches_reference(arch, model, width):
    """Shared.  Key paths (the reference's ``keystr``), shapes and dtypes
    in leaf order, so a Plan's bucket indices name the same tensors in
    both packages: the port's own tree on meta tensors against the
    reference's ``jax.eval_shape`` (nothing drawn), and at reduced width
    the bridged weights too."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    if width == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    JMM, MM = (JST, ST) if model == "stacked" else (JM, M)
    want = _jax_paths(jax.eval_shape(lambda k: JMM.init_params(k, jcfg),
                                     jax.random.PRNGKey(0)))
    with torch.device("meta"):
        own = MM.init_params(cfg, device="meta")
    assert _paths(T.leaves_with_paths(own)) == want
    top = [p for p, _, _ in want if "layers" not in p and "groups" not in p]
    assert any("vision_proj" in p or "in_proj" in p for p in top)
    if width == "reduced":
        _, _, _, _, st, lay, _, _ = _setup(arch)
        bridged = st if model == "stacked" else lay
        assert _paths(T.leaves_with_paths(bridged)) == want


def test_batch_matches_reference(arch):
    """Shared.  ``materialize_batch`` bitwise the reference's arrays (the
    stubs f32, from ``default_rng(seed + 1)``), and ``make_batch_specs``
    its shapes and the stubs' bf16."""
    jcfg, cfg, _, _, _, _, jbatch, batch = _setup(arch)
    assert sorted(batch) == sorted(jbatch) and len(batch) == 2
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
        assert batch[k].dtype == (torch.int64 if k == "tokens"
                                  else torch.float32)
    for c, jc in ((cfg, jcfg), (get_config(arch), jax_config(arch))):
        specs, jspecs = (PDP.make_batch_specs(c, 4, 2048),
                         JP.make_batch_specs(jc, 4, 2048))
        assert sorted(specs) == sorted(jspecs)
        for k, v in jspecs.items():
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == v.shape
            if k != "tokens":
                assert specs[k].dtype == torch.bfloat16 == \
                    getattr(torch, str(v.dtype))


@pytest.mark.parametrize("model", ["stacked", "layers"])
def test_forward_and_loss_match_reference(arch, model):
    """Shared.  Text logits (the prefix's sliced off) and the loss, rtol
    and atol 1e-5, as tests/test_torch_model.py holds the dense models."""
    jcfg, cfg, jst, jlay, st, lay, jbatch, batch = _setup(arch)
    JMM, MM, jp, p = ((JST, ST, jst, st) if model == "stacked"
                      else (JM, M, jlay, lay))
    jlogits, _ = jax.jit(lambda p, b: JMM.forward(
        p, jcfg, b["tokens"], **_stubs(b)))(jp, jbatch)
    jloss = jax.jit(lambda p, b: JMM.loss_fn(p, jcfg, b))(jp, jbatch)
    with torch.no_grad():
        logits = MM.forward(p, cfg, batch["tokens"], **_stubs(batch))
        if model == "layers":
            logits = logits[0]
        loss = MM.loss_fn(p, cfg, batch)
    assert logits.shape == (B, S, cfg.vocab)
    _close(logits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("model", ["stacked", "layers"])
def test_grads_with_remat_match_reference(arch, model):
    """Shared.  Every leaf's gradient of the loss with remat (each decoder
    layer and cross-entropy chunk recomputed in the backward; the encoder
    is not, as in the reference), rtol 1e-4 and atol 1e-6."""
    jcfg, cfg, jst, jlay, st, lay, jbatch, batch = _setup(arch)
    JMM, MM, jp, p = ((JST, ST, jst, st) if model == "stacked"
                      else (JM, M, jlay, lay))
    jgrads = jax.jit(jax.grad(lambda p: JMM.loss_fn(
        p, jcfg, jbatch, remat=True)))(jp)
    leaves = [l.detach().clone().requires_grad_(True) for l in T.leaves(p)]
    loss = MM.loss_fn(T.unflatten(p, leaves), cfg, batch, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for (path, _), g, jg in zip(T.leaves_with_paths(p), grads, jleaves):
        _close(g, jg, rtol=1e-4, atol=1e-6, err_msg=path)


def test_prefill_matches_reference_flash(arch):
    """Shared.  ``prefill(use_kernels=True)`` against the reference's, whose
    decoder self-attention runs its Pallas flash kernel in interpret mode
    (the port's wrapper takes its plain version on the CPU): the last
    logits and every cache leaf (the prefix's k and v at positions
    0..P-1), 5e-4 as tests/test_torch_serving.py holds them."""
    jcfg, cfg, jst, _, st, _, _, _ = _setup(arch)
    P = cfg.vlm_prefix_len
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 64 - P))
    full = PDP.materialize_batch(cfg, 1, 64 - P, seed=2, device="cpu")
    stubs = _stubs(full)
    jl, jc = JST.prefill(jst, jcfg, jnp.asarray(toks, jnp.int32), 96,
                         use_kernels=True,
                         **{k: jnp.asarray(v.numpy()) for k, v in
                            stubs.items()})
    with torch.no_grad():
        logits, caches = ST.prefill(st, cfg, torch.from_numpy(toks), 96,
                                    use_kernels=True, **stubs)
    _close(logits, jl, rtol=5e-4, atol=5e-4)
    jleaves = jax.tree.leaves(jc)
    assert len(T.leaves(caches)) == len(jleaves) == 2
    for g, w in zip(T.leaves(caches), jleaves):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=5e-4, atol=5e-4)


def test_decode_steps_match_forward(arch):
    """Shared.  A prefill of the prefix and the first 4 text tokens, then
    ``decode_step`` over the rest (at positions P + t, cross-attending the
    encoder's output passed as ``memory``): each step's logits equal the
    port's ``forward`` at that token, and the reference's, within 2e-3
    (the reference's decode test)."""
    jcfg, cfg, jst, _, st, _, jbatch, batch = _setup(arch)
    jlogits, _ = JST.forward(jst, jcfg, jbatch["tokens"], **_stubs(jbatch))
    toks, stubs = batch["tokens"], _stubs(batch)
    P = cfg.vlm_prefix_len
    with torch.no_grad():
        full = ST.forward(st, cfg, toks, **stubs)
        memory = (ST.encode(st, cfg, stubs["enc_frames"])
                  if cfg.encdec else None)
        lg, caches = ST.prefill(st, cfg, toks[:, :4], 64, **stubs)
        steps = [lg]
        for t in range(4, S):
            lg, caches = ST.decode_step(st, cfg, caches, toks[:, t], P + t,
                                        memory=memory)
            steps.append(lg)
    got = torch.stack(steps, 1)      # logits after tokens 3 .. S-1
    for want in (full[:, 3:], jlogits[:, 3:]):
        _close(got, want, rtol=2e-3, atol=2e-3)


def _ref_dot_flops(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        sub = RTRACE._find_subjaxpr(eqn)
        if sub is not None:
            trips = (float(eqn.params["length"])
                     if eqn.primitive.name == "scan" else 1.0)
            total += trips * _ref_dot_flops(sub)
        elif eqn.primitive.name == "dot_general":
            total += RTRACE._dot_flops(eqn)
    return total


def _markers(g) -> list:
    return [(g.prims[g.grad_prim[i]].grad_bytes,
             g.prims[g.grad_prim[i]].grad_sig,
             g.prims[g.grad_prim[i]].op_type == "grad_identity")
            for i in range(len(g.grad_prim))]


def test_trace_matches_reference(arch):
    """Shared.  The trace of the stacked step as the facade makes it (batch
    8 x 64 with the stub inputs, on meta tensors) against the reference's
    ``trace_model_graph``: the gradient markers, one OPAQUE prim for each
    of the reference's scans (the decoder's layers, the encoder's, the
    chunked cross-entropy; forward and backward) each pricing the
    reference's within 1e-2, and the DOT FLOPs of the uncollapsed trace
    equal to the reference's jaxpr's."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    ref = RP.trace_model_graph(jcfg, batch=8, seq=64, reduced=False)
    with torch.device("meta"):
        meta = ST.init_params(cfg, device="meta")
    # the facade's trace, with its regions collapsed and without
    gm, regions = PTRACE.trace_fx(
        lambda p, b: ST.loss_fn(p, cfg, b), meta,
        PDP.materialize_batch(cfg, 8, 64, device="meta"))
    port, flat = (PTRACE.graph_from_fx(gm, r, *PTRACE.grad_markers(meta))
                  for r in (regions, []))
    assert _markers(port) == _markers(ref)
    scans = sorted(p.flops for p in ref.prims if p.op_type == "scan")
    opaque = sorted(p.flops for p in port.prims if p.category == OPAQUE)
    assert len(opaque) == len(scans) == (6 if cfg.encdec else 4)
    for a, b in zip(opaque, scans):
        assert math.isclose(a, b, rel_tol=1e-2)
    jp = JST.init_params(jax.random.PRNGKey(0), jcfg)
    data = JP.materialize_batch(jcfg, 8, 64, seed=0)
    want = _ref_dot_flops(jax.make_jaxpr(jax.grad(
        lambda p, b: JST.loss_fn(p, jcfg, b)))(jp, data).jaxpr)
    assert math.isclose(sum(p.flops for p in flat.prims
                            if p.category == DOT), want, rel_tol=1e-9)
    assert sorted(port.topo_groups()) == sorted(port.groups)


def test_launcher_searches_saves_and_resumes(arch, tmp_path):
    """Shared.  ``train.main --arch <arch> --reduced --strategy auto`` on
    the CPU: the traced step (with the stubs) searched on
    ``h100_superpod``, 2 steps through the Plan's buckets with finite
    losses, an npz checkpoint holding the new subtrees in the reference's
    layout, and a second run through the saved Plan resuming from it."""
    from repro_torch.launch import train as TRAIN

    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--log-every", "100"]
    plan = str(tmp_path / "plan.json")
    first = TRAIN.main(argv + ["--steps", "2", "--strategy", "auto",
                               "--cluster", "h100_superpod", "--plan-out",
                               plan])
    assert len(first["losses"]) == 2
    assert all(math.isfinite(l) for l in first["losses"]
               + first["grad_norms"])
    n = first["plan"].provenance["grad_tensors"]
    assert sorted(i for b in first["plan"].buckets for i in b) == \
        list(range(n))
    meta = json.load(open(tmp_path / "ck" / "step_00000002" / "meta.json"))
    paths = [v["path"] for v in meta["leaves"].values()]
    want = _jax_paths(jax.eval_shape(
        lambda k: JST.init_params(k, jax_config(arch).reduced()),
        jax.random.PRNGKey(0)))
    assert paths[:n] == [f"[0]{p}" for p, _, _ in want]
    resumed = TRAIN.main(argv + ["--steps", "3", "--strategy-file", plan])
    assert len(resumed["losses"]) == 1     # step 2 only
    assert math.isfinite(resumed["losses"][0])


_TP_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data.pipeline import materialize_batch
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import train_step as TS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import stacked as ST
from repro_torch.optim import adamw, sgd

d, rank, arch = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=4)
cfg = get_config(arch).reduced()
full = ST.init_params(cfg, seed=0, device="cpu")
batch = materialize_batch(cfg, 8, 32, seed=0, device="cpu")
out = {}


def run(steps, mesh=None, group=None, opt=None, clip=1.0, calls=None):
    opt = opt or adamw(1e-3, weight_decay=0.01)
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
        params, state, m = step(params, state, batch)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    if step.tp is not None:
        if calls:
            out[calls] = np.array(json.dumps(step.tp.calls))
        params = TP.gather_params(params, step.tp)
    return np.array(hist), [p.detach() for p in T.leaves(params)]


def record(tag, **kw):
    out[f"{tag}_hist"], params = run(3, calls=f"{tag}_calls", **kw)
    # one SGD step at lr 1 with no clipping moves each parameter by minus
    # its synced gradient
    _, new = run(1, opt=sgd(1.0), clip=1e9, **kw)
    for i, (p, q, f) in enumerate(zip(params, new, T.leaves(full))):
        out[f"{tag}_params_{i}"] = p.numpy()
        out[f"{tag}_grads_{i}"] = (f - q).numpy()


record("tp", mesh=make_debug_mesh((2, 2), device="cpu"))
g0 = dist.new_group([0])
if rank == 0:
    record("dp", group=g0)
    np.savez(f"{d}/out.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def test_tp_step_matches_one_rank_step(arch, tmp_path):
    """Shared.  ``layout="tp"`` on a (2, 2) gloo mesh (the decoder's, the
    encoder's and the cross-attention's heads and FFN columns over 2
    model ranks; ``vision_proj`` and ``in_proj`` replicated) against the
    port's one-rank ``layout="dp"`` step on the same weights and batch
    (stubs included), at tests/test_torch_tensor_parallel.py's
    tolerances: the first step's synced gradients within 2e-5, 3 steps'
    losses and gradient norms within 2e-5 relative, the parameters after
    them within 1e-4; and the model group ran its all-reduces."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _TP_WORKER,
                               str(tmp_path), str(r), arch], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    out = dict(np.load(tmp_path / "out.npz"))
    n = len([k for k in out if k.startswith("dp_grads_")])
    assert n == len([k for k in out if k.startswith("tp_grads_")]) > 0
    for i in range(n):
        np.testing.assert_allclose(out[f"tp_grads_{i}"], out[f"dp_grads_{i}"],
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(out[f"tp_params_{i}"],
                                   out[f"dp_params_{i}"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["tp_hist"], out["dp_hist"], rtol=2e-5)
    assert json.loads(str(out["tp_calls"]))["all_reduce"] > 0


# --------------------------------------------------------- the VLM's own
def test_prefix_is_projected_and_not_scaled():
    """The prefix takes positions 0..P-1 as ``prefix_emb @ vision_proj``
    (an identity), with no sqrt(d) scale; the tied embedding's scale
    applies to the text tokens only; the text tokens follow at P."""
    _, cfg, _, _, st, _, _, batch = _setup(ARCH)
    P = cfg.vlm_prefix_len
    x, pos = M._embed_positions(st, cfg, batch["tokens"],
                                prefix_emb=batch["prefix_emb"])
    assert x.shape == (B, P + S, cfg.d_model)
    torch.testing.assert_close(x[:, :P], batch["prefix_emb"], rtol=0, atol=0)
    torch.testing.assert_close(
        x[:, P:], st["embed"][batch["tokens"]] * math.sqrt(cfg.d_model))
    assert torch.equal(pos, torch.arange(P + S))


def test_without_a_prefix_it_is_a_text_decoder():
    """With no ``prefix_emb`` (as the serving engine runs it) the model is
    the plain Gemma decoder, as the reference's: logits within 1e-5."""
    jcfg, cfg, jst, _, st, _, jbatch, batch = _setup(ARCH)
    jlogits, _ = JST.forward(jst, jcfg, jbatch["tokens"])
    with torch.no_grad():
        logits = ST.forward(st, cfg, batch["tokens"])
    _close(logits, jlogits, rtol=1e-5, atol=1e-5)
