"""Training the recurrent hybrid (recurrentgemma-9b) and RWKV-6 (rwkv6-3b)
in the port, against the JAX reference on the CPU.

* The model's own WKV-6 scan (``models/recurrent.py::_wkv6_scan``, one
  custom op forward and one backward): output and final state against the
  kernel's plain version and the reference's ``_wkv6_scan``; gradients
  against ``jax.grad`` through the reference's scan and against autograd
  through the plain version, in f32, at several lengths and checkpoint
  lengths; the tracer's price of each op against the reference's scan
  bodies; a trace's size independent of S; no call of the plain version
  on the training path.
* The stacked model's loss gradients on reduced recurrentgemma-9b (3 and 5
  layers: one cycle; one cycle and a tail) and rwkv6-3b (2 and 4 layers),
  with and without remat, leaf by leaf against ``jax.grad``.
* Both traced steps' DOT FLOPs against the reference's jaxpr.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import trace as RTRACE  # noqa: E402
from repro.data.pipeline import materialize_batch  # noqa: E402
from repro.models import recurrent as JRec  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
import repro_torch.plan as PP  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DOT, trace as PTRACE  # noqa: E402
from repro_torch.kernels import ref as KREF  # noqa: E402
from repro_torch.models import recurrent as Rec  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

RG, RWKV = "recurrentgemma-9b", "rwkv6-3b"
B, S = 2, 32
BATCH, SEQ = 8, 64          # trace_model_graph's defaults
GRAD_ATOL = {RG: 2e-6, RWKV: 5e-5}


# ------------------------------------------------------------ the WKV op
def _wkv_inputs(B_, S_, H, hd, seed=0):
    """f32 r, k, v (scaled), a decay w in (0, 1) and a bonus u."""
    g = np.random.default_rng(seed)
    r, k, v = (0.5 * g.standard_normal((B_, S_, H, hd)) for _ in range(3))
    w = np.exp(-np.exp(0.5 * g.standard_normal((B_, S_, H, hd)) - 1.0))
    u = 0.1 * g.standard_normal((H, hd))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _cotangents(out_shape, final_shape):
    g = np.random.default_rng(9)
    return (g.standard_normal(out_shape).astype(np.float32),
            g.standard_normal(final_shape).astype(np.float32))


@pytest.mark.parametrize("S_,chunk", [(1, None), (17, None), (17, 5),
                                      (128, None), (128, 7)])
def test_wkv_op_matches_reference(S_, chunk):
    """The op's output and final state against the plain version and the
    reference's ``_wkv6_scan`` (within 1e-5), and its gradients of r, k,
    v, w and u under random cotangents of both outputs against
    ``jax.grad`` through the reference's scan (relative 1e-5 of each
    gradient's largest entry) and autograd through the plain version
    (within 1e-5 of the same), in f32; ``chunk`` cuts the checkpoint
    length (5 and 7 steps, so the last chunk is ragged)."""
    arrs = _wkv_inputs(2, S_, 3, 16, seed=S_)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out, final = Rec._wkv6_scan(*ts, chunk=chunk)
    go, gf = _cotangents(out.shape, final.shape)
    jout, jfinal = JRec._wkv6_scan(*map(jnp.asarray, arrs))
    pout, pfinal = KREF.rwkv6_ref(*[t.detach() for t in ts])
    for got, want in ((out, jout), (final, jfinal), (out, pout),
                      (final, pfinal)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(go)).sum()
        + (final * torch.from_numpy(gf)).sum(), ts)

    def jloss(*a):
        o, f = JRec._wkv6_scan(*a)
        return (o * go).sum() + (f * gf).sum()

    jgrads = jax.grad(jloss, argnums=range(5))(*map(jnp.asarray, arrs))
    plain = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    po, pf = KREF.rwkv6_ref(*plain)
    pgrads = torch.autograd.grad((po * torch.from_numpy(go)).sum()
                                 + (pf * torch.from_numpy(gf)).sum(), plain)
    for name, g, jg, pg in zip("rkvwu", grads, jgrads, pgrads):
        scale = max(float(np.abs(np.asarray(jg)).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(g.numpy(), pg.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_wkv_op_keeps_input_dtypes():
    """bf16 r, k, v with an f32 decay, as the model gives them: the output
    in bf16 and the state in f32, each gradient in its input's dtype."""
    arrs = _wkv_inputs(1, 9, 2, 8)
    ts = [torch.from_numpy(a) for a in arrs]
    ts[:3] = [t.bfloat16() for t in ts[:3]]
    ts = [t.requires_grad_(True) for t in ts]
    out, final = Rec._wkv6_scan(*ts)
    assert out.dtype == torch.bfloat16 and final.dtype == torch.float32
    grads = torch.autograd.grad(out.float().sum() + final.sum(), ts)
    assert [g.dtype for g in grads] == [t.dtype for t in ts]


def _reference_scans(B_, S_, H, hd):
    """The (forward, backward) scan bodies of the reference's
    ``jax.grad`` through its ``_wkv6_scan``, each as its tracer totals
    them (flops, in bytes, out bytes)."""
    arrs = [jnp.asarray(a) for a in _wkv_inputs(B_, S_, H, hd)]

    def loss(*a):
        o, f = JRec._wkv6_scan(*a)
        return (o ** 2).sum() + (f ** 2).sum()

    closed = jax.make_jaxpr(jax.grad(loss, argnums=range(5)))(*arrs)
    scans = [e for e in closed.jaxpr.eqns if e.primitive.name == "scan"]
    assert [e.params["length"] for e in scans] == [S_, S_]
    return [RTRACE._subjaxpr_totals(RTRACE._find_subjaxpr(e))
            for e in scans]


@pytest.mark.parametrize("B_,H,hd", [(2, 3, 16), (3, 2, 8), (4, 40, 64)])
def test_wkv_price_is_the_reference_scan_body(B_, H, hd):
    """:func:`repro_torch.core.trace.wkv6_step_cost` equals the reference
    tracer's totals of its forward and backward scan bodies exactly."""
    for backward, want in enumerate(_reference_scans(B_, 5, H, hd)):
        got = PTRACE.wkv6_step_cost(B_, H, hd, bool(backward))[:3]
        assert got == tuple(want)


def test_wkv_price_at_batch_one():
    """At B = 1 JAX's transpose adds a reshape and a reduction of (H, hd)
    to the backward body: the FLOPs still agree exactly, the bytes within
    1%."""
    for backward, want in enumerate(_reference_scans(1, 5, 3, 16)):
        got = PTRACE.wkv6_step_cost(1, 3, 16, bool(backward))[:3]
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-2)


def _meta_trace(cfg, seq):
    with torch.device("meta"):
        params = ST.init_params(cfg, device="meta")
    data = {"tokens": torch.zeros((2, seq), dtype=torch.int64,
                                  device="meta")}
    return PTRACE.trace_fx(lambda p, b: ST.loss_fn(p, cfg, b), params, data)


def test_trace_size_independent_of_sequence():
    """Reduced rwkv6-3b's step traced at S = 32 and S = 256: the same
    number of fx nodes, with one forward and one backward WKV op a
    layer."""
    cfg = get_config(RWKV).reduced()
    sizes = []
    for seq in (32, 256):
        gm, _ = _meta_trace(cfg, seq)
        names = [PTRACE._op_name(n) for n in gm.graph.nodes]
        assert names.count("wkv6_scan") == cfg.n_layers
        assert names.count("wkv6_scan_bwd") == cfg.n_layers
        sizes.append(len(gm.graph.nodes))
    assert sizes[0] == sizes[1]


def test_training_path_does_not_call_the_plain_version(monkeypatch):
    """The stacked model's loss and gradients never reach the kernel's
    plain version (a loop over time)."""
    def refuse(*a, **k):
        raise AssertionError("rwkv6_ref called on the training path")

    monkeypatch.setattr(KREF, "rwkv6_ref", refuse)
    cfg = get_config(RWKV).reduced()
    params = ST.init_params(cfg, seed=0, device="cpu")
    leaves = [p.requires_grad_(True) for p in ST.leaves(params)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    loss = ST.loss_fn(params, cfg, {"tokens": toks}, remat=True)
    assert all(torch.isfinite(g).all()
               for g in torch.autograd.grad(loss, leaves))


# ------------------------------------------------------ stacked gradients
@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers):
    jcfg = dataclasses.replace(JC.get_config(arch).reduced(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)
    jparams = JST.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(n_layers).integers(0, cfg.vocab, (B, S))
    jgrads = jax.jit(jax.grad(lambda p: JST.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})))(jparams)
    return cfg, params, tokens, jax.tree.leaves(jgrads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch,n_layers", [(RG, 3), (RG, 5), (RWKV, 2),
                                           (RWKV, 4)])
def test_stacked_grads_match_jax_grad(arch, n_layers, remat):
    """Each leaf's gradient of the stacked loss against ``jax.grad`` of the
    reference's: rtol 1e-4 and an atol of a tenth of the kind's forward
    tolerance, as ``test_torch_layers.py`` holds the per-layer model's
    (hybrid 2e-6, RWKV 5e-5: the reduced RWKV model's gradients move by
    2-5% when its weights move by a random 1e-5)."""
    cfg, params, tokens, jgrads = _setup(arch, n_layers)
    leaves = ST.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ST.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)},
                      remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(jgrads)
    for (path, _), g, jg in zip(T.leaves_with_paths(params), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=GRAD_ATOL[arch], err_msg=path)


# --------------------------------------------------------------- DOT FLOPs
def _ref_walk(jaxpr, visit, trips=1.0) -> None:
    """Call ``visit(eqn, trips)`` on every eqn of a jaxpr and its
    sub-jaxprs, ``trips`` the product of the enclosing scans' lengths."""
    for eqn in jaxpr.eqns:
        sub = RTRACE._find_subjaxpr(eqn)
        if sub is None:
            visit(eqn, trips)
            continue
        n = float(eqn.params["length"]) if eqn.primitive.name == "scan" \
            else 1.0
        visit(eqn, trips)
        _ref_walk(sub.jaxpr if hasattr(sub, "jaxpr") else sub, visit,
                  trips * n)


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_trace_dot_flops_match_reference(arch, monkeypatch):
    """``trace_model_graph`` on the reduced model (meta tensors): its fx
    graph with no region collapsed has the DOT FLOPs of the reference's
    jaxpr (scan bodies times trips), the WKV ops' dot products counted as
    the reference's scan bodies hold them (4 and 8 per state entry and
    step); the WKV ops are priced at the reference's WKV scans' FLOPs and
    bytes; the collapsed graph keeps every FLOP and marks every leaf."""
    jcfg = JC.get_config(arch).reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    toks = jnp.asarray(materialize_batch(jcfg, BATCH, SEQ, seed=0)["tokens"])
    closed = jax.make_jaxpr(jax.grad(
        lambda p: JST.loss_fn(p, jcfg, {"tokens": toks})))(jparams)
    ref = {"dot": 0.0, "wkv": np.zeros(3)}

    def visit(eqn, trips):
        if eqn.primitive.name == "dot_general":
            ref["dot"] += trips * RTRACE._dot_flops(eqn)
        elif eqn.primitive.name == "scan" and eqn.params["length"] == SEQ:
            # the WKV scans (the layer scans run n_layers trips, the
            # cross-entropy's one)
            ref["wkv"] += trips * SEQ * np.array(RTRACE._subjaxpr_totals(
                RTRACE._find_subjaxpr(eqn)))

    _ref_walk(closed.jaxpr, visit)

    built = []
    graph_from_fx = PTRACE.graph_from_fx
    monkeypatch.setattr(PTRACE, "graph_from_fx", lambda gm, *a: (
        built.append((gm, a)), graph_from_fx(gm, *a))[1])
    port = PP.trace_model_graph(arch, batch=BATCH, seq=SEQ)
    (gm, (regions, grad_bytes, grad_sigs)), = built
    flat = graph_from_fx(gm, [], grad_bytes, grad_sigs)
    dots = sum(p.flops for p in flat.prims if p.category == DOT)
    wkv = np.zeros(3)
    for node in gm.graph.nodes:
        name = PTRACE._op_name(node)
        if name in ("wkv6_scan", "wkv6_scan_bwd"):
            Bn, Sn, H, hd = node.args[0].meta["val"].shape
            dots += Sn * PTRACE.wkv6_step_cost(
                Bn, H, hd, name.endswith("bwd"))[3]
            wkv += np.array(PTRACE._node_cost(node)[1:])
    assert math.isclose(dots, ref["dot"], rel_tol=1e-9)
    np.testing.assert_allclose(wkv, ref["wkv"], rtol=1e-12)
    assert (wkv.sum() > 0) == (arch == RWKV)
    assert regions and math.isclose(sum(p.flops for p in port.prims),
                                    sum(p.flops for p in flat.prims),
                                    rel_tol=1e-12)
    assert len(port.grad_prim) == len(grad_bytes) == len(
        jax.tree.leaves(jparams))
