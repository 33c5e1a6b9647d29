"""Parity of the port's DeepSeek-V2 blocks and models with the reference,
on the CPU in f32 with the reference's weights (bridged by
``params_from_jax``): MLA (``mla_fwd``, prefill and decode, with full-rank
queries as in deepseek-v2-lite and low-rank ones as in deepseek-v2-236b),
the routed experts (``moe_fwd``, output and aux loss, with no token dropped
and with tokens dropped past capacity), the stacked model's forward, loss
and gradients with and without remat, ``init_cache``, ``prefill`` and
``decode_step`` at B rows, the serving engine against the reference engine
where per-row routing matters, the tracer's DOT FLOPs, the launcher, the
registry and the parameter tree at full width.

Reduced configs (2 layers: one dense, one MoE; 4 experts, top 2).
Tolerances: 1e-5 for f32 forward values, as the dense stacked model's
parity tests (``test_torch_model.py``); gradients rtol 1e-4 with an atol of
1e-6.  "Capacity 1.0" replaces the reduced config's capacity factor of 8.0
(which drops nothing at toy scale) so that tokens are dropped.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import trace as RTRACE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.serving import engine as JE  # noqa: E402

import repro_torch.plan as PP  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import DOT  # noqa: E402
from repro_torch.core import trace as PTRACE  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

MLA_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
NEW_ARCHS = MLA_ARCHS + ["deepseek-coder-33b"]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jparams = jax.jit(JST.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jax_config(arch).reduced())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _setup(arch, capacity=None):
    """Reduced configs of both packages (the capacity factor replaced when
    given) and the reference's weights with their bridged copy."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if capacity is not None:
        jcfg, cfg = _capacity(jcfg, capacity), _capacity(cfg, capacity)
    return (jcfg, cfg) + _weights(arch)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _same_trees(got, want, **tol):
    want = jax.tree.leaves(want)
    got = T.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def _layer(tree, i=0):
    """One layer's subtree of a stacked group."""
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registry_entry_matches_reference(arch):
    """Every field, full and reduced, and both parameter counts equal the
    reference's; the block kinds and MoE layers too."""
    for got, want in ((get_config(arch), jax_config(arch)),
                      (get_config(arch).reduced(),
                       jax_config(arch).reduced())):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, (arch, f.name)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert [(got.block_kind(i), got.is_moe_layer(i))
                for i in range(got.n_layers)] == \
            [(want.block_kind(i), want.is_moe_layer(i))
             for i in range(want.n_layers)]
    assert arch in ARCHS


def test_full_deepseek_lite_tree_and_bridge():
    """deepseek-v2-lite-16b at full width: the port's stacked tree (meta
    tensors) has the reference's key paths, shapes and dtypes
    (``jax.eval_shape``): a dense group of 1 and an MoE group of 26 with
    (26, 64, ...) expert stacks and the ``shared`` MLP; the bridge carries
    every leaf, untransposed; the per-layer tree likewise."""
    arch = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape = jax.eval_shape(lambda k: JST.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jshape)[0]]
    with torch.device("meta"):
        own = ST.init_params(cfg, device="meta")
        per_layer = M.from_stacked(own, cfg)
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in T.leaves_with_paths(own)]
    assert got == want
    assert ("['groups'][1]['moe']['w_up']", (26, 64, 2048, 1408),
            "bfloat16") in got
    assert ("['groups'][1]['moe']['shared']['w_gate']", (26, 2048, 2816),
            "bfloat16") in got
    assert sum(math.prod(s) for _, s, _ in got) == 15_706_484_224
    placeholders = jax.tree.map(lambda s: np.zeros((1,), s.dtype), jshape)
    bridged = params_from_jax(placeholders, device="cpu")
    assert [p for p, _ in T.leaves_with_paths(bridged)] == \
        [p for p, _, _ in want]
    assert len(per_layer["layers"]) == 27
    assert "mlp" in per_layer["layers"][0] and \
        "moe" in per_layer["layers"][1]


def test_bridge_carries_expert_stacks_untransposed():
    _, _, jparams, params = _setup("deepseek-v2-lite-16b")
    moe = jparams["groups"][1]["moe"]
    for name in ("w_up", "w_down", "w_gate", "router"):
        np.testing.assert_array_equal(
            params["groups"][1]["moe"][name].numpy(), np.asarray(moe[name]))
    np.testing.assert_array_equal(
        params["groups"][1]["moe"]["shared"]["w_down"].numpy(),
        np.asarray(moe["shared"]["w_down"]))


# --------------------------------------------------------------------- MLA
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_and_decode_match_reference(arch):
    """``mla_fwd`` prefill (output and the latent cache) and three decode
    steps at one position for the batch, then a step with one position per
    row against the reference's batch-1 steps at those positions."""
    jcfg, cfg, jparams, params = _setup(arch)
    jp, p = _layer(jparams["groups"][0]["attn"]), \
        _layer(params["groups"][0]["attn"])
    B, S, CL = 2, 12, 20
    x = np.random.default_rng(1).standard_normal(
        (B, S + 4, cfg.d_model)).astype(np.float32)
    jout, jc = jax.jit(lambda x: JL.mla_fwd(
        jp, jcfg, x, jnp.arange(S), return_cache=True, cache_len=CL))(
            jnp.asarray(x[:, :S]))
    step = jax.jit(lambda x, c, pos: JL.mla_fwd(
        jp, jcfg, x, pos[None], cache=c, pos=pos))
    with torch.no_grad():
        out, c = L.mla_fwd(p, cfg, torch.from_numpy(x[:, :S]),
                           torch.arange(S), return_cache=True, cache_len=CL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    _same_trees(c, jc, **TOL)
    for pos in range(S, S + 3):
        xs = x[:, pos:pos + 1]
        jout, jc = step(jnp.asarray(xs), jc, jnp.int32(pos))
        with torch.no_grad():
            out, c = L.mla_fwd(p, cfg, torch.from_numpy(xs),
                               torch.tensor([pos]), cache=c, pos=pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        _same_trees(c, jc, **TOL)
    # one position per row: row 0 writes at S + 3, row 1 rewrites S
    rows = np.array([S + 3, S])
    xs = x[:, S + 3:S + 4]
    with torch.no_grad():
        out, c = L.mla_fwd(p, cfg, torch.from_numpy(xs),
                           torch.from_numpy(rows)[:, None], cache=c,
                           pos=torch.from_numpy(rows))
    for b, pos in enumerate(rows):
        one = jax.tree.map(lambda a: a[b:b + 1], jc)
        jout, jone = step(jnp.asarray(xs[b:b + 1]), one, jnp.int32(pos))
        np.testing.assert_allclose(out[b:b + 1].numpy(), np.asarray(jout),
                                   **TOL)
        _same_trees({k: v[b:b + 1] for k, v in c.items()}, jone, **TOL)


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("capacity", [None, 1.0], ids=["cf8", "cf1"])
def test_moe_fwd_matches_reference(capacity):
    """Output and aux loss at T = 64 tokens: the reduced capacity (8.0)
    drops nothing; at 1.0 (C = 32 of 128 token copies over 4 experts)
    tokens are dropped, and the same ones in both packages."""
    jcfg, cfg, jparams, params = _setup("deepseek-v2-lite-16b", capacity)
    jp, p = _layer(jparams["groups"][1]["moe"]), \
        _layer(params["groups"][1]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda x: JL.moe_fwd(jp, jcfg, x))(jnp.asarray(x))
    with torch.no_grad():
        out, aux = L.moe_fwd(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # capacity 1.0 changes the output: tokens were dropped
    _, cfg8, _, _ = _setup("deepseek-v2-lite-16b")
    with torch.no_grad():
        out8, _ = L.moe_fwd(p, cfg8, torch.from_numpy(x))
    assert torch.equal(out, out8) == (capacity is None)


def test_moe_route_rows_is_the_reference_per_row():
    """``route_rows`` routes each row as a batch of its own: at capacity
    1.0 and 16 rows of 1 token it equals the reference's batch-1 calls row
    by row, and differs from routing the 16 rows together (C = 8 of 32
    token copies: tokens dropped)."""
    jcfg, cfg, jparams, params = _setup("deepseek-v2-lite-16b", 1.0)
    jp, p = _layer(jparams["groups"][1]["moe"]), \
        _layer(params["groups"][1]["moe"])
    x = np.random.default_rng(6).standard_normal(
        (16, 1, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        rows, _ = L.moe_fwd(p, cfg, torch.from_numpy(x), route_rows=True)
        batch, _ = L.moe_fwd(p, cfg, torch.from_numpy(x))
    ref = jax.jit(lambda x: JL.moe_fwd(jp, jcfg, x)[0])
    want = np.concatenate([np.asarray(ref(jnp.asarray(x[b:b + 1])))
                           for b in range(16)])
    np.testing.assert_allclose(rows.numpy(), want, **TOL)
    jbatch = ref(jnp.asarray(x))
    np.testing.assert_allclose(batch.numpy(), np.asarray(jbatch), **TOL)
    assert not np.allclose(batch.numpy(), rows.numpy(), atol=1e-3)


def test_moe_bf16_within_bf16_tolerance():
    """In bf16 the outputs agree to bf16's rounding: the port adds each
    token's expert outputs in the reference's order, its GEMMs sum in
    another."""
    jcfg, cfg, jparams, params = _setup("deepseek-v2-lite-16b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      _layer(jparams["groups"][1]["moe"]))
    p = T.map(lambda a: a.bfloat16(), _layer(params["groups"][1]["moe"]))
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jout, _ = jax.jit(lambda x: JL.moe_fwd(jp, jcfg, x))(
        jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out, _ = L.moe_fwd(p, cfg, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits, the summed aux loss and the chunked loss (which adds it)."""
    jcfg, cfg, jparams, params = _setup(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24))
    (jlogits, jaux), jloss = jax.jit(lambda t: (
        JST.forward(jparams, jcfg, t),
        JST.loss_fn(jparams, jcfg, {"tokens": t})))(
            jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        logits = ST.forward(params, cfg, torch.from_numpy(toks))
        _, aux = ST.hidden_forward(params, cfg, torch.from_numpy(toks))
        loss = ST.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)})
        plogits, paux = M.forward(M.from_stacked(params, cfg), cfg,
                                  torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), **TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose([float(aux), float(paux)], float(jaux),
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    jcfg, cfg, jparams, _ = _setup(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    return toks, jax.jit(jax.grad(lambda p: JST.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})))(jparams)


@pytest.mark.parametrize("arch,remat", [(a, r) for a in MLA_ARCHS
                                        for r in (False, True)])
def test_gradients_match_reference(arch, remat):
    """Every leaf's gradient of the loss (aux included; through
    ``checkpoint`` with remat) against the reference's (remat changes no
    value there)."""
    _, cfg, _, params = _setup(arch)
    toks, jg = _reference_grads(arch)
    leaves = [a.clone().requires_grad_(True) for a in T.leaves(params)]
    loss = ST.loss_fn(T.unflatten(params, leaves), cfg,
                      {"tokens": torch.from_numpy(toks)}, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # the router is trained by the aux loss and the weights
    router = [i for i, (path, _) in enumerate(T.leaves_with_paths(params))
              if path.endswith("['router']")]
    assert router and float(grads[router[0]].abs().max()) > 0


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_prefill_and_decode_at_b_rows_match_reference(arch):
    """At capacity 1.0: ``init_cache`` (the stacked ``{"c_kv", "k_rope"}``
    leaves), then a 16-row prefill and four 16-row decode steps (T = 16, C
    = 8 < 32 token copies: tokens dropped batch-wide) against the
    reference's, every cache leaf too."""
    jcfg, cfg, jparams, params = _setup(arch, 1.0)
    B, S, CL = 16, 8, 16
    jc0 = JST.init_cache(jcfg, B, CL)
    c0 = ST.init_cache(cfg, B, CL, device="cpu")
    assert [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in T.leaves_with_paths(c0)] == \
        [(jax.tree_util.keystr(p), l.shape, str(l.dtype))
         for p, l in jax.tree_util.tree_flatten_with_path(jc0)[0]]
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (B, S))
    jl, jc = jax.jit(lambda t: JST.prefill(jparams, jcfg, t, CL))(
        jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks), CL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _same_trees(caches, jc, **TOL)
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    for pos in range(S, S + 4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
        jl, jc = step(jc, jnp.asarray(nxt, jnp.int32), jnp.int32(pos))
        with torch.no_grad():
            logits, caches = ST.decode_step(
                params, cfg, caches, torch.from_numpy(nxt.astype(np.int64)),
                pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _same_trees(caches, jc, **TOL)
    # routed row by row, the same step gives other logits (nothing dropped)
    with torch.no_grad():
        again = T.map(torch.clone, caches)
        per_row, _ = ST.decode_step(params, cfg, again,
                                    torch.from_numpy(nxt.astype(np.int64)),
                                    pos, route_rows=True)
        batch, _ = ST.decode_step(params, cfg, T.map(torch.clone, caches),
                                  torch.from_numpy(nxt.astype(np.int64)),
                                  pos)
    assert not torch.allclose(per_row, batch, atol=1e-3)


class _JitPrefillEngine(JE.ServeEngine):
    """The reference engine with its single-sequence prefill jitted per
    prompt length."""

    @functools.lru_cache(maxsize=None)
    def _jit_prefill(self, plen):
        return jax.jit(lambda p, t: super(_JitPrefillEngine, self)
                       ._prefill_impl(p, t, plen=plen))

    def _prefill_impl(self, params, tokens, *, plen):
        return self._jit_prefill(plen)(params, tokens)


def _requests(mod, vocab, lens, new, seed=2):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=new) for i, n in enumerate(lens)]


def test_engine_matches_reference_engine_with_per_row_routing():
    """Capacity 1.0 and 16 slots, 12 requests: the port's engine (one
    batched decode of all 16 slots, experts routed per row) gives the
    reference engine's greedy tokens (a vmapped batch-1 step per slot), and
    each request's tokens equal a batch-1 prefill plus ``decode_step``
    loop.  Routed together, the 16 rows would share a capacity of 8 for 32
    token copies.  The reference engine's prefill is jitted here (the same
    function; its eager scan recompiles on every call)."""
    jcfg, cfg, jparams, params = _setup("deepseek-v2-lite-16b", 1.0)
    lens = [5, 9, 2] * 4
    jeng = _JitPrefillEngine(jparams, jcfg, max_slots=16, cache_len=24)
    eng = E.ServeEngine(params, cfg, max_slots=16, cache_len=24)
    for r in _requests(JE, cfg.vocab, lens, 6):
        jeng.submit(r)
    for r in _requests(E, cfg.vocab, lens, 6):
        eng.submit(r)
    want = {r.rid: r.output for r in jeng.run_to_completion()}
    got = {r.rid: r.output for r in eng.run_to_completion()}
    assert got == want and len(got) == len(lens)
    for r in _requests(E, cfg.vocab, lens[:3], 6):
        with torch.no_grad():
            lg, c = ST.prefill(params, cfg, torch.from_numpy(
                r.prompt.astype(np.int64))[None], 24)
            out = [int(lg.argmax())]
            for t in range(5):
                lg, c = ST.decode_step(params, cfg, c,
                                       torch.tensor([out[-1]]),
                                       len(r.prompt) + t)
                out.append(int(lg.argmax()))
        assert out == got[r.rid]


# ------------------------------------------------------- trace and launcher
def _ref_dot_flops(jaxpr) -> float:
    """dot_general FLOPs of a jaxpr, through every sub-jaxpr, a scan's
    body counted once per trip."""
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


def test_trace_dot_flops_match_reference(monkeypatch):
    """``trace_model_graph`` on reduced deepseek-v2-lite (meta tensors: the
    experts' counts have a static shape): its fx graph with no region
    collapsed has the DOT FLOPs of the reference's jaxpr (scan bodies
    times trips); the collapsed graph keeps every FLOP, marks every leaf's
    gradient, and a search covers every leaf once."""
    arch, B, S = "deepseek-v2-lite-16b", 8, 64   # trace_model_graph's
    jcfg, _, jparams, _ = _setup(arch)
    toks = jnp.zeros((B, S), jnp.int32)
    closed = jax.make_jaxpr(jax.grad(
        lambda p: JST.loss_fn(p, jcfg, {"tokens": toks})))(jparams)
    built = []
    graph_from_fx = PTRACE.graph_from_fx
    monkeypatch.setattr(PTRACE, "graph_from_fx", lambda gm, *a: (
        built.append((gm, a)), graph_from_fx(gm, *a))[1])
    port = PP.trace_model_graph(arch, batch=B, seq=S)
    (gm, (regions, grad_bytes, grad_sigs)), = built
    flat = graph_from_fx(gm, [], grad_bytes, grad_sigs)
    got = sum(p.flops for p in flat.prims if p.category == DOT)
    assert math.isclose(got, _ref_dot_flops(closed.jaxpr), rel_tol=1e-9)
    assert regions and math.isclose(sum(p.flops for p in port.prims),
                                    sum(p.flops for p in flat.prims),
                                    rel_tol=1e-12)
    assert len(port.grad_prim) == len(grad_bytes) == 31
    plan = PP.compile(graph=port, cluster="h100_superpod",
                      unchanged_limit=5, max_steps=5)
    assert sorted(i for b in plan.buckets for i in b) == list(range(31))


def test_launcher_trains_reduced_deepseek():
    """``launch.train --arch deepseek-v2-lite-16b --reduced --steps 3
    --device cpu``: finite losses and gradient norms."""
    from repro_torch.launch import train as TRAIN

    out = TRAIN.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                      "--steps", "3", "--batch", "2", "--seq", "32",
                      "--device", "cpu", "--log-every", "100"])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"] + out["grad_norms"]))
