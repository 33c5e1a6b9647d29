"""Parity of the port's RWKV-6 model path (rwkv6-3b) with the JAX
reference, on the CPU: the time-mix and channel-mix blocks (full sequence,
state, decode); the full config's parameter tree (its config is held to
the reference's with every other registered one in
``tests/test_torch_recurrent.py``); the stacked model's forward, prefill
(kernel on and off) and decode on 2- and 4-layer reduced rwkv6-3b; the
serving engine against the reference engine; and the sinusoid, which a
model with no rotary positions gets unless it is recurrent.  Inputs are
made with numpy and handed to both packages; weights are the reference's,
bridged.  The WKV-6 kernel path is in ``tests/test_torch_rwkv.py``.

The reference's kernel path returns no WKV state (``final = None``); the
port's kernel returns it, so the port's prefill state is held to the
reference's kernel-free prefill state."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import recurrent as JRec  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import recurrent as Rec  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

ARCH = "rwkv6-3b"
TOL = dict(rtol=5e-4, atol=5e-4)   # test_flash_kernel_inside_model's


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ------------------------------------------------------------------- block
@functools.lru_cache(maxsize=None)
def _block():
    jcfg = JC.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JRec.init_rwkv_block(jax.random.PRNGKey(5), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("S,use_kernel", [(12, False), (12, True),
                                          (1, True), (129, True)])
def test_time_mix_matches_reference(S, use_kernel):
    """Full-sequence time mix (output and returned state, the port's
    kernel path included) against the reference's kernel-free path, then
    three decode steps from that state, written in place."""
    jcfg, cfg, jp, p = _block()
    x = _x((2, S, 256), S)
    jout, jstate = JRec.rwkv_time_mix(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        out, state = Rec.rwkv_time_mix(p, cfg, torch.from_numpy(x),
                                       use_kernel=use_kernel)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for name in ("wkv", "prev"):
        np.testing.assert_allclose(_np(state[name]), _np(jstate[name]),
                                   **TOL)
    state = {"wkv": state["wkv"].clone(), "prev": state["prev"].clone()}
    for step in range(3):
        xt = _x((2, 1, 256), 100 + step)
        jout, jstate = JRec.rwkv_time_mix(jp, jcfg, jnp.asarray(xt),
                                          state=jstate)
        with torch.no_grad():
            out, got = Rec.rwkv_time_mix(p, cfg, torch.from_numpy(xt),
                                         state=state)
        assert got is state          # updated in place
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        for name in ("wkv", "prev"):
            np.testing.assert_allclose(_np(state[name]), _np(jstate[name]),
                                       **TOL)


@pytest.mark.parametrize("S", [1, 12])
def test_channel_mix_matches_reference(S):
    """Channel mix over a sequence, then one decode step from its
    state."""
    jcfg, cfg, jp, p = _block()
    x = _x((2, S, 256), S + 1)
    jout, jstate = JRec.rwkv_channel_mix(jp, jcfg, jnp.asarray(x))
    out, state = Rec.rwkv_channel_mix(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(state["prev"]), _np(jstate["prev"]),
                               **TOL)
    xt = _x((2, 1, 256), 7)
    jout, jstate = JRec.rwkv_channel_mix(jp, jcfg, jnp.asarray(xt),
                                         state=jstate)
    state = {"prev": state["prev"].clone()}
    out, got = Rec.rwkv_channel_mix(p, cfg, torch.from_numpy(xt),
                                    state=state)
    assert got is state
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(state["prev"]), _np(jstate["prev"]),
                               **TOL)


# -------------------------------------------------------------------- tree
def test_full_parameter_tree_matches_reference():
    """rwkv6-3b's 29 leaves: key paths, shapes and dtypes of the port's
    tree (meta tensors, nothing drawn) equal the reference's
    (``jax.eval_shape``, nothing drawn), and the weight bridge carries that
    tree across (placeholder arrays of the leaves' dtypes)."""
    jshape = jax.eval_shape(lambda k: JST.init_params(k, JC.get_config(ARCH)),
                            jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jshape)[0]]
    with torch.device("meta"):
        own = ST.init_params(get_config(ARCH), device="meta")
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in T.leaves_with_paths(own)]
    assert len(got) == 29 and got == want
    n = sum(int(np.prod(s)) for _, s, _ in got)
    assert 3.0e9 < n < 3.2e9
    placeholders = jax.tree.map(lambda s: np.zeros((1,), s.dtype), jshape)
    bridged = params_from_jax(placeholders, device="cpu")
    assert [(p, str(l.dtype).replace("torch.", ""))
            for p, l in T.leaves_with_paths(bridged)] == \
        [(p, d) for p, _, d in want]


# ----------------------------------------------------------------- stacked
@functools.lru_cache(maxsize=None)
def _setup(n_layers=2):
    jcfg = dataclasses.replace(JC.get_config(ARCH).reduced(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers)
    jparams = JST.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _same_trees(got, want, **tol):
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = T.leaves_with_paths(got)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_layer_groups_and_leaves_match_reference(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    assert ST.layer_groups(cfg) == JST.layer_groups(jcfg)
    own = ST.init_params(cfg, seed=0, device="cpu")
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for tree in (params, own):
        assert [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
                for p, l in T.leaves_with_paths(tree)] == want


@pytest.mark.parametrize("n_layers", [2, 4])
def test_forward_matches_reference(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((2, 24), cfg.vocab, n_layers)
    jlogits, _ = JST.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        logits = ST.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


@pytest.mark.parametrize("n_layers,S", [(2, 12), (2, 128), (2, 129),
                                        (4, 1), (4, 100), (4, 128)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_matches_reference(n_layers, S, use_kernels):
    """The port's ``prefill`` (with the kernel's plain version on the CPU,
    and without the kernel) against the reference's kernel-free prefill:
    the last logits and every cache leaf, the WKV state included.  Where
    the Pallas kernel takes S, the logits also against the reference's
    prefill with its kernel (which returns no WKV state)."""
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((1, S), cfg.vocab, S)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32), 256)
    before = K.rwkv6_wkv.launches
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks), 256,
                                    use_kernels=use_kernels)
    assert K.rwkv6_wkv.launches == before
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
    _same_trees(caches, jc, **TOL)
    if use_kernels and (S <= 128 or S % 128 == 0):
        jlk, jck = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                               256, use_kernels=True)
        np.testing.assert_allclose(_np(logits), _np(jlk), **TOL)
        assert all(c["tmix"]["wkv"] is None for c in jck)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_decode_steps_match_reference(n_layers):
    """Prefill through the kernel path, then four decode steps with one
    position for the batch, as the reference's ``decode_step`` takes it;
    every state leaf after each step.  The reference decodes from its
    kernel-free prefill, the only one of its prefills that returns a
    state."""
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((2, 12), cfg.vocab, 8)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32), 64)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks), 64,
                                    use_kernels=True)
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    for pos in range(12, 16):
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int64)
        jl, jc = step(jc, jnp.asarray(nxt, jnp.int32), jnp.int32(pos))
        with torch.no_grad():
            logits, caches = ST.decode_step(params, cfg, caches,
                                            torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
        _same_trees(caches, jc, **TOL)


def test_batched_decode_rows_match_reference_steps():
    """One position per row (the engine's batched decode) against the
    reference's batch-1 step on each row, from zero state."""
    jcfg, cfg, jparams, params = _setup(2)
    starts = [0, 5, 11]
    jcs = [JST.init_cache(jcfg, 1, 64) for _ in starts]
    caches = ST.init_cache(cfg, len(starts), 64, device="cpu")
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    rng = np.random.default_rng(9)
    for it in range(5):
        toks = rng.integers(0, cfg.vocab, len(starts))
        pos = np.array(starts) + it
        with torch.no_grad():
            logits, caches = ST.decode_step(params, cfg, caches,
                                            torch.from_numpy(toks),
                                            torch.from_numpy(pos))
        for row, p in enumerate(pos):
            jl, jcs[row] = step(jcs[row], jnp.asarray(toks[row:row + 1],
                                                      jnp.int32),
                                jnp.int32(p))
            np.testing.assert_allclose(_np(logits[row]), _np(jl[0]), **TOL)
    for row in range(len(starts)):
        _same_trees(T.map(lambda c: c[:, row:row + 1], caches), jcs[row],
                    **TOL)


# --------------------------------------------------------------- sinusoid
@pytest.mark.parametrize("arch,added", [("transformer-paper", True),
                                        ("rwkv6-3b", False),
                                        ("tinyllama-1.1b", False),
                                        ("recurrentgemma-9b", False)])
def test_sinusoid_added_for_transformer_paper_never_for_rwkv(arch, added):
    """Both have no rotary positions (``rope_frac == 0``); only the
    transformer gets sinusoidal ones, as in the reference.  In prefill the
    embedding is checked directly.  In decode, the transformer's step at
    position 5 must give the logits of a 6-token prefill (both add the
    sinusoid), and an RWKV step must not depend on its position at all."""
    cfg = get_config(arch).reduced()
    params = ST.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens((1, 6), cfg.vocab, 1))
    x, _ = ST._embed_positions(params, cfg, toks)
    emb = M._embed(params, cfg, toks)
    if added:
        emb = emb + M._sinusoid(6, cfg.d_model, emb.dtype, "cpu")[None]
    torch.testing.assert_close(x, emb, rtol=0, atol=0)
    with torch.no_grad():
        if arch == "transformer-paper":
            _, caches = ST.prefill(params, cfg, toks[:, :5], 16)
            got, _ = ST.decode_step(params, cfg, caches, toks[:, 5], 5)
            want, _ = ST.prefill(params, cfg, toks, 16)
            torch.testing.assert_close(got, want, **TOL)
        if arch == "rwkv6-3b":
            at = [ST.decode_step(params, cfg,
                                 ST.init_cache(cfg, 1, 16, "cpu"),
                                 toks[:, 0], pos)[0] for pos in (0, 5)]
            assert torch.equal(at[0], at[1])


# ------------------------------------------------------------------ engine
def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(1, 40))).astype(np.int32),
        max_new_tokens=int(rng.integers(4, 20))) for i in range(n)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.rid: r.output for r in engine.run_to_completion()}


@functools.lru_cache(maxsize=None)
def _reference_outputs():
    jcfg, cfg, jparams, _ = _setup(2)
    eng = JE.ServeEngine(jparams, jcfg, max_slots=3, cache_len=64)
    return _serve(eng, _requests(JE.Request, 5, cfg.vocab, 4)), eng.stats()


@pytest.mark.parametrize("decode_batch", [None, 2])
def test_engine_matches_reference_engine(decode_batch):
    """The same requests through the reference engine (kernel-free) and
    the port's (prefill through the WKV-6 kernel's plain version): equal
    greedy tokens, request by request, and equal step counts.  With
    ``decode_batch=2`` the port gathers and scatters the nested caches in
    chunks of two slots."""
    _, cfg, _, params = _setup(2)
    want, stats = _reference_outputs()
    eng = E.ServeEngine(params, cfg, max_slots=3, cache_len=64,
                        decode_batch=decode_batch)
    assert _serve(eng, _requests(E.Request, 5, cfg.vocab, 4)) == want
    assert eng.stats()["decode_steps"] == stats["decode_steps"]
    assert eng.stats()["tokens"] == stats["tokens"]
