"""Parity of the port's RG-LRU path (recurrentgemma) with the JAX reference,
on the CPU: the config copies, the RG-LRU plain version and its wrapper
against the JAX oracle and the Pallas kernel in interpret mode, the
recurrent block (train, prefill state, decode, kernel), the stacked model's
forward, prefill and decode on a cycle-only (3 layers) and a cycle+tail (5
layers) reduced recurrentgemma, the serving engine against the reference
engine at ``cache_len == window``, and the full config's parameter tree.
Inputs are made with numpy and handed to both packages; weights are the
reference's, bridged.  The CUDA kernel itself is held to the plain version
on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import recurrent as JRec  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import recurrent as Rec  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=5e-4, atol=5e-4)   # test_flash_kernel_inside_model's
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(dt):
    # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16
    return (dict(rtol=2e-5, atol=2e-5) if dt == "f32"
            else dict(rtol=2e-2, atol=2e-2))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_reference(arch):
    """Every field of the port's config, full and reduced, equals the
    reference's, and so does each layer's block kind."""
    for got, want in ((get_config(arch), JC.get_config(arch)),
                      (get_config(arch).reduced(),
                       JC.get_config(arch).reduced())):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, (arch, f.name)
        assert [got.block_kind(i) for i in range(got.n_layers)] == \
            [want.block_kind(i) for i in range(want.n_layers)]


def test_full_parameter_tree_matches_reference():
    """recurrentgemma-9b's 63 leaves: key paths, shapes and dtypes of the
    port's tree (meta tensors, nothing drawn) equal the reference's
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
    assert len(got) == 63 and got == want
    placeholders = jax.tree.map(lambda s: np.zeros((1,), s.dtype), jshape)
    bridged = params_from_jax(placeholders, device="cpu")
    assert [(p, str(l.dtype).replace("torch.", ""))
            for p, l in T.leaves_with_paths(bridged)] == \
        [(p, d) for p, _, d in want]


# ------------------------------------------------------------------ kernel
def _lru_inputs(B, S, L, dt, seed=0):
    """x, r, i and lam as JAX arrays and torch tensors; gates in (0, 1),
    lam in [2, 6] as the model's."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, L)),
            1 / (1 + np.exp(-rng.standard_normal((B, S, L)))),
            1 / (1 + np.exp(-rng.standard_normal((B, S, L)))),
            np.linspace(2.0, 6.0, L)]
    js = [jnp.asarray(a, DTYPES[dt][0]) for a in arrs]
    return js, [_to_torch(a) for a in js]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,L", [(2, 64, 128), (1, 256, 512),
                                   (1, 7, 24)])
def test_rglru_ref_matches_jax_oracle(dt, B, S, L):
    js, ts = _lru_inputs(B, S, L, dt, seed=S)
    got = R.rglru_ref(*ts)
    assert got.dtype == DTYPES[dt][1] and got.shape == (B, S, L)
    np.testing.assert_allclose(_np(got), _np(JR.rglru_ref(*js)), **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 64, 128, 256])
def test_rglru_scan_matches_pallas_interpret(dt, S):
    """The wrapper on CPU tensors (its plain version; no launch counted)
    against the reference's ``ops.rglru_scan``, whose recurrence runs in
    the Pallas kernel in interpret mode, at lengths that kernel takes.  In
    bf16 the reference computes its gates in bf16, the port in f32."""
    js, ts = _lru_inputs(2, S, 512, dt, seed=S + 1)
    before = K.rglru_scan.launches
    got = K.rglru_scan(*ts)
    assert K.rglru_scan.launches == before
    np.testing.assert_allclose(_np(got), _np(JK.rglru_scan(*js)), **tol(dt))


@pytest.mark.parametrize("S,L", [(1, 8), (7, 24), (129, 100), (200, 256)])
def test_rglru_scan_ragged_matches_jax_oracle(S, L):
    """Lengths and widths the Pallas kernel does not take, against the JAX
    oracle, with lam in another dtype than x."""
    js, ts = _lru_inputs(2, S, L, "f32", seed=L)
    lam = ts[3].bfloat16()
    want = JR.rglru_ref(*js[:3], jnp.asarray(js[3], jnp.bfloat16))
    np.testing.assert_allclose(_np(K.rglru_scan(*ts[:3], lam)), _np(want),
                               **tol("f32"))


def test_rglru_scan_refuses_what_the_kernel_does_not_take():
    _, (x, r, i, lam) = _lru_inputs(1, 4, 16, "f32")
    with pytest.raises(ValueError):       # gates of another shape
        K.rglru_scan(x, r[:, :2], i, lam)
    with pytest.raises(ValueError):       # lam of another width
        K.rglru_scan(x, r, i, lam[:8])
    with pytest.raises(ValueError):       # not (B, S, L)
        K.rglru_scan(x[0], r[0], i[0], lam)
    with pytest.raises(TypeError):        # mixed dtypes
        K.rglru_scan(x, r.bfloat16(), i, lam)
    with pytest.raises(TypeError):        # f64
        K.rglru_scan(x.double(), r.double(), i.double(), lam)


def test_associative_scan_matches_sequential_oracle():
    """The kernel-free path's doubling scan against the sequential JAX
    oracle, at a length that is not a power of two."""
    js, ts = _lru_inputs(2, 300, 64, "f32", seed=3)
    np.testing.assert_allclose(_np(Rec._rg_lru_scan(*ts)),
                               _np(JR.rglru_ref(*js)), **tol("f32"))


# ------------------------------------------------- the kernel's algorithm
LRU_CHUNK = 32   # csrc/rglru.cu: kChunk steps per chunk


def _rglru_chunked_emulation(x, r_gate, i_gate, lam):
    """The chunked RG-LRU scan of ``csrc/rglru.cu`` step by step in plain
    PyTorch: the gate math in f32 as the kernel fuses it (``-8
    softplus(lam)`` in lam's dtype), time cut into chunks of 32 steps;
    1. each chunk but the last from h = 0: its end state H_c and its decay
       A_c = prod a, a product with no log and no division;
    2. the carry h_{c+1} = A_c h_c + H_c from h_0 = 0;
    3. each chunk rerun from h_c, writing h in x's dtype."""
    B, S, L = x.shape
    coef = (-8.0 * torch.nn.functional.softplus(lam)).float()
    la = coef[None, None, :] * r_gate.float()
    a = torch.exp(la)
    g = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=1e-12)) * (
        i_gate.float() * x.float())
    n = -(-S // LRU_CHUNK)
    starts = [torch.zeros(B, L)]
    for c in range(n - 1):                                    # launches 1, 2
        h, decay = torch.zeros(B, L), torch.ones(B, L)
        for t in range(c * LRU_CHUNK, (c + 1) * LRU_CHUNK):
            h = a[:, t] * h + g[:, t]
            decay = decay * a[:, t]
        starts.append(decay * starts[-1] + h)
    out = torch.empty(B, S, L)
    for c in range(n):                                        # launch 3
        h = starts[c]
        for t in range(c * LRU_CHUNK, min(S, (c + 1) * LRU_CHUNK)):
            h = a[:, t] * h + g[:, t]
            out[:, t] = h
    return out.to(x.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, LRU_CHUNK - 1, LRU_CHUNK, LRU_CHUNK + 1,
                               2 * LRU_CHUNK + 1, 300])
def test_rglru_chunked_emulation_matches_references(dt, S):
    """The kernel's chunked algorithm at lengths on either side of its
    chunk, B=2, against the plain version and the JAX oracle."""
    js, ts = _lru_inputs(2, S, 24, dt, seed=S + 5)
    got = _np(_rglru_chunked_emulation(*ts))
    np.testing.assert_allclose(got, _np(R.rglru_ref(*ts)), **tol(dt))
    np.testing.assert_allclose(got, _np(JR.rglru_ref(*js)), **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rglru_chunked_emulation_extreme_decays(dt):
    """r = 1 at lam = 6 gives a = exp(-8 softplus(6)), about e^-48, a near
    reset; r = 0 gives a = 1 (and g = 1e-6 i x), no decay at all; both
    scattered inside and across chunks, with lam in f32 against x in
    ``dt``."""
    js, ts = _lru_inputs(2, 2 * LRU_CHUNK + 1, 24, dt, seed=9)
    r = np.asarray(js[1], np.float32).copy()
    pick = np.random.default_rng(1).integers(0, 4, size=r.shape)
    r[pick == 0] = 1.0
    r[pick == 1] = 0.0
    lam = np.full(24, 6.0)
    lam[::2] = np.linspace(2.0, 6.0, 12)
    jr = jnp.asarray(r, DTYPES[dt][0])
    jlam = jnp.asarray(lam, jnp.float32)
    x, i = ts[0], ts[2]
    rt, lamt = _to_torch(jr), _to_torch(jlam)
    assert float(torch.exp(-8 * torch.nn.functional.softplus(lamt[1]))) < \
        np.exp(-48)
    got = _rglru_chunked_emulation(x, rt, i, lamt)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(R.rglru_ref(x, rt, i, lamt)),
                               **tol(dt))
    np.testing.assert_allclose(_np(got), _np(JR.rglru_ref(js[0], jr, js[2],
                                                          jlam)), **tol(dt))


# ------------------------------------------------------------------- block
@functools.lru_cache(maxsize=None)
def _block():
    jcfg = JC.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JRec.init_recurrent_block(jax.random.PRNGKey(3), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


@pytest.mark.parametrize("S,use_kernel", [(12, False), (12, True),
                                          (2, True), (128, True)])
def test_recurrent_block_matches_reference(S, use_kernel):
    """Train/prefill path (output and returned state), with and without
    the kernel, then three decode steps from that state."""
    jcfg, cfg, jp, p = _block()
    x = np.random.default_rng(S).standard_normal((2, S, 256)).astype(
        np.float32)
    jout, jstate = JRec.recurrent_block_fwd(jp, jcfg, jnp.asarray(x),
                                            return_state=True,
                                            use_kernel=use_kernel)
    with torch.no_grad():
        out, state = Rec.recurrent_block_fwd(p, cfg, torch.from_numpy(x),
                                             return_state=True,
                                             use_kernel=use_kernel)
        assert Rec.recurrent_block_fwd(p, cfg, torch.from_numpy(x)).shape \
            == out.shape
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(state[name]), _np(jstate[name]),
                                   **TOL)
    state = {"h": state["h"].float().clone(), "conv": state["conv"].clone()}
    for step in range(3):
        xt = np.random.default_rng(step).standard_normal((2, 1, 256)).astype(
            np.float32)
        jout, jstate = JRec.recurrent_block_fwd(jp, jcfg, jnp.asarray(xt),
                                                state=jstate)
        with torch.no_grad():
            out, got = Rec.recurrent_block_fwd(p, cfg, torch.from_numpy(xt),
                                               state=state)
        assert got is state          # updated in place
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(_np(state[name]), _np(jstate[name]),
                                       **TOL)


# ----------------------------------------------------------------- stacked
@functools.lru_cache(maxsize=None)
def _setup(n_layers=3):
    """Reduced recurrentgemma with ``n_layers`` layers: 3 is one cycle, 5
    a cycle and a tail of (rec, rec)."""
    jcfg = dataclasses.replace(JC.get_config(ARCH).reduced(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers)
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
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


@pytest.mark.parametrize("n_layers", [3, 5])
def test_layer_groups_and_leaves_match_reference(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    assert ST.layer_groups(cfg) == JST.layer_groups(jcfg)
    own = ST.init_params(cfg, seed=0, device="cpu")
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for tree in (params, own):
        assert [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
                for p, l in T.leaves_with_paths(tree)] == want


@pytest.mark.parametrize("n_layers", [3, 5])
def test_forward_matches_reference(n_layers):
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((2, 24), cfg.vocab, n_layers)
    jlogits, _ = JST.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        logits = ST.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


@pytest.mark.parametrize("n_layers,S,ref_kernels", [
    (3, 12, True), (3, 128, True), (3, 200, False),
    (5, 12, True), (5, 128, True), (5, 200, False)])
def test_prefill_with_kernels_matches_reference(n_layers, S, ref_kernels):
    """The port's ``prefill(use_kernels=True)`` (plain versions of both
    kernels on the CPU) against the reference's prefill with its Pallas
    kernels (interpret mode) where they take S, and its kernel-free prefill
    at S=200: the last logits and every cache leaf."""
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((1, S), cfg.vocab, S)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         cfg.window, use_kernels=ref_kernels)
    before = (K.flash_attention.launches, K.rglru_scan.launches)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks),
                                    cfg.window, use_kernels=True)
    assert (K.flash_attention.launches, K.rglru_scan.launches) == before
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
    _same_trees(caches, jc, **TOL)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_decode_steps_match_reference(n_layers):
    """Prefill, then four decode steps with one position for the batch, as
    the reference's ``decode_step`` takes it; every state and cache leaf
    after each step."""
    jcfg, cfg, jparams, params = _setup(n_layers)
    toks = _tokens((2, 12), cfg.vocab, 8)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         cfg.window)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks),
                                    cfg.window)
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
    reference's batch-1 step on each row, from zero state, on the
    cycle+tail model."""
    jcfg, cfg, jparams, params = _setup(5)
    starts = [0, 5, 11]
    jcs = [JST.init_cache(jcfg, 1, cfg.window) for _ in starts]
    caches = ST.init_cache(cfg, len(starts), cfg.window, device="cpu")
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    rng = np.random.default_rng(9)
    for it in range(6):
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


# ------------------------------------------------------------------ engine
def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(3, 40))).astype(np.int32),
        max_new_tokens=int(rng.integers(4, 20))) for i in range(n)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.rid: r.output for r in engine.run_to_completion()}


@functools.lru_cache(maxsize=None)
def _reference_outputs():
    jcfg, cfg, jparams, _ = _setup(3)
    eng = JE.ServeEngine(jparams, jcfg, max_slots=3, cache_len=cfg.window)
    return _serve(eng, _requests(JE.Request, 4, cfg.vocab, 4)), eng.stats()


@pytest.mark.parametrize("decode_batch", [None, 2])
def test_engine_matches_reference_engine(decode_batch):
    """The same requests through the reference engine and the port's at
    ``cache_len == window``: equal greedy tokens, request by request, and
    equal step counts.  With ``decode_batch=2`` the port gathers and
    scatters the nested caches in chunks of two slots; the tokens do not
    depend on it."""
    _, cfg, _, params = _setup(3)
    want, stats = _reference_outputs()
    eng = E.ServeEngine(params, cfg, max_slots=3, cache_len=cfg.window,
                        decode_batch=decode_batch)
    assert _serve(eng, _requests(E.Request, 4, cfg.vocab, 4)) == want
    assert eng.stats()["decode_steps"] == stats["decode_steps"]
    assert eng.stats()["tokens"] == stats["tokens"]


def test_engine_refuses_cache_longer_than_window():
    _, cfg, _, params = _setup(3)
    with pytest.raises(ValueError):
        E.ServeEngine(params, cfg, max_slots=2, cache_len=cfg.window + 1)
    E.ServeEngine(params, cfg, max_slots=2, cache_len=cfg.window)
