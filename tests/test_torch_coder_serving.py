"""deepseek-coder-33b's serving path in the port against the reference, on
the CPU: a reduced model with the real head geometry (2 layers, d_model
896, 7 query heads over 1 KV head at hd 128, d_ff 2400, vocab cut to 1024;
f32) on the reference's weights bridged by ``params_from_jax``.

Held here: ``prefill``'s last logits and every cache entry (the flash
path's plain version and the dense path) against the reference's dense
prefill and, at lengths its Pallas kernel takes, its kernel in interpret
mode; the engine's greedy tokens against ``repro.serving.engine``'s on
prompts of 1, 129 and 300 tokens; flash attention at the 7:1 grouping
(the wrapper's plain version and the tensor-core kernel's algorithm,
emulated, against the JAX oracle); the parameter draw on the device
(``draw_on_device``), run on the CPU: bf16 leaves in the reference's tree,
at the host draw's scales, with no f32 stack ever made; and that the
serving path allocates no copy of a weight, and stacks its caches with no
second copy of them.

Tolerances: f32 forward values 1e-5 for the dense path, as the dense
stacked model's parity tests; 5e-4 where flash's plain version or the
Pallas kernel runs, as ``tests/test_torch_serving.py``; the kernel's
algorithm at ``tests/test_kernels.py``'s 2e-2 in bf16, and within the
card's bound against the plain version on f32 copies (rtol 8e-3, atol
2e-3).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.serving import engine as JE  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

from test_torch_flash import _tc_emulation  # noqa: E402

ARCH = "deepseek-coder-33b"
# the real head geometry at a width the CPU runs in seconds
CUT = dict(name=ARCH + "-reduced", n_layers=2, d_model=896, n_heads=7,
           n_kv_heads=1, head_dim=128, d_ff=2400, vocab=1024,
           dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_LEN = 320
PROMPTS = (1, 129, 300)


def _cfgs(**kw):
    kw = {**CUT, **kw}
    return (dataclasses.replace(jax_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = _cfgs()
    jparams = jax.jit(JST.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(n, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _same_caches(got, want, **tol):
    want = jax.tree.leaves(want)
    got = T.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# ------------------------------------------------------------------ config
def test_cut_keeps_the_published_head_geometry():
    """The cut config differs from the registry's in width and depth only:
    hd 128 and 56 / 8 = 7 query heads a KV head, as at full width."""
    full = get_config(ARCH)
    _, cfg = _cfgs()
    assert (full.hd, full.n_heads // full.n_kv_heads) == (128, 7)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == (128, 7)
    assert cfg.d_model == cfg.n_heads * cfg.hd
    same = {f.name for f in dataclasses.fields(full)} - set(CUT) - {
        "head_dim"}
    assert all(getattr(cfg, n) == getattr(full, n) for n in same)


def test_full_width_tree_matches_reference():
    """Full deepseek-coder-33b: the port's stacked tree (meta tensors) has
    the reference's key paths, shapes and dtypes (``jax.eval_shape``),
    33.3B parameters, 66.7 GB in bf16."""
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    jshape = jax.eval_shape(lambda k: JST.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(jshape)[0]]
    with torch.device("meta"):
        own = ST.init_params(cfg, device="meta")
    got = [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for p, a in T.leaves_with_paths(own)]
    assert got == want
    n = sum(math.prod(s) for _, s, _ in got)
    assert n == 33_342_991_360
    assert sum(math.prod(s) * (4 if d == "float32" else 2)
               for _, s, d in got) == 66_685_997_056


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("S", PROMPTS)
def test_prefill_matches_reference(S, use_kernels):
    """The port's ``prefill`` (flash's plain version with ``use_kernels``,
    else dense attention) against the reference's dense prefill: the last
    logits and every k/v entry."""
    jcfg, cfg, jparams, params = _setup()
    toks = _tokens((1, S), cfg.vocab, S)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         CACHE_LEN)
    before = K.flash_attention.launches
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks),
                                    CACHE_LEN, use_kernels=use_kernels)
    assert K.flash_attention.launches == before   # CPU: the plain version
    tol = FLASH_TOL if use_kernels else TOL
    assert logits.shape == (1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)
    _same_caches(caches, jc, **tol)


@pytest.mark.parametrize("S", [1, 256])
def test_prefill_matches_reference_pallas_kernel(S):
    """At lengths the reference's Pallas kernel takes (a multiple of its
    128-row block, or one row), its prefill through the kernel (interpret
    mode) against the port's through flash's plain version."""
    jcfg, cfg, jparams, params = _setup()
    toks = _tokens((1, S), cfg.vocab, S + 1)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         CACHE_LEN, use_kernels=True)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks),
                                    CACHE_LEN, use_kernels=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **FLASH_TOL)
    _same_caches(caches, jc, **FLASH_TOL)


def test_prefill_stacks_the_per_layer_caches_bitwise():
    """The stacked prefill's caches are the per-layer model's, stacked:
    each layer's copied into its slot as it finishes equals
    ``torch.stack`` over the finished layers, bit for bit."""
    _, cfg, _, params = _setup()
    toks = torch.from_numpy(_tokens((2, 40), cfg.vocab, 7))
    with torch.no_grad():
        _, got = ST.prefill(params, cfg, toks, 64)
        _, per_layer = M.prefill(M.from_stacked(params, cfg), cfg, toks, 64)
    assert [sorted(g) for g in got] == [["k", "v"]]
    for name in ("k", "v"):
        assert torch.equal(got[0][name],
                           torch.stack([c[name] for c in per_layer]))


# ------------------------------------------------------------------ engine
def _requests(cls, vocab, new=6):
    return [cls(rid=i, prompt=_tokens(n, vocab, 100 + n).astype(np.int32),
                max_new_tokens=new) for i, n in enumerate(PROMPTS)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.rid: r.output for r in engine.run_to_completion()}


def test_engine_matches_reference_engine():
    """Prompts of 1, 129 and 300 tokens through the reference engine and
    the port's at 2 slots (the third request takes a freed slot): the
    greedy tokens are equal, request by request, as are the decode
    steps."""
    jcfg, cfg, jparams, params = _setup()
    ref = JE.ServeEngine(jparams, jcfg, max_slots=2, cache_len=CACHE_LEN)
    want = _serve(ref, _requests(JE.Request, cfg.vocab))
    eng = E.ServeEngine(params, cfg, max_slots=2, cache_len=CACHE_LEN)
    got = _serve(eng, _requests(E.Request, cfg.vocab))
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert eng.stats()["decode_steps"] == ref.stats()["decode_steps"]


# ------------------------------------------------------- flash at 7:1, hd 128
def _qkv(S, H, KV, seed, dt="bf16"):
    rng = np.random.default_rng(seed)
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}[dt]
    js = [jnp.asarray(rng.standard_normal(s), jdt)
          for s in ((1, S, H, 128), (1, S, KV, 128), (1, S, KV, 128))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(
        {"bf16": torch.bfloat16, "f32": torch.float32}[dt]) for a in js]
    return js, ts


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,H,KV", [(1, 56, 8), (129, 56, 8), (128, 14, 2),
                                    (300, 7, 1)])
def test_flash_wrapper_at_coder_heads_matches_jax(S, H, KV, dt):
    """The wrapper (its plain version on the CPU) at 7 query heads a KV
    head and hd 128 against the JAX oracle, and where it takes the length
    the Pallas kernel in interpret mode."""
    js, ts = _qkv(S, H, KV, S + H, dt)
    t = dict(rtol=2e-5, atol=2e-5) if dt == "f32" else dict(rtol=2e-2,
                                                           atol=2e-2)
    want = [np.asarray(JR.flash_attention_ref(*js), np.float32)]
    if S % 128 == 0 or S == 1:
        want.append(np.asarray(JFA.flash_attention_kernel(*js,
                                                          interpret=True),
                               np.float32))
    got = K.flash_attention(*ts).float().numpy()
    for w in want:
        np.testing.assert_allclose(got, w, **t)


@pytest.mark.parametrize("S,H,KV", [(1, 56, 8), (129, 56, 8),
                                    (255, 14, 2), (2048, 7, 1)])
def test_flash_tc_emulation_at_coder_heads(S, H, KV):
    """The tensor-core kernel's algorithm (tiles of 128 query rows and 128
    keys at hd 128) at the 7:1 grouping, at lengths off the tiles (1, 129,
    255) and at the serving prefill's 2048: held to the JAX oracle at 2e-2
    and to the plain version on f32 copies within the card's bound."""
    js, (q, k, v) = _qkv(S, H, KV, 3 * S + H)
    got = _tc_emulation(q, k, v)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(JR.flash_attention_ref(*js),
                                        np.float32), rtol=2e-2, atol=2e-2)
    want32 = R.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want32, rtol=8e-3, atol=2e-3)


# ------------------------------------------------------ the draw on the card
def _bf16_cfgs():
    return _cfgs(dtype="bfloat16")


class _NewStorages(TorchDispatchMode):
    """Records, for every op, the storages its outputs own that none of its
    inputs shares (a view, or an in-place write, shares its input's): (op,
    bytes, dtype, the smallest parameter view among its inputs in bytes,
    or None)."""

    def __init__(self, weights=()):
        super().__init__()
        self.weights = {w.untyped_storage().data_ptr() for w in weights}
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_leaves((args, kwargs or {}))
               if isinstance(a, torch.Tensor)]
        ptrs = {a.untyped_storage().data_ptr() for a in ins}
        wts = [a.numel() * a.element_size() for a in ins
               if a.untyped_storage().data_ptr() in self.weights]
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor) and o.untyped_storage().data_ptr() \
                    not in ptrs:
                self.made.append((str(func), o.untyped_storage().nbytes(),
                                  o.dtype, min(wts) if wts else None))
        return out


def test_draw_on_device_gives_the_reference_tree_in_bf16():
    """The full-width path's draw, ``init_params(draw_on_device=True,
    by_layer=True)``, run on the CPU: the reference's key paths, shapes
    and dtypes (bf16 leaves, the f32 final norm), each weight at the
    whole-stack draw's scale (its standard deviation within 3%), and no
    f32 leaf bigger than a norm's."""
    jcfg, cfg = _bf16_cfgs()
    jshape = jax.eval_shape(lambda k: JST.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(jshape)[0]]
    drawn = ST.init_params(cfg, seed=0, device="cpu", draw_on_device=True,
                           by_layer=True)
    host = ST.init_params(cfg, seed=0, device="cpu")
    got = [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for p, a in T.leaves_with_paths(drawn)]
    assert got == want
    assert {d for _, _, d in got} == {"bfloat16", "float32"}
    assert max(a.numel() for a in T.leaves(drawn)
               if a.dtype == torch.float32) == cfg.d_model
    for (path, a), b in zip(T.leaves_with_paths(drawn), T.leaves(host)):
        if a.numel() > cfg.d_model * cfg.n_layers:
            sa, sb = float(a.float().std()), float(b.float().std())
            assert abs(sa / sb - 1) < 0.03, (path, sa, sb)


def test_draw_on_device_makes_no_f32_stack():
    """No storage the ``by_layer`` draw makes in f32 is larger than one
    layer's largest leaf in f32: each layer's leaves are drawn in f32,
    cast and copied into the stacks (drawn whole, each stack is f32
    first: 34 GB for each FFN stack at full width)."""
    _, cfg = _bf16_cfgs()
    with torch.device("meta"):
        shapes = ST.init_params(cfg, device="meta")
    one_layer = max(a[0].numel() * 4 for g in shapes["groups"]
                    for a in T.leaves(g))
    with _NewStorages() as rec:
        ST.init_params(cfg, seed=0, device="cpu", draw_on_device=True,
                       by_layer=True)
    f32 = [n for _, n, dt, _ in rec.made if dt == torch.float32]
    assert max(f32) <= one_layer, (max(f32), one_layer)


# --------------------------------------------------- no copy on the serving path
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_path_copies_no_weight(dtype):
    """One prefill of 64 tokens through the kernel path and one
    ``decode_step`` of 8 slots over a cache of 160 allocate no storage as
    large as the smallest stacked weight leaf (wk, (2, 896, 128)), and no
    op that reads a weight makes a new storage at least that weight's
    size (a cast, ``contiguous`` or clone of it): the per-layer view is
    ``unbind``, and every weight is read where it lies."""
    _, cfg = _cfgs(dtype=dtype)
    params = ST.init_params(cfg, seed=0, device="cpu",
                            draw_on_device=True, by_layer=True)
    stacked = [a for g in params["groups"] for a in T.leaves(g)
               if a.dim() == 3]
    smallest = min(a.numel() * a.element_size() for a in stacked)
    toks = torch.from_numpy(_tokens((1, 64), cfg.vocab, 64))
    caches = ST.init_cache(cfg, 8, 160, device="cpu")
    weights = stacked + [params["embed"], params["lm_head"]]
    with torch.no_grad(), _NewStorages(weights) as rec:
        ST.prefill(params, cfg, toks, 160, use_kernels=True)
        ST.decode_step(params, cfg, caches, toks[0, :8],
                       torch.arange(8) * 16 + 5)
    assert rec.made
    big = [m for m in rec.made if m[1] >= smallest]
    assert not big, big
    copies = [m for m in rec.made if m[3] is not None and m[1] >= m[3]]
    assert not copies, copies


def test_cache_stacking_makes_no_second_copy():
    """At 8 layers, ``init_cache`` (8 slots) and the stacked prefill hold
    their stacked caches plus one layer's at a time: the peak of the live
    storages they make (``StepCounter``) stays under 1.5 times the stacks'
    bytes, where ``torch.stack`` over the finished layers held every
    layer's beside the stacks (twice the caches)."""
    from repro_torch.launch.dryrun import StepCounter

    _, cfg = _cfgs(n_layers=8, d_ff=512)
    params = ST.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens((1, 40), cfg.vocab, 40))
    with StepCounter() as count:
        caches = ST.init_cache(cfg, 8, 256, device="cpu")
    total = sum(a.numel() * a.element_size() for a in T.leaves(caches))
    assert total <= count.peak < 1.5 * total, (count.peak, total)
    del caches
    with torch.no_grad(), StepCounter() as count:
        _, caches = ST.prefill(params, cfg, toks, 2048)
    total = sum(a.numel() * a.element_size() for a in T.leaves(caches))
    assert total <= count.peak < 1.5 * total, (count.peak, total)


def test_engine_admission_holds_one_prefill_cache():
    """Admitting 3 requests into 3 free slots runs 3 prefills in a row;
    each prefill's stacked cache is dropped once installed, so the peak of
    what the admission allocates (``StepCounter``) stays under 1.5 times
    one prefill's cache (the last one used to live on through the next
    prefill, 1 GiB beside the 8.3 GiB cache at full width)."""
    from repro_torch.launch.dryrun import StepCounter

    _, cfg = _cfgs(n_layers=8, d_ff=512)
    params = ST.init_params(cfg, seed=0, device="cpu")
    eng = E.ServeEngine(params, cfg, max_slots=3, cache_len=2048)
    for i in range(3):
        eng.submit(E.Request(rid=i, prompt=_tokens(16, cfg.vocab, i).astype(
            np.int32), max_new_tokens=4))
    row = sum(a[:, :1].numel() * a.element_size()
              for a in T.leaves(eng.caches))
    with StepCounter() as count:
        eng._admit()
    assert all(r is not None for r in eng.slot_req)
    assert row <= count.peak < 1.5 * row, (count.peak, row)
