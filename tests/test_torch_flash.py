"""The port's flash attention on the CPU: its plain version and its wrapper
(which takes the plain version for CPU tensors) against the JAX package's
``flash_attention_ref`` and its Pallas kernel in interpret mode, over the
sweep of ``tests/test_kernels.py`` at its tolerances; ragged lengths the
Pallas kernel does not take, against the JAX oracle; the wrapper's checks;
and ``sdpa`` and the model forward with ``use_kernels`` against the
reference's.  The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}


def tol(dt):
    # tests/test_kernels.py: 2e-2 for bf16, 2e-5 for f32; f16 keeps more
    # mantissa than bf16, so the bf16 bound covers it
    return (dict(rtol=2e-5, atol=2e-5) if dt == "f32"
            else dict(rtol=2e-2, atol=2e-2))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _qkv(B, S, T, H, KV, hd, dt, seed=0):
    """The same q, k, v as JAX arrays and torch tensors (made with
    numpy)."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dt][0]
    js = [jnp.asarray(rng.standard_normal(s), jdt)
          for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    return js, [_to_torch(a) for a in js]


def _check(dt, js, ts, causal=True, window=None, pallas=True):
    """Port plain version and CPU wrapper against the JAX oracle and (where
    it takes the shape) the Pallas kernel in interpret mode."""
    want = [np.asarray(JR.flash_attention_ref(*js, causal=causal,
                                              window=window), np.float32)]
    if pallas:
        want.append(np.asarray(JFA.flash_attention_kernel(
            *js, causal=causal, window=window, interpret=True), np.float32))
    before = K.flash_attention.launches
    got_ref = R.flash_attention_ref(*ts, causal=causal, window=window)
    got_op = K.flash_attention(*ts, causal=causal, window=window)
    assert K.flash_attention.launches == before   # CPU: no kernel launch
    for got in (got_ref, got_op):
        assert got.dtype == DTYPES[dt][1] and got.shape == ts[0].shape
        for w in want:
            np.testing.assert_allclose(_np(got), w, **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 4, 2, 64),     # GQA
    (1, 256, 8, 1, 32),     # MQA
    (1, 128, 2, 2, 128),    # large head dim
])
def test_flash_causal_matches_jax(B, S, H, KV, hd, dt):
    js, ts = _qkv(B, S, S, H, KV, hd, dt)
    _check(dt, js, ts)


@pytest.mark.parametrize("window", [32, 128, 500])
def test_flash_window_matches_jax(window):
    js, ts = _qkv(1, 256, 256, 4, 2, 64, "f32", seed=1)
    _check("f32", js, ts, window=window)


def test_flash_noncausal_matches_jax():
    js, ts = _qkv(1, 128, 128, 4, 4, 64, "f32", seed=2)
    _check("f32", js, ts, causal=False)


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("S,T,causal,window", [
    (1, 1, True, None), (7, 7, True, None), (129, 129, True, None),
    (100, 130, True, None), (130, 100, True, None), (100, 130, False, None),
    (129, 129, True, 32), (37, 200, False, 64)])
def test_flash_ragged_matches_jax_oracle(dt, S, T, causal, window):
    """Lengths the Pallas kernel does not take (it asserts S and T are
    multiples of its 128 block), against the JAX oracle."""
    js, ts = _qkv(2, S, T, 8, 2, 64, dt, seed=S + T)
    _check(dt, js, ts, causal=causal, window=window, pallas=False)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    _, (q, k, v) = _qkv(1, 16, 16, 4, 2, 64, "f32")
    with pytest.raises(ValueError):       # head dim 96
        K.flash_attention(torch.zeros(1, 4, 2, 96), torch.zeros(1, 4, 2, 96),
                          torch.zeros(1, 4, 2, 96))
    with pytest.raises(ValueError):       # 4 heads over 3 KV heads
        K.flash_attention(torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 3, 64),
                          torch.zeros(1, 4, 3, 64))
    with pytest.raises(ValueError):       # k and v differ
        K.flash_attention(q, k, v[:, :8])
    with pytest.raises(TypeError):        # mixed dtypes
        K.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError):        # f64
        K.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        K.flash_attention(q, k, v, window=0)


# ----------------------------------- the tensor-core kernel's algorithm
def _tc_emulation(q, k, v, causal=True, window=None, split=True,
                  mask_value=float(np.finfo(np.float32).min), round_out=True):
    """The tensor-core kernel of ``csrc/flash_attention.cu``
    (``flash_tc_kernel``) in plain PyTorch: blocks of 128 query rows as
    two warpgroups of 64, key tiles of 128 (64 at hd 256), the tiles the
    masks hide from every row of a block never visited and a warpgroup
    skipping those they hide from all its rows; scores in f32 times
    log2(e)/sqrt(hd), masked to ``mask_value`` (the kernel's
    finfo(f32).min, also m's start) and keys past T to -inf; the online
    softmax in base 2 with m and l in f32 and l summed from the f32 P;
    P . V as products of 16-bit operands summed in f32, P split into hi =
    rn(P) and lo = rn(P - hi) (``split``) or rounded once; the output acc
    / max(l, 1e-30), rows past S dropped, rounded to q's dtype unless
    ``round_out`` is False.  Every warpgroup of every block steps through
    the key tiles together: at each tile, a warpgroup whose block does not
    visit it, or that skips it, keeps its m, l and acc.  One thread, as
    the small products run fastest alone on a shared host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _tc_emulation_rows(q, k, v, causal, window, split,
                                  mask_value, round_out)
    finally:
        torch.set_num_threads(threads)


def _tc_emulation_rows(q, k, v, causal, window, split, mask_value,
                       round_out):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dt = q.dtype
    BM, BN = 128, 64 if hd >= 256 else 128
    f32 = torch.float32
    qf = q.to(f32).permute(0, 2, 1, 3)                       # (B,H,S,hd)
    kf, vf = (t.to(f32).repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))                               # (B,H,T,hd)
    scale = (torch.tensor(1.4426950408889634, dtype=f32)
             / torch.sqrt(torch.tensor(float(hd), dtype=f32)))
    W = -(-S // 64)                                          # warpgroups
    rows = torch.arange(W * 64)
    qt = torch.zeros(B, H, W * 64, hd)
    qt[:, :, :S] = qf
    # each warpgroup's first row and its block's visited tiles [j0, j0+nt)
    r_lo = torch.arange(W) * 64
    q0 = r_lo // BM * BM
    q_last = torch.clamp(q0 + BM, max=S) - 1
    k_hi = torch.clamp(q_last + 1, max=T) if causal else torch.full_like(q0, T)
    k_lo = (torch.clamp(q0 - window + 1, min=0) if window
            else torch.zeros_like(q0))
    j0 = k_lo // BN
    nt = torch.clamp(-(-k_hi // BN) - j0, min=0)
    m = torch.full((B, H, W * 64), mask_value)
    l = torch.zeros(B, H, W * 64)
    acc = torch.zeros(B, H, W * 64, hd)
    for j in range(int((j0 + nt).max()) if W else 0):
        t0 = j * BN
        visit = (j >= j0) & (j < j0 + nt)
        if causal:
            visit &= t0 <= r_lo + 63     # else hidden from every row
        if window:
            visit &= t0 + BN - 1 > r_lo - window
        if not bool(visit.any()):
            continue
        live = visit.repeat_interleave(64)
        keys = torch.arange(t0, t0 + BN)
        kt, vt = torch.zeros(B, H, BN, hd), torch.zeros(B, H, BN, hd)
        n = max(0, min(BN, T - t0))      # TMA's zero fill past T
        kt[:, :, :n], vt[:, :, :n] = (kf[:, :, t0:t0 + n],
                                      vf[:, :, t0:t0 + n])
        x = (qt @ kt.transpose(-1, -2)) * scale
        ok = torch.ones(W * 64, BN, dtype=torch.bool)
        if causal:
            ok &= keys[None, :] <= rows[:, None]
        if window:
            ok &= keys[None, :] > rows[:, None] - window
        x = torch.where(ok, x, torch.tensor(mask_value))
        x = torch.where(keys >= T, torch.tensor(-np.inf), x)
        mx = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        hi = p.to(dt).to(f32)
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(dt).to(f32) @ vt
        l = torch.where(live, l * corr + p.sum(-1), l)
        acc = torch.where(live[:, None], acc * corr[..., None] + pv, acc)
        m = torch.where(live, mx, m)
    o = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    out = o[:, :, :S].permute(0, 2, 1, 3)
    return out.to(dt) if round_out else out


@pytest.mark.parametrize("dt", ["bf16", "f16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (1, 128, 4, 4, 64, True, None),
    (2, 256, 4, 2, 64, True, None),
    (1, 256, 8, 1, 32, True, None),
    (1, 256, 2, 2, 128, True, None),
    (1, 256, 4, 1, 256, True, None),
    (1, 384, 4, 1, 256, True, 100),
    (1, 256, 4, 2, 64, False, 37),
    (1, 128, 4, 2, 64, False, None),
])
def test_flash_tc_emulation_matches_jax(dt, B, S, H, KV, hd, causal,
                                        window):
    """The tensor-core kernel's algorithm against the JAX oracle and the
    Pallas kernel in interpret mode, at tests/test_kernels.py's 2e-2."""
    js, ts = _qkv(B, S, S, H, KV, hd, dt, seed=S + hd)
    got = _np(_tc_emulation(*ts, causal=causal, window=window))
    for want in (JR.flash_attention_ref(*js, causal=causal, window=window),
                 JFA.flash_attention_kernel(*js, causal=causal,
                                            window=window, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **tol(dt))


@pytest.mark.parametrize("S", [63, 64, 65, 127, 128, 129, 2047, 2048])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_tc_emulation_split_p(S, hd):
    """In bf16, at lengths on either side of the kernel's tiles, the
    algorithm with P split into hi + lo stays within the card's check
    against the plain version on f32 copies (rtol 8e-3, atol 2e-3), and
    before the output's rounding it is at least 16 times closer to them
    than with P rounded once to bf16: the rounding of P is what the split
    takes out."""
    H, KV, window = (4, 2, None) if hd == 64 else (2, 1, 2048)
    _, (q, k, v) = _qkv(1, S, S, H, KV, hd, "bf16", seed=S * hd)
    want = R.flash_attention_ref(q.float(), k.float(), v.float(),
                                 window=window)
    got = _tc_emulation(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=2e-3)
    e_split = (_tc_emulation(q, k, v, window=window, round_out=False)
               - want).abs().max()
    e_once = (_tc_emulation(q, k, v, window=window, split=False,
                            round_out=False) - want).abs().max()
    assert e_split * 16 < e_once, (float(e_split), float(e_once))


@pytest.mark.parametrize("window", [37, 100])
def test_flash_tc_emulation_masks_with_finfo_min(window):
    """A row whose first visited tile hides every key from it (its window
    starts in a later tile) takes weight exp(0) there, which the next live
    key's correction wipes out: with finfo(f32).min as the masked score
    and m's start the algorithm matches the JAX oracle; with -inf that row
    is NaN."""
    js, ts = _qkv(1, 300, 300, 4, 2, 64, "f32", seed=window)
    want = np.asarray(JR.flash_attention_ref(*js, window=window))
    got = _tc_emulation(*ts, window=window)
    np.testing.assert_allclose(_np(got), want, **tol("f32"))
    nan = _tc_emulation(*ts, window=window, mask_value=-np.inf)
    assert bool(torch.isnan(nan).any())


# ---------------------------------------------------------- in the model
@pytest.mark.parametrize("use_flash,masked", [(True, False), (False, False),
                                              (True, True)])
def test_sdpa_routes_as_the_reference(use_flash, masked):
    """``sdpa(use_flash=True)`` with no mask reaches the flash path (the
    Pallas kernel in the reference, the kernel's plain version here); with
    a mask both take the dense path."""
    js, ts = _qkv(2, 128, 128, 4, 2, 64, "f32", seed=3)
    jmask = tmask = None
    if masked:
        bias = np.where(np.random.default_rng(4).random((2, 1, 1, 128)) < .3,
                        np.finfo(np.float32).min, 0.0).astype(np.float32)
        jmask, tmask = jnp.asarray(bias), torch.from_numpy(bias)
    want = JL.sdpa(*js, jmask, use_flash=use_flash)
    got = L.sdpa(*ts, tmask, use_flash=use_flash)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@functools.lru_cache(maxsize=None)
def _tiny():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def test_flash_inside_model_matches_reference():
    """``forward(use_kernels=True)`` against the reference's (whose
    attention runs the Pallas kernel in interpret mode) and against the
    port's own path without kernels, at ``test_flash_kernel_inside_model``'s
    rtol and atol of 5e-4."""
    jcfg, cfg, jparams, params = _tiny()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 128))
    jl, _ = JST.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                        use_kernels=True)
    with torch.no_grad():
        got = ST.forward(params, cfg, torch.from_numpy(toks),
                         use_kernels=True)
        plain = ST.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=5e-4,
                               atol=5e-4)


# ------------------------------------------------- the backward's algorithm
def _grad_case(B, S, T, H, KV, hd, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(dtype)
               for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    do = torch.from_numpy(rng.standard_normal((B, S, H, hd))).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (1, 64, 64, 1, 1, 64, True, None),        # G = 1
    (2, 150, 150, 4, 1, 64, True, None),      # G = 4
    (1, 200, 200, 7, 1, 128, True, None),     # G = 7, the coder's group
    (1, 130, 130, 4, 1, 128, False, None),
    (1, 300, 300, 4, 1, 64, True, 50),        # window inside a key block
    (1, 300, 300, 7, 1, 64, False, 100),
    (2, 100, 170, 4, 2, 64, True, None),      # ragged, S < T
    (1, 170, 100, 4, 2, 128, True, None),     # ragged, S > T
    (1, 129, 300, 7, 7, 64, False, None),
    (1, 257, 257, 4, 4, 128, True, 129),
    (1, 65, 200, 4, 1, 64, False, 80),
    (2, 1, 1, 4, 2, 128, True, None),
])
def test_flash_bwd_ref_matches_autograd(B, S, T, H, KV, hd, causal, window):
    """The backward kernel's algorithm in plain PyTorch (recompute from the
    log-sum-exp, D = rowsum(dO * O), blocks of 128 keys over tiles of 64
    rows, dK and dV summed over each KV head's G query heads) against
    autograd of the plain forward, in f64."""
    q, k, v, do = _grad_case(B, S, T, H, KV, hd, seed=S * 7 + T + H)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = R.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    got = R.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("S,T,causal,window", [
    (100, 100, True, None), (70, 130, False, None), (200, 200, True, 33)])
def test_flash_ref_lse_is_logsumexp_of_masked_scores(S, T, causal, window):
    """The log-sum-exp the forward saves for the backward: per (batch,
    query head, row), natural log, of the scaled scores with masked ones
    at finfo(f32).min."""
    q, k, v, _ = _grad_case(2, S, T, 6, 2, 64, seed=S + T,
                            dtype=torch.float32)
    out, lse = R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    assert lse.shape == (2, 6, S) and lse.dtype == torch.float32
    torch.testing.assert_close(out, R.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    kh = k.repeat_interleave(3, dim=2)                     # head h -> h // 3
    s = torch.einsum("bshd,bthd->bhst", q, kh) / np.sqrt(64)
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = (kpos <= qpos) if causal else torch.ones(S, T, dtype=torch.bool)
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_wrapper_gradient_on_cpu(dt):
    """On the CPU the wrapper is the plain version, so autograd through it
    gives the gradients that :func:`ops.flash_attention_bwd` (the plain
    backward there) gives from :func:`ops.flash_attention_lse`; no kernel
    launches."""
    tdt = DTYPES[dt][1]
    q, k, v, do = _grad_case(1, 150, 150, 8, 2, 128, seed=11,
                             dtype=torch.float32)
    q, k, v, do = (t.to(tdt) for t in (q, k, v, do))
    before = (K.flash_attention.launches, K.flash_attention.lse_launches,
              K.flash_attention.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(K.flash_attention(*leaves, window=40),
                               leaves, do)
    out, lse = K.flash_attention_lse(q, k, v, window=40)
    got = K.flash_attention_bwd(q, k, v, out, lse, do, window=40)
    assert (K.flash_attention.launches, K.flash_attention.lse_launches,
            K.flash_attention.bwd_launches) == before
    for g, w in zip(got, want):
        assert g.dtype == tdt
        # in bf16 autograd rounds dP to bf16 and the plain backward does
        # not, so single elements differ by a few bf16 ulps of the largest
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= (
            2e-5 if dt == "f32" else 1e-2) * scale


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sdpa_long_on_cpu_keeps_the_chunked_path(monkeypatch, dt):
    """On the CPU, long self-attention (S = 4096) still takes the
    query-chunked path in bf16 at hd 128, the shape the kernel takes on
    the card, so the parity tests against the JAX package run as before."""
    seen = []

    def chunked(q, k, v, causal, window, qb=L._Q_BLOCK):
        seen.append(qb)
        return torch.zeros_like(q)

    def kernel(*a, **kw):
        raise AssertionError("the flash kernel's wrapper was called")

    monkeypatch.setattr(L, "_flash_xla", chunked)
    monkeypatch.setattr(K, "flash_attention", kernel)
    tdt = DTYPES[dt][1]
    q = torch.zeros(1, 4096, 8, 128, dtype=tdt)
    kv = torch.zeros(1, 4096, 1, 128, dtype=tdt)
    assert L.sdpa(q, kv, kv, None).shape == q.shape
    assert seen == [L._Q_BLOCK]


class _Shape:
    """What ``sdpa``'s route reads of a tensor, without a card."""

    def __init__(self, hd, dtype=torch.bfloat16, cuda=True):
        self.shape, self.dtype, self.is_cuda = (2, 4096, 8, hd), dtype, cuda


@pytest.mark.parametrize("q,k,v,takes", [
    (_Shape(128), _Shape(128), _Shape(128), True),             # the coder
    (_Shape(128, torch.float16), _Shape(128, torch.float16),
     _Shape(128, torch.float16), True),
    (_Shape(192), _Shape(192), _Shape(192), False),            # MLA's fold
    (_Shape(128, torch.float32), _Shape(128, torch.float32),
     _Shape(128, torch.float32), False),                       # f32
    (_Shape(64), _Shape(64), _Shape(64), False),               # no backward
    (_Shape(128, cuda=False), _Shape(128, cuda=False),
     _Shape(128, cuda=False), False),                          # the CPU
])
def test_sdpa_route_to_the_kernel(q, k, v, takes):
    """The kernel takes long self-attention by what ``sdpa`` sees of its
    inputs: on the card, bf16 or f16, a head dim with a backward kernel."""
    assert L._flash_kernel_takes(q, k, v) is takes
