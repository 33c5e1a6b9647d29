"""Parity of the port's WKV-6 kernel path (rwkv6-3b) with the JAX
reference, on the CPU: the WKV-6 plain version and its wrapper against the
JAX oracle, the reference's kernel-free scan and the Pallas kernel in
interpret mode, at lengths the Pallas kernel takes and at ragged ones; and
the CUDA kernel's chunked algorithm emulated step by step at its chunks'
edges and with extreme decays.  Inputs are made with numpy and handed to
both packages.  The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  The blocks, the
model and the engine are in ``tests/test_torch_rwkv_model.py``.

The reference's kernel path returns no WKV state (``final = None``); the
port's kernel returns it, so its final state is held to the reference's
kernel-free scan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import recurrent as JRec  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(dt):
    # tests/test_kernels.py::test_rwkv6: 5e-4 for f32, 5e-2 for bf16
    return (dict(rtol=5e-4, atol=5e-4) if dt == "f32"
            else dict(rtol=5e-2, atol=5e-2))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ------------------------------------------------------------------ kernel
def _wkv_inputs(B, S, H, hd, dt, seed=0, w_f32=True):
    """r, k, v in ``dt``; w in (0.45, 0.95) as tests/test_kernels.py draws
    it, in f32 (as the model passes it) or in ``dt``; u f32 (H, hd).  JAX
    arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hd)) for _ in range(3)]
    w = 1 / (1 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5 + 0.45
    u = rng.standard_normal((H, hd)) * 0.1
    jdt = DTYPES[dt][0]
    js = [jnp.asarray(a, jdt) for a in arrs]
    js.append(jnp.asarray(w, jnp.float32 if w_f32 else jdt))
    js.append(jnp.asarray(u, jnp.float32))
    return js, [_to_torch(a) for a in js]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd,w_f32", [
    (1, 128, 2, 64, True), (2, 256, 4, 32, False), (1, 256, 1, 128, True),
    (2, 1, 3, 64, False), (1, 129, 2, 64, True), (2, 37, 2, 32, True)])
def test_wkv6_ref_matches_jax_oracle_and_scan(dt, B, S, H, hd, w_f32):
    """The plain version's output against the JAX oracle ``rwkv6_ref``,
    and its output and final state against the reference's ``_wkv6_scan``
    (the kernel-free path), at the shapes of ``tests/test_kernels.py`` and
    at ragged lengths, with w in f32 and in the inputs' dtype."""
    js, ts = _wkv_inputs(B, S, H, hd, dt, seed=S + hd, w_f32=w_f32)
    out, final = R.rwkv6_ref(*ts)
    assert out.dtype == DTYPES[dt][1] and out.shape == (B, S, H, hd)
    assert final.dtype == torch.float32 and final.shape == (B, H, hd, hd)
    np.testing.assert_allclose(_np(out), _np(JR.rwkv6_ref(*js)), **tol(dt))
    jout, jfinal = JRec._wkv6_scan(*js)
    np.testing.assert_allclose(_np(out), _np(jout), **tol(dt))
    np.testing.assert_allclose(_np(final), _np(jfinal), **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 64, 128, 256])
def test_wkv6_wrapper_matches_pallas_interpret(dt, S):
    """The wrapper on CPU tensors (its plain version; no launch counted)
    against the reference's ``ops.rwkv6_wkv``, the Pallas kernel in
    interpret mode, at lengths it takes (a multiple of 128, or at most
    128); the final state against the reference's scan, since the Pallas
    kernel returns none."""
    js, ts = _wkv_inputs(1, S, 2, 64, dt, seed=S + 7)
    before = K.rwkv6_wkv.launches
    out, final = K.rwkv6_wkv(*ts)
    assert K.rwkv6_wkv.launches == before
    np.testing.assert_allclose(_np(out), _np(JK.rwkv6_wkv(*js)), **tol(dt))
    np.testing.assert_allclose(_np(final), _np(JRec._wkv6_scan(*js)[1]),
                               **tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 129, 200])
def test_wkv6_wrapper_ragged_matches_scan(dt, S):
    """Lengths the Pallas kernel refuses (129, 200: not a multiple of
    128), against the reference's kernel-free scan, output and state."""
    js, ts = _wkv_inputs(2, S, 3, 32, dt, seed=S)
    out, final = K.rwkv6_wkv(*ts)
    jout, jfinal = JRec._wkv6_scan(*js)
    np.testing.assert_allclose(_np(out), _np(jout), **tol(dt))
    np.testing.assert_allclose(_np(final), _np(jfinal), **tol(dt))


def test_wkv6_refuses_what_the_kernel_does_not_take():
    _, (r, k, v, w, u) = _wkv_inputs(1, 4, 2, 32, "f32")
    with pytest.raises(ValueError):       # k of another shape
        K.rwkv6_wkv(r, k[:, :2], v, w, u)
    with pytest.raises(ValueError):       # u of another width
        K.rwkv6_wkv(r, k, v, w, u[:, :16])
    with pytest.raises(ValueError):       # not (B, S, H, hd)
        K.rwkv6_wkv(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError):       # a head dim the kernel lacks
        K.rwkv6_wkv(*(t[..., :16] for t in (r, k, v, w)), u[:, :16])
    with pytest.raises(TypeError):        # mixed dtypes
        K.rwkv6_wkv(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError):        # w in neither f32 nor r's dtype
        K.rwkv6_wkv(r.bfloat16(), k.bfloat16(), v.bfloat16(), w.half(), u)
    with pytest.raises(TypeError):        # u not f32
        K.rwkv6_wkv(r, k, v, w, u.bfloat16())


# ------------------------------------------------- the kernel's algorithm
def _wkv_chunk(hd):
    # csrc/wkv6.cu: chunks of kChunkElems / hd = 4096 / hd steps
    return 4096 // hd


def _wkv6_chunked_emulation(r, k, v, w, u):
    """The chunked WKV-6 of ``csrc/wkv6.cu`` step by step in plain PyTorch,
    in f32.  Time is cut into chunks of C = 4096/hd steps.
    1. Each chunk but the last, from a zero state: k decayed to the chunk's
       end, K_t[i] = k_t[i] prod_{t < tau in chunk} w_tau[i], as products
       over segments of 16 steps (256/hd per key) times the later
       segments' products, and the chunk's state L_c = K^T V and decay
       D_c = prod w; no log, no division.
    2. The carry S_{c+1} = D_c S_c + L_c from S_0 = 0.
    3. Each chunk rerun step by step from S_c: out_t = r_t^T S + (sum_i
       r_t[i] u[i] k_t[i]) v_t, then S <- w_t S + k_t v_t^T; the last
       chunk's S is the final state.
    Returns ``(out, final)`` as :func:`repro_torch.kernels.ref.rwkv6_ref`."""
    B, S, H, hd = r.shape
    C, seg = _wkv_chunk(hd), 16
    rf, kf, vf, wf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v, w))
    uf = u.float()[None]                                      # (1,H,hd)
    n = -(-S // C)
    starts = [torch.zeros(B, H, hd, hd)]
    for c in range(n - 1):                                    # launches 1, 2
        ks, ws, vs = (t[:, :, c * C:(c + 1) * C] for t in (kf, wf, vf))
        kd = torch.empty_like(ks)
        segs = []
        for s0 in range(0, C, seg):
            p = torch.ones(B, H, hd)
            for t in reversed(range(s0, s0 + seg)):
                kd[:, :, t] = ks[:, :, t] * p
                p = p * ws[:, :, t]
            segs.append(p)
        for g, s0 in enumerate(range(0, C, seg)):
            later = torch.ones(B, H, hd)
            for p in segs[g + 1:]:
                later = later * p
            kd[:, :, s0:s0 + seg] *= later[:, :, None]
            if g == 0:
                decay = later * segs[0]
        state = torch.einsum("bhti,bhtj->bhij", kd, vs)
        starts.append(decay[..., None] * starts[-1] + state)
    out = torch.empty(B, H, S, hd)
    for c in range(n):                                        # launch 3
        st = starts[c].clone()
        for t in range(c * C, min(S, (c + 1) * C)):
            bonus = (rf[:, :, t] * uf * kf[:, :, t]).sum(-1)
            out[:, :, t] = (torch.einsum("bhi,bhij->bhj", rf[:, :, t], st)
                            + bonus[..., None] * vf[:, :, t])
            st = (wf[:, :, t, :, None] * st
                  + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    return out.permute(0, 2, 1, 3).to(r.dtype), st


def _extreme_decays(js, ts, dt, w_f32=True):
    """The same inputs with w set to exact 0, 1e-40 (denormal in f32) and
    exact 1 at scattered (step, key) entries of every head."""
    w = np.asarray(js[3], np.float32).copy()
    rng = np.random.default_rng(w.shape[1])
    pick = rng.integers(0, 8, size=w.shape)
    w[pick == 0] = 0.0
    w[pick == 1] = 1e-40
    w[pick == 2] = 1.0
    jw = jnp.asarray(w, jnp.float32 if w_f32 else DTYPES[dt][0])
    js = js[:3] + [jw, js[4]]
    ts = ts[:3] + [_to_torch(jw), ts[4]]
    return js, ts


def _check_emulation(js, ts, dt):
    """The emulation, output and final state, against the plain version,
    the reference's scan and, at lengths it takes, the Pallas kernel in
    interpret mode."""
    out, final = _wkv6_chunked_emulation(*ts)
    want, want_final = R.rwkv6_ref(*ts)
    np.testing.assert_allclose(_np(out), _np(want), **tol(dt))
    np.testing.assert_allclose(_np(final), _np(want_final), **tol(dt))
    jout, jfinal = JRec._wkv6_scan(*js)
    np.testing.assert_allclose(_np(out), _np(jout), **tol(dt))
    np.testing.assert_allclose(_np(final), _np(jfinal), **tol(dt))
    S = ts[0].shape[1]
    if S <= 128 or S % 128 == 0:
        np.testing.assert_allclose(_np(out), _np(JK.rwkv6_wkv(*js)),
                                   **tol(dt))


def _chunk_edges(hd):
    C = _wkv_chunk(hd)
    return [(hd, S) for S in (1, C - 1, C, C + 1, 2 * C + 1, 300)]


@pytest.mark.parametrize("dt,hd,S", [("f32", hd, S) for hd in (32, 64, 128)
                                     for _, S in _chunk_edges(hd)]
                         + [("bf16", 64, S) for _, S in _chunk_edges(64)])
def test_wkv6_chunked_emulation_matches_references(dt, hd, S):
    """The kernel's chunked algorithm at lengths on either side of its
    chunk (C = 4096/hd), B=2, w in f32 and in the inputs' dtype."""
    js, ts = _wkv_inputs(2, S, 2, hd, dt, seed=S * hd, w_f32=S % 2 == 0)
    _check_emulation(js, ts, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wkv6_chunked_emulation_extreme_decays(dt, hd):
    """w = 0 (a hard reset), w = 1e-40 (denormal) and w = 1 (no decay)
    inside and across chunks, at 2C + 1 steps: every decay stays a product
    of w, so each is its own limit and nothing turns into NaN."""
    S = 2 * _wkv_chunk(hd) + 1
    js, ts = _extreme_decays(*_wkv_inputs(2, S, 2, hd, dt, seed=hd), dt)
    out, final = _wkv6_chunked_emulation(*ts)
    assert torch.isfinite(out.float()).all() and torch.isfinite(final).all()
    _check_emulation(js, ts, dt)


def test_wkv6_chunk_state_resets_at_zero_decay():
    """A chunk whose last step has w = 0 on every key leaves from a zero
    start exactly its last step's k v^T: the emulation's carry takes the
    earlier chunks' states to exactly 0."""
    js, ts = _wkv_inputs(1, 2 * 64, 1, 64, "f32", seed=11)
    w = ts[3].clone()
    w[:, 63] = 0.0
    _, final_a = _wkv6_chunked_emulation(*ts[:3], w, ts[4])
    r, k, v, _, u = ts
    _, final_b = _wkv6_chunked_emulation(
        r[:, 63:], k[:, 63:], v[:, 63:], w[:, 63:], u)
    # the two runs chunk the remaining steps differently: f32 rounding
    np.testing.assert_allclose(_np(final_a), _np(final_b), rtol=1e-5,
                               atol=1e-5)
