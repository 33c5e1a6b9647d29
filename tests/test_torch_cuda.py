"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the gradient-sync kernels bitwise, flash attention at the
tolerances of ``tests/test_kernels.py`` and, against the plain version on
f32 copies of its inputs, to about one bf16 ulp; the RG-LRU scan and the
WKV-6 recurrence (its output and its final state) at the tolerances of
``tests/test_kernels.py``, both also at lengths on either side of their
chunks and with extreme decays (w = 0, denormal and 1; a near 0 and a =
1); the bucket pack bitwise.  Marked ``cuda``: they skip on a
machine without a CUDA device and run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _bits(t):
    return t.contiguous().view({4: torch.int32, 2: torch.int16}[
        t.element_size()]).cpu()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("src", DTYPES)
@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("n,offset", [(1, 0), (17, 0), (8192 * 3 + 5, 0),
                                      (100003, 1)])
def test_convert_copy(dev, src, dst, n, offset):
    x = torch.randn(n + offset, device=dev).mul_(1.001).to(src)[offset:]
    before = K.convert_copy.launches
    _same(K.convert_copy(x, dst), R.convert_copy_ref(x, dst))
    assert K.convert_copy.launches == before + 1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("sizes", [[17], [31, 64], [5, 100000, 3],
                                   [8192, 8192 * 2 + 1, 7]])
@pytest.mark.parametrize("dp,chunks,extra", [(1, 1, 0), (1, 2, 0), (2, 3, 0),
                                             (8, 4, 13), (3, 7, 1)])
def test_fused_pack_and_unpack(dev, dt, sizes, dp, chunks, extra):
    gen = torch.Generator(device=dev).manual_seed(sum(sizes) + dp + chunks)
    leaves = [torch.randn(s, generator=gen, device=dev).to(dt) for s in sizes]
    leaves[0] = leaves[0].float()       # a mixed-dtype bucket
    total = sum(sizes) + extra
    before = (K.fused_pack.launches, K.fused_unpack.launches)
    parts = K.fused_pack(leaves, total, dp, chunks)
    refs = R.fused_pack_ref(leaves, total, dp, chunks)
    assert len(parts) == len(refs)
    for p, r in zip(parts, refs):
        _same(p, r)
    if extra:
        return
    for p in parts:
        p.normal_(generator=gen)
    cuts = R.chunk_cuts(total, chunks)
    flat = torch.cat([p[:cuts[c + 1] - cuts[c]] for c, p in enumerate(parts)])
    out = [torch.full_like(l, float("nan")) for l in leaves]
    got = K.fused_unpack(parts, [l.shape for l in leaves],
                         [l.dtype for l in leaves], out=out)
    for g, o, r in zip(got, out, R.fused_unpack_ref(
            flat, [l.shape for l in leaves], [l.dtype for l in leaves])):
        assert g is o
        _same(g, r)
    assert (K.fused_pack.launches, K.fused_unpack.launches) == \
        (before[0] + 1, before[1] + 1)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(8, 2, device=dev).t()    # not contiguous
    with pytest.raises(ValueError):
        K.convert_copy(x, torch.bfloat16)
    with pytest.raises(ValueError):
        K.fused_pack([torch.zeros(4, device=dev), torch.zeros(4)], 8, 1)
    with pytest.raises(ValueError):
        K.fused_pack([x], 16, 1)


# --------------------------------------------------------- flash attention
def _flash_counts():
    f = K.flash_attention
    return f.launches, f.tc_launches, f.cuda_core_launches


def _flash_case(dev, B, S, T, H, KV, hd, dt, causal=True, window=None):
    gen = torch.Generator(device=dev).manual_seed(S * 7 + T + H + hd)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    before = _flash_counts()
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    # bf16 and f16 take the tensor-core kernel, f32 the CUDA-core one
    tc = dt != torch.float32
    assert _flash_counts() == (before[0] + 1, before[1] + tc,
                               before[2] + (not tc))
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == q.shape
    # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16 (and f16)
    t = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
    # f32 keeps p in f32; the tensor cores take p in q's dtype, so the
    # kernel splits it into hi = rn(p) and lo = rn(p - hi) and adds both
    # products, which keeps p to about 16 bits: against the plain version
    # on f32 copies either route is off by about one bf16 ulp of the output
    want32 = R.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    torch.testing.assert_close(got.float(), want32, rtol=8e-3, atol=2e-3)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S", [1, 7, 100, 129, 1000])
@pytest.mark.parametrize("longer_kv", [False, True])
def test_flash_attention_lengths(dev, dt, S, longer_kv):
    """Ragged lengths, T = S and T > S, at tinyllama's heads (32 over 4 KV
    heads, hd 64)."""
    _flash_case(dev, 1, S, S + 37 * longer_kv, 32, 4, 64, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_attention_groups_and_head_dims(dev, dt, G, hd):
    _flash_case(dev, 2, 129, 129, 2 * G, 2, hd, dt)


@pytest.mark.parametrize("S,T,causal,window", [
    (1, 1, True, None), (129, 129, True, None), (1000, 1000, True, None),
    (100, 137, True, None), (129, 300, False, None), (1000, 1000, True, 300),
    (3000, 3000, True, 2048)])
def test_flash_attention_recurrentgemma_heads(dev, S, T, causal, window):
    """recurrentgemma-9b's local attention: 16 query heads over 1 KV head
    at hd 256, ragged lengths, and a window shorter than the sequence."""
    for dt in (torch.float32, torch.bfloat16):
        _flash_case(dev, 1, S, T, 16, 1, 256, dt, causal, window)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32), (True, 500),
                                           (False, 32)])
@pytest.mark.parametrize("S,T", [(100, 100), (1000, 1000), (129, 300)])
def test_flash_attention_masks(dev, causal, window, S, T):
    for dt in (torch.float32, torch.bfloat16):
        _flash_case(dev, 1, S, T, 8, 2, 64, dt, causal, window)


@pytest.mark.parametrize("dt", DTYPES)
def test_flash_attention_unaligned_kv(dev, dt):
    """k and v starting off a 16-byte boundary take the kernel's scalar
    staging path."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 100 * 2 * 64
    buf = torch.randn(2 * n + 1, generator=gen, device=dev).to(dt)
    k = buf[1:n + 1].view(1, 100, 2, 64)
    v = buf[n + 1:].view(1, 100, 2, 64)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    q = torch.randn(1, 100, 8, 64, generator=gen, device=dev).to(dt)
    got = K.flash_attention(q, k, v)
    t = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               R.flash_attention_ref(q, k, v).float(),
                               rtol=t, atol=t)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S", [2047, 2048])
def test_flash_attention_path_shapes(dev, dt, S):
    """The serving paths' prefill shapes: tinyllama-1.1b's 32 query heads
    over 4 KV heads at hd 64, and recurrentgemma-9b's 16 over 1 at hd 256
    with window 2048."""
    _flash_case(dev, 1, S, S, 32, 4, 64, dt)
    _flash_case(dev, 1, S, S, 16, 1, 256, dt, window=2048)


@pytest.mark.parametrize("S", [1, 129, 2047, 2048])
def test_flash_attention_coder_heads(dev, S):
    """deepseek-coder-33b's prefill shape: 56 query heads over 8 KV heads
    (groups of 7, not a power of two) at hd 128, lengths on either side
    of the 128-key tiles, T = S and T = S + 1; f32 on the CUDA cores."""
    for T in (S, S + 1):
        _flash_case(dev, 1, S, T, 56, 8, 128, torch.bfloat16)
    _flash_case(dev, 1, S, S, 56, 8, 128, torch.float32)


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("S", [63, 64, 65, 127, 128, 129, 2047, 2048])
def test_flash_attention_tile_edges(dev, S, hd):
    """Lengths on either side of the tensor-core kernel's tiles (128 query
    rows; 128 keys, 64 at hd 256), with T = S and T = S + 1, causal and
    not."""
    H, KV = (8, 2) if hd == 64 else (4, 1)
    for T, causal in ((S, True), (S + 1, True), (S, False)):
        _flash_case(dev, 1, S, T, H, KV, hd, torch.bfloat16, causal)


@pytest.mark.parametrize("S,T", [(63, 129), (129, 63), (2048, 2047),
                                 (65, 2047)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
def test_flash_attention_two_batches(dev, S, T, dt):
    """B=2 with S and T on different sides of a tile edge."""
    _flash_case(dev, 2, S, T, 8, 2, 64, dt)
    _flash_case(dev, 2, S, T, 4, 1, 256, dt, window=100)


@pytest.mark.parametrize("window", [1, 37, 64, 100, 129, 200])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_window_inside_a_tile(dev, window, hd):
    """Windows whose edge falls inside a key tile, so tiles at the edge
    mask some rows' keys and skip tiles no row of a block sees."""
    H, KV = (8, 2) if hd == 64 else (4, 1)
    _flash_case(dev, 1, 700, 700, H, KV, hd, torch.bfloat16, True, window)
    _flash_case(dev, 1, 300, 300, H, KV, hd, torch.float16, False, window)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 8, 4, 96, device=dev)
    with pytest.raises(ValueError):          # head dim 96
        K.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 32, 256, device=dev)
    with pytest.raises(ValueError):          # 32 heads over one at hd 256
        K.flash_attention(q, q[:, :, :1].contiguous(),
                          q[:, :, :1].contiguous())
    q = torch.zeros(1, 8, 4, 64, device=dev)
    with pytest.raises(ValueError):          # k on the CPU, q on the card
        K.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):          # not contiguous
        K.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(RuntimeError):        # forward only
        K.flash_attention(q.requires_grad_(), q, q)


# ------------------------------------------------ flash attention backward
def _lse_bwd_counts():
    return K.flash_attention.lse_launches, K.flash_attention.bwd_launches


# the backward's gradients against autograd of the plain version on f32
# copies, as a share of the largest |gradient|: P and dS rounded to the
# input dtype before their products, as the plain path's einsums round
# them (bf16: at most 4.2e-3 read on the card; f16, three more bits:
# 5.4e-4); and against the plain backward in the same dtype, which rounds
# at the same places but from its own exp (at most 3.7e-3 read)
BWD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}
BWD_REF_TOL = 1e-2


def _bwd_case(dev, B, S, T, H, KV, dt, causal=True, window=None, hd=128):
    gen = torch.Generator(device=dev).manual_seed(S * 7 + T + H + KV)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    before = _lse_bwd_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert _lse_bwd_counts() == (before[0] + 1, before[1] + 1)
    # the forward with the log-sum-exp is the serving forward, bit for bit
    o, lse = K.flash_attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(o, K.flash_attention(q, k, v, causal=causal,
                                            window=window))
    assert torch.equal(o, out.detach())
    _, lse32 = R.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal, window=window,
                                     return_lse=True)
    torch.testing.assert_close(lse, lse32, rtol=1e-5, atol=1e-4)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want32 = torch.autograd.grad(R.flash_attention_ref(
        *f32, causal=causal, window=window), f32, do.float())
    want = R.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    for name, g, w32, w in zip("qkv", got, want32, want):
        assert g.dtype == dt and g.shape == w32.shape, name
        scale = float(w32.abs().max())
        err32 = float((g.float() - w32).abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err32 <= BWD_TOL[dt] * scale, (name, err32, scale)
        assert err <= BWD_REF_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,T,H,KV,causal,window", [
    (1, 200, 200, 8, 8, True, None),          # G = 1
    (2, 300, 300, 8, 2, True, None),          # G = 4
    (1, 1000, 1000, 7, 1, True, None),        # G = 7
    (2, 700, 700, 14, 2, True, 100),          # a window
    (1, 129, 300, 4, 1, False, None),         # ragged, S < T
    (1, 129, 300, 4, 1, True, None),          # keys no causal row sees
    (1, 300, 129, 4, 2, True, None),          # ragged, S > T
    (1, 1000, 1000, 4, 1, False, 200),
])
def test_flash_attention_backward(dev, dt, B, S, T, H, KV, causal, window):
    _bwd_case(dev, B, S, T, H, KV, dt, causal, window)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
def test_flash_attention_backward_coder_training_shape(dev, dt):
    """deepseek-coder-33b's training attention: 2 rows of 4096, 56 query
    heads over 8 KV heads at hd 128, causal."""
    _bwd_case(dev, 2, 4096, 4096, 56, 8, dt)


def test_flash_attention_backward_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):          # no backward at hd 64
        K.flash_attention(q.requires_grad_(), q, q)
    q = torch.zeros(1, 64, 4, 128, device=dev)
    with pytest.raises(RuntimeError):          # f32: forward only
        K.flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(TypeError):
        K.flash_attention_lse(q, q, q)


def test_sdpa_routes_long_training_attention_to_the_kernel(dev):
    """``sdpa`` takes the kernel both ways for long bf16 self-attention at
    hd 128, and keeps the chunked path for MLA's 192-wide fold and f32."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(34)

    def run(H, KV, hd, dt):
        q = torch.randn(1, 4096, H, hd, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(1, 4096, KV, hd, generator=gen,
                            device=dev).to(dt) for _ in range(2))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        before = (K.flash_attention.launches,) + _lse_bwd_counts()
        out = L.sdpa(*leaves, None)
        torch.autograd.grad(out, leaves, torch.ones_like(out))
        torch.cuda.synchronize()
        now = (K.flash_attention.launches,) + _lse_bwd_counts()
        return tuple(a - b for a, b in zip(now, before))

    assert run(8, 2, 128, torch.bfloat16) == (1, 1, 1)
    assert run(8, 8, 192, torch.bfloat16) == (0, 0, 0)    # MLA's fold
    assert run(8, 2, 128, torch.float32) == (0, 0, 0)


# the training step through the kernel against the chunked path: relative
# gaps of the loss, of the global gradient norm and of the worst leaf's
# gradient (the norm of the difference over the chunked path's norm), two
# bf16 paths that round at different places.  Read on the card (H100):
# 3.8e-5, 1.1e-4 and 2.0e-2; a wrong mask, head or scale moves them by
# their own scale.
LOSS_GAP_LIMIT, NORM_GAP_LIMIT, LEAF_GAP_LIMIT = 1e-3, 1e-3, 5e-2


def test_coder_training_step_through_the_kernel(dev, monkeypatch):
    """One loss and its gradients of deepseek-coder-33b at 4 layers (the
    benchmark's cut) on 2 rows of 4096 tokens, remat on: through the
    kernel (8 forwards with the log-sum-exp, remat's recompute included,
    and 4 backwards) against the same step through the chunked path, on
    the same bf16 weights and tokens.  The gaps printed are the
    readings."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import stacked as ST

    cfg = dataclasses.replace(get_config("deepseek-coder-33b"), n_layers=4)
    params = ST.init_params(cfg, seed=0, device=dev, draw_on_device=True)
    leaves = ST.leaves(params)
    gen = torch.Generator(device=dev).manual_seed(4096)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                                     device=dev)}

    def step():
        for p in leaves:
            p.requires_grad_(True)
        before = _lse_bwd_counts()
        loss = ST.loss_fn(params, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        torch.cuda.synchronize()
        used = tuple(a - b for a, b in zip(_lse_bwd_counts(), before))
        return float(loss), [g.float() for g in grads], used

    loss_k, grads_k, used_k = step()
    monkeypatch.setattr(L, "_flash_kernel_takes", lambda q, k, v: False)
    loss_c, grads_c, used_c = step()
    assert used_k == (2 * cfg.n_layers, cfg.n_layers) and used_c == (0, 0)
    loss_gap = abs(loss_k - loss_c) / abs(loss_c)
    norms = [float(g.norm()) for g in grads_c]
    leaf_gap = max(float((a - b).norm()) / max(n, 1e-30)
                   for a, b, n in zip(grads_k, grads_c, norms))
    norm_k = float(torch.sqrt(sum(g.square().sum() for g in grads_k)))
    norm_c = float(torch.sqrt(sum(g.square().sum() for g in grads_c)))
    print(f"coder 4 layers, 2 x 4096: loss {loss_k:.6f} (kernel) "
          f"{loss_c:.6f} (chunked), relative gap {loss_gap:.3e}; gradient "
          f"norm {norm_k:.6e} / {norm_c:.6e}, relative gap "
          f"{abs(norm_k - norm_c) / norm_c:.3e}; worst leaf's "
          f"|g_kernel - g_chunked| / |g_chunked| {leaf_gap:.3e}")
    assert math.isfinite(loss_k) and all(bool(torch.isfinite(g).all())
                                         for g in grads_k)
    assert loss_gap < LOSS_GAP_LIMIT
    assert abs(norm_k - norm_c) / norm_c < NORM_GAP_LIMIT
    assert leaf_gap < LEAF_GAP_LIMIT


# ------------------------------------------------------------------ RG-LRU
LRU_CHUNK = 32   # csrc/rglru.cu: kChunk steps per chunk


def _lru_case(dev, B, S, L, dt, lam_dt=None, extreme=False):
    """Gates in (0, 1) and lam in [2, 6]; with ``extreme``, r = 1 (a =
    exp(-8 softplus(lam)), about e^-48 where lam = 6) and r = 0 (a = 1)
    at scattered entries and lam = 6 on every other channel."""
    gen = torch.Generator(device=dev).manual_seed(B * 1000 + S + L)
    x = torch.randn(B, S, L, generator=gen, device=dev).to(dt)
    r = torch.rand(B, S, L, generator=gen, device=dev).to(dt)
    i = torch.rand(B, S, L, generator=gen, device=dev).to(dt)
    lam = torch.linspace(2.0, 6.0, L, device=dev)
    if extreme:
        pick = torch.randint(0, 4, r.shape, generator=gen, device=dev)
        r = r.masked_fill(pick == 0, 1.0).masked_fill(pick == 1, 0.0)
        lam[1::2] = 6.0
    lam = lam.to(lam_dt or dt)
    before = K.rglru_scan.launches
    got = K.rglru_scan(x, r, i, lam)
    torch.cuda.synchronize()
    assert K.rglru_scan.launches == before + 1
    assert got.dtype == dt and got.shape == x.shape
    want = R.rglru_ref(x, r, i, lam)
    # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16 (and f16)
    t = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S", [1, 7, 129, 1024, 2048])
def test_rglru_scan_serving_shapes(dev, dt, S):
    """recurrentgemma-9b's prefill shape (B=1, L=4096) at ragged
    lengths."""
    _lru_case(dev, 1, S, 4096, dt)


@pytest.mark.parametrize("B,S,L", [(2, 300, 4096), (3, 17, 100),
                                   (2, 129, 24), (1, 5, 1), (4, 64, 8)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rglru_scan_batches_and_widths(dev, B, S, L, dt):
    """Batches and widths, with lam in x's dtype and in f32."""
    _lru_case(dev, B, S, L, dt)
    _lru_case(dev, B, S, L, dt, lam_dt=torch.float32)


@pytest.mark.parametrize("S", [LRU_CHUNK - 1, LRU_CHUNK, LRU_CHUNK + 1,
                               2 * LRU_CHUNK + 1, 300])
@pytest.mark.parametrize("dt", DTYPES)
def test_rglru_scan_chunk_edges(dev, S, dt):
    """Lengths on either side of the kernel's chunk, B=2."""
    _lru_case(dev, 2, S, 4096, dt)


@pytest.mark.parametrize("S", [2 * LRU_CHUNK + 1, 2048])
@pytest.mark.parametrize("dt,lam_dt", [(torch.float32, None),
                                       (torch.bfloat16, None),
                                       (torch.bfloat16, torch.float32)])
def test_rglru_scan_extreme_decays(dev, S, dt, lam_dt):
    """a about e^-48 (a near reset) and a = 1 inside and across chunks."""
    _lru_case(dev, 2, S, 1000, dt, lam_dt, extreme=True)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [999, 4096])
def test_rglru_scan_one_channel_a_thread(dev, dt, L):
    """Inputs one element off an aligned base, or an odd width, take the
    kernel's path of one channel a thread; the result is the same."""
    B, S = 2, 70
    gen = torch.Generator(device=dev).manual_seed(L)
    x, r, i = (torch.rand(B * S * L + 1, generator=gen, device=dev).to(dt)
               [1:].view(B, S, L) for _ in range(3))
    lam = torch.linspace(2.0, 6.0, L, device=dev).to(dt)
    got = K.rglru_scan(x, r, i, lam)
    want = R.rglru_ref(x, r, i, lam)
    t = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


def test_rglru_scan_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 16, device=dev)
    lam = torch.zeros(16, device=dev)
    with pytest.raises(ValueError):          # lam on the CPU
        K.rglru_scan(x, x, x, lam.cpu())
    with pytest.raises(ValueError):          # not contiguous
        K.rglru_scan(x[:, ::2], x[:, ::2], x[:, ::2], lam)
    with pytest.raises(RuntimeError):        # forward only
        K.rglru_scan(x.requires_grad_(), x, x, lam)


# -------------------------------------------------------------- bucket pack
@pytest.mark.parametrize("out_dt", DTYPES)
@pytest.mark.parametrize("sizes", [[17], [31, 64], [5, 100000, 3],
                                   [8192, 8192 * 2 + 1, 7]])
@pytest.mark.parametrize("extra", [0, 13])
def test_bucket_pack(dev, out_dt, sizes, extra):
    """Mixed-dtype leaves into one buffer of each dtype, zero-padded, in
    one launch; bitwise equal to the plain version."""
    gen = torch.Generator(device=dev).manual_seed(sum(sizes) + extra)
    leaves = [torch.randn(s, generator=gen, device=dev).mul_(1.001).to(
        DTYPES[i % 3]) for i, s in enumerate(sizes)]
    total = sum(sizes) + extra
    before = K.bucket_pack.launches
    got = K.bucket_pack(leaves, total, out_dt)
    assert K.bucket_pack.launches == before + 1
    _same(got, R.bucket_pack_ref(leaves, total, out_dt))


def test_bucket_pack_unaligned_leaves(dev):
    """Leaves at 2-byte offsets take the kernel's scalar path."""
    base = torch.randn(100003, device=dev).bfloat16()
    leaves = [base[1:1000], base[1001:51002].float().contiguous(),
              base[51003:]]
    _same(K.bucket_pack(leaves, 100003), R.bucket_pack_ref(leaves, 100003))


# -------------------------------------------------------------------- WKV-6
WKV_CHUNK = {32: 128, 64: 64, 128: 32}   # csrc/wkv6.cu: 4096 / hd steps


def _wkv_case(dev, B, S, H, hd, dt, w_dt=torch.float32, seed=0,
              extreme=False):
    """Model-like inputs: decays exp(-exp(-2 + noise)) near 0.87, as the
    time mix's w0 = -2 gives them; with ``extreme``, also w = 0, 1e-40
    (denormal in f32) and 1 at scattered (step, key) entries."""
    gen = torch.Generator(device=dev).manual_seed(seed + S + hd)
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
               for _ in range(3))
    w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
        B, S, H, hd, generator=gen, device=dev)))
    if extreme:
        pick = torch.randint(0, 8, w.shape, generator=gen, device=dev)
        w = (w.masked_fill(pick == 0, 0.0).masked_fill(pick == 1, 1e-40)
             .masked_fill(pick == 2, 1.0))
    w = w.to(w_dt)
    u = 0.1 * torch.randn(H, hd, generator=gen, device=dev)
    before = K.rwkv6_wkv.launches
    out, final = K.rwkv6_wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert K.rwkv6_wkv.launches == before + 1
    assert out.dtype == dt and out.shape == r.shape
    assert final.dtype == torch.float32 and final.shape == (B, H, hd, hd)
    want, want_final = R.rwkv6_ref(r, k, v, w, u)
    # tests/test_kernels.py::test_rwkv6: 5e-4 for f32, 5e-2 for bf16
    t = 5e-4 if dt == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=t, atol=t)
    torch.testing.assert_close(final, want_final, rtol=t, atol=t)


@pytest.mark.parametrize("dt,w_dt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float16, torch.float32)])
@pytest.mark.parametrize("S", [1, 7, 129, 2048])
def test_rwkv6_wkv_serving_shapes(dev, dt, w_dt, S):
    """rwkv6-3b's prefill shape (B=1, 40 heads at hd 64) at ragged
    lengths, with w in f32 (as the model passes it) and in r's dtype."""
    _wkv_case(dev, 1, S, 40, 64, dt, w_dt)


@pytest.mark.parametrize("B,S,H,hd", [(2, 300, 4, 32), (3, 17, 2, 128),
                                      (1, 128, 2, 64), (2, 256, 1, 128)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_batches_and_head_dims(dev, B, S, H, hd, dt):
    _wkv_case(dev, B, S, H, hd, dt)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("edge", [-1, 0, 1, "2C+1"])
@pytest.mark.parametrize("dt,w_dt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_rwkv6_wkv_chunk_edges(dev, hd, edge, dt, w_dt):
    """Lengths on either side of the kernel's chunk (C = 4096/hd steps) and
    2C + 1, B=2, f32 and w in bf16."""
    C = WKV_CHUNK[hd]
    S = 2 * C + 1 if edge == "2C+1" else C + edge
    _wkv_case(dev, 2, S, 3, hd, dt, w_dt)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dt,w_dt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_rwkv6_wkv_extreme_decays(dev, hd, dt, w_dt):
    """w = 0 (a hard reset), 1e-40 and 1 inside and across chunks."""
    _wkv_case(dev, 2, 2 * WKV_CHUNK[hd] + 1, 3, hd, dt, w_dt, extreme=True)
    _wkv_case(dev, 1, 300, 2, hd, dt, w_dt, extreme=True)


def test_rwkv6_wkv_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 2, 32, device=dev)
    u = torch.zeros(2, 32, device=dev)
    with pytest.raises(ValueError):          # u on the CPU
        K.rwkv6_wkv(x, x, x, x, u.cpu())
    with pytest.raises(ValueError):          # not contiguous
        y = x.transpose(1, 2).contiguous().transpose(1, 2)
        K.rwkv6_wkv(y, y, y, y, u)
    with pytest.raises(RuntimeError):        # forward only
        K.rwkv6_wkv(x.clone().requires_grad_(), x, x, x, u)
