"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the gradient-sync kernels bitwise, flash attention at the
tolerances of ``tests/test_kernels.py`` and, against the plain version on
f32 copies of its inputs, to about one bf16 ulp.  Marked ``cuda``: they skip on a
machine without a CUDA device and run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
def _flash_case(dev, B, S, T, H, KV, hd, dt, causal=True, window=None):
    gen = torch.Generator(device=dev).manual_seed(S * 7 + T + H + hd)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, T, KV, hd, generator=gen, device=dev).to(dt)
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == q.shape
    # tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16 (and f16)
    t = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
    # the kernel keeps p in f32: against the plain version on f32 copies it
    # is off by about one bf16 ulp of the output
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
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_attention_groups_and_head_dims(dev, dt, G, hd):
    _flash_case(dev, 2, 129, 129, 2 * G, 2, hd, dt)


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


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 8, 4, 96, device=dev)
    with pytest.raises(ValueError):          # head dim 96
        K.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=dev)
    with pytest.raises(ValueError):          # k on the CPU, q on the card
        K.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):          # not contiguous
        K.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(RuntimeError):        # forward only
        K.flash_attention(q.requires_grad_(), q, q)
