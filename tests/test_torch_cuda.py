"""The port's CUDA kernels on the card, against their plain PyTorch
versions, bitwise.  Marked ``cuda``: they skip on a machine without a
CUDA device and run on the GPU machine with

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
