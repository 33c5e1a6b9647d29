"""The port's gradient-sync staging kernels, on the CPU: their plain
versions against the JAX package's Pallas kernels (interpret mode) and its
``ref.py`` oracles, bitwise; and the segment plans that drive the CUDA
kernels, executed here with tensor slicing, against the plain versions.
The CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bucket_pack as JBP  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

SIZES = [[17], [31, 64], [5, 1000, 3]]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
DP_CHUNKS = [(dp, k) for dp in (1, 2, 3, 8) for k in (1, 2, 3, 4)]


def _leaves(sizes, dt, seed=0):
    """The same values as a JAX and a torch leaf list (made with numpy)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dt]
    jl = [jnp.asarray(rng.standard_normal(s), jdt) for s in sizes]
    tl = [_to_torch(np.asarray(a)) for a in jl]
    assert all(t.dtype == tdt for t in tl)
    return jl, tl


def _to_torch(a: np.ndarray):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Bit pattern of a torch or JAX array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        width = {4: torch.int32, 2: torch.int16}[x.element_size()]
        return x.view(width).numpy()
    a = np.asarray(x)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


@pytest.mark.parametrize("src,dst", [(s, d) for s in DTYPES for d in DTYPES])
@pytest.mark.parametrize("n", [17, 65536 + 9])
def test_convert_copy_matches_pallas(src, dst, n):
    jl, tl = _leaves([n], src)
    ref = JBP.convert_copy_kernel(jl[0], DTYPES[dst][0], interpret=True)
    got = K.convert_copy(tl[0], DTYPES[dst][1])
    assert got.dtype == DTYPES[dst][1] and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dp,chunks", DP_CHUNKS)
def test_fused_pack_matches_reference(sizes, dt, dp, chunks):
    """Exactly the reference's ``fused_pack_ref``: same cuts, same per-chunk
    padding, f32 upcast, true-zero tails."""
    jl, tl = _leaves(sizes, dt)
    total = sum(sizes) + (5 if dp == 3 else 0)   # also pad to `total`
    refs = JR.fused_pack_ref(jl, total, dp, chunks)
    got = K.fused_pack(tl, total, dp, chunks)
    assert len(got) == len(refs)
    for g, r in zip(got, refs):
        assert g.dtype == torch.float32 and g.numel() % dp == 0
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dp,chunks", [(1, 1), (8, 3)])
def test_fused_pack_matches_pallas(sizes, dt, dp, chunks):
    jl, tl = _leaves(sizes, dt, seed=1)
    total = sum(sizes)
    refs = JK.fused_pack(jl, total, dp, chunks)
    got = K.fused_pack(tl, total, dp, chunks)
    assert [g.shape[0] for g in got] == [r.shape[0] for r in refs]
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_unpack_matches_pallas(sizes, dt):
    """f32 -> grad dtype rounds to nearest even, as the Pallas kernel and
    ``fused_unpack_ref`` do; values are f32 noise so the casts round."""
    rng = np.random.default_rng(2)
    flat = rng.standard_normal(sum(sizes)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    shapes = [(s,) for s in sizes]
    jout = JK.fused_unpack(jnp.asarray(flat), shapes, [jdt] * len(sizes))
    jref = JR.fused_unpack_ref(jnp.asarray(flat), shapes, [jdt] * len(sizes))
    got = K.fused_unpack([torch.from_numpy(flat)], shapes,
                         [tdt] * len(sizes))
    for g, j, r in zip(got, jout, jref):
        assert g.dtype == tdt and tuple(g.shape) == tuple(j.shape)
        np.testing.assert_array_equal(_bits(g), _bits(j))
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dp,chunks", DP_CHUNKS)
def test_pack_unpack_roundtrip_from_chunks(sizes, dt, dp, chunks):
    """Unpack reads the padded chunks exactly as pack laid them out, and
    writes into ``out`` in place."""
    _, tl = _leaves(sizes, dt, seed=3)
    parts = K.fused_pack(tl, sum(sizes), dp, chunks)
    out = [torch.empty_like(t) for t in tl]
    res = K.fused_unpack(parts, [t.shape for t in tl], [t.dtype for t in tl],
                         out=out)
    for r, o, t in zip(res, out, tl):
        assert r is o
        np.testing.assert_array_equal(_bits(o), _bits(t))


def _run_pack_plan(leaves, total, dp, chunks):
    """Execute the CUDA pack's segment plan with tensor slicing."""
    lens = K.staged_lengths(total, dp, chunks)
    buf = torch.full((sum(lens),), float("nan"))
    for leaf, loff, soff, n in K.pack_segments([l.numel() for l in leaves],
                                               total, dp, chunks):
        buf[soff:soff + n] = (0.0 if leaf < 0 else
                              leaves[leaf].reshape(-1)[loff:loff + n].float())
    offs = np.cumsum([0] + lens)
    return [buf[offs[c]:offs[c + 1]] for c in range(len(lens))]


@pytest.mark.parametrize("sizes", SIZES + [[1, 1, 1], [4096, 7, 8192]])
@pytest.mark.parametrize("dp,chunks", DP_CHUNKS + [(8, 8), (1, 7)])
@pytest.mark.parametrize("extra", [0, 13])
def test_segment_plans_cover_the_layout(sizes, dp, chunks, extra):
    """The pack plan writes every staged element once (no NaN left) and
    equals the plain pack; the unpack plan reads it back into the leaves."""
    _, tl = _leaves(sizes, "bf16", seed=4)
    total = sum(sizes) + extra
    got = _run_pack_plan(tl, total, dp, chunks)
    for g, r in zip(got, R.fused_pack_ref(tl, total, dp, chunks)):
        np.testing.assert_array_equal(_bits(g), _bits(r))
    if extra:
        return
    out = [torch.full_like(t, float("nan")) for t in tl]
    for leaf, loff, c, coff, n in K.unpack_segments(sizes, chunks):
        out[leaf][loff:loff + n] = got[c][coff:coff + n].to(out[leaf].dtype)
    for o, t in zip(out, tl):
        np.testing.assert_array_equal(_bits(o), _bits(t))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.convert_copy(x, torch.float32)
    with pytest.raises(TypeError):
        K.convert_copy(x.float(), torch.int32)
    with pytest.raises(ValueError):
        K.fused_pack([torch.zeros(4)], 3, 1, 1)   # total < elements
    with pytest.raises(ValueError):
        K.fused_pack([torch.zeros(4), torch.zeros(4, device="meta")], 8, 1)
    with pytest.raises(ValueError):
        K.fused_unpack([torch.zeros(3)], [(4,)], [torch.float32])
    with pytest.raises(ValueError):
        K.fused_unpack([torch.zeros(4)], [(4,)], [torch.float32],
                       out=[torch.zeros(4, dtype=torch.bfloat16)])


def test_cpu_path_launches_no_kernel():
    K.reset_launches()
    K.convert_copy(torch.zeros(4), torch.bfloat16)
    parts = K.fused_pack([torch.zeros(4)], 4, 2, 2)
    K.fused_unpack(parts, [(4,)], [torch.float32])
    assert (K.convert_copy.launches, K.fused_pack.launches,
            K.fused_unpack.launches) == (0, 0, 0)
