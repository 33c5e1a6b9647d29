"""The port's unfused-bucket staging (``ops.bucket_pack``, the counterpart
of the reference's ``bucket_pack_kernel``) on the CPU: its plain version
bitwise against the JAX oracle ``bucket_pack_ref`` and the Pallas kernel in
interpret mode, in f32, bf16 and mixed buckets; and ``sync_grads`` over
unfused ``ar`` and ``rs_ag`` buckets at k in {1, 3}, on two gloo ranks,
bitwise equal to the cat-and-convert staging it replaced.  The CUDA kernel
is held to the plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view({4: torch.int32, 2: torch.int16}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _leaves(sizes, dt, seed):
    """Leaves of ``sizes`` in ``dt`` ("f32", "bf16", or "mixed": f32 and
    bf16 in turns), as JAX arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    kinds = {"f32": [jnp.float32], "bf16": [jnp.bfloat16],
             "mixed": [jnp.float32, jnp.bfloat16]}[dt]
    js = [jnp.asarray(rng.standard_normal(s), kinds[i % len(kinds)])
          for i, s in enumerate(sizes)]
    return js, [_to_torch(a) for a in js]


# tests/test_kernels.py::test_bucket_pack's sizes, total = sum + 13
@pytest.mark.parametrize("sizes", [[17], [31, 64], [5, 1000, 3]])
@pytest.mark.parametrize("dt", ["f32", "bf16", "mixed"])
def test_bucket_pack_matches_reference_bitwise(sizes, dt):
    js, ts = _leaves(sizes, dt, sum(sizes))
    total = sum(sizes) + 13
    before = K.bucket_pack.launches
    got = K.bucket_pack(ts, total)
    assert K.bucket_pack.launches == before     # the plain version ran
    assert got.dtype == torch.float32 and got.shape == (total,)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(JR.bucket_pack_ref(js, sizes, total)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(JK.bucket_pack(js, total)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(R.bucket_pack_ref(ts, total)))


@pytest.mark.parametrize("sizes", [[17], [5, 1000, 3]])
@pytest.mark.parametrize("out_dt", ["bf16", "f16"])
def test_bucket_pack_other_out_dtypes_match_pallas(sizes, out_dt):
    """A bucket staged in bf16 or f16 (round to nearest even) against the
    Pallas kernel with the same ``out_dtype``."""
    js, ts = _leaves(sizes, "mixed", 3)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f16": (jnp.float16, torch.float16)}[out_dt]
    total = sum(sizes) + 5
    got = K.bucket_pack(ts, total, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got),
                                  _bits(JK.bucket_pack(js, total, jdt)))


def test_bucket_pack_refuses_what_the_kernel_does_not_take():
    _, ts = _leaves([4, 6], "f32", 0)
    with pytest.raises(ValueError):       # empty bucket
        K.bucket_pack([], 4)
    with pytest.raises(ValueError):       # total below the bucket's size
        K.bucket_pack(ts, 9)
    with pytest.raises(TypeError):        # f64 leaf
        K.bucket_pack([ts[0].double()], 4)
    with pytest.raises(TypeError):        # f64 out
        K.bucket_pack(ts, 10, torch.float64)


def test_bucket_pack_plan_is_the_fused_pack_at_dp1_one_chunk():
    """The kernel's copy plan: each leaf once, in order, then one run of
    zeros up to ``total``."""
    sizes = [5, 1000, 3]
    assert K.pack_segments(sizes, 1021, 1, 1) == [
        (0, 0, 0, 5), (1, 0, 5, 1000), (2, 0, 1005, 3), (-1, 0, 1008, 13)]


# ------------------------------------------------ two-rank sync_grads
SHAPES = [(17,), (31, 64), (5,), (1000,), (3, 3), (40,), (7, 11)]
DTYPES = ["bfloat16", "bfloat16", "float32", "bfloat16", "float32",
          "float16", "bfloat16"]
# all-bf16, mixed f32/bf16, all-f32 (one leaf), f16 + bf16 (promoted to f32)
BUCKETS = [[0, 1], [2, 3], [4], [5, 6]]
CASES = {f"{kind}_k{k}": (kind, k) for kind in ("ar", "rs_ag")
         for k in (1, 3)}

_SYNC = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import train_step as TS
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import chunk_cuts
d, meta, rank = sys.argv[1], json.load(open(sys.argv[2])), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=2)


def cat_and_convert(grads, strategy):
    # the unfused staging sync_grads had before bucket_pack: torch.cat in
    # the promoted dtype, then convert_copy to f32; the rest as it is
    dp = dist.get_world_size()
    out = [None] * len(grads)
    for bi, bucket in enumerate(strategy.buckets):
        leaves = [grads[i] for i in bucket]
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dt = flat.dtype
        f32 = flat if dt == torch.float32 else K.convert_copy(flat,
                                                              torch.float32)

        def reduce_one(part):
            if strategy.comm_kind(bi) == "rs_ag":
                return TS._rs_ag_mean(part, dp, None)
            part = part.contiguous()
            TS._all_reduce(part, None)
            return part / dp

        n = f32.numel()
        k = min(strategy.chunk_count(bi), max(n, 1))
        if k > 1:
            cuts = chunk_cuts(n, k)
            f32 = torch.cat([reduce_one(f32[cuts[c]:cuts[c + 1]])
                             for c in range(k)])
        else:
            f32 = reduce_one(f32)
        fused = f32 if dt == torch.float32 else K.convert_copy(f32, dt)
        off = 0
        for i, g in zip(bucket, leaves):
            out[i] = fused[off:off + g.numel()].view(g.shape)
            off += g.numel()
    return out


rng = np.random.default_rng(11 + rank)
grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
    getattr(torch, dt)) for s, dt in zip(meta["shapes"], meta["dtypes"])]
out = {}
for name, (kind, k) in meta["cases"].items():
    nb = len(meta["buckets"])
    strat = TS.GradSyncStrategy(meta["buckets"], comms=[kind] * nb,
                                chunks=[k] * nb, fused=[0] * nb)
    TS.reset_collectives()
    K.reset_launches()
    synced = TS.sync_grads([g.clone() for g in grads], strat)
    out[f"{name}_counts"] = np.array(json.dumps(
        [TS.COLLECTIVES, K.bucket_pack.launches]))
    old = cat_and_convert([g.clone() for g in grads], strat)
    for i, (a, b) in enumerate(zip(synced, old)):
        out[f"{name}_{i}_dtypes"] = np.array(f"{a.dtype} {b.dtype}")
        out[f"{name}_{i}_new"] = a.float().numpy()
        out[f"{name}_{i}_old"] = b.float().numpy()
np.savez(f"{d}/rank{rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_rank_unfused(tmp_path_factory):
    """``sync_grads`` and the old cat-and-convert staging on the same
    per-rank gradients, in two gloo ranks."""
    d = tmp_path_factory.mktemp("unfused2")
    meta = d / "meta.json"
    meta.write_text(json.dumps({"shapes": SHAPES, "dtypes": DTYPES,
                                "buckets": BUCKETS, "cases": CASES}))
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _SYNC, str(d),
                               str(meta), str(r)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_unfused_sync_bitwise_unchanged(two_rank_unfused, case):
    """Each leaf's synced gradient, in dtype and in bits, equals what the
    old staging gave; an all-bf16 bucket comes back in bf16, a mixed one
    and an f16 + bf16 one as f32 views (ROADMAP C4); both ranks agree."""
    kind, k = CASES[case]
    want_dtypes = ["bfloat16", "bfloat16", "float32", "float32", "float32",
                   "float32", "float32"]
    for out in two_rank_unfused:
        for i in range(len(SHAPES)):
            new, old = str(out[f"{case}_{i}_dtypes"]).split()
            assert new == old == f"torch.{want_dtypes[i]}"
            np.testing.assert_array_equal(_bits(out[f"{case}_{i}_new"]),
                                          _bits(out[f"{case}_{i}_old"]))
            np.testing.assert_array_equal(
                _bits(out[f"{case}_{i}_new"]),
                _bits(two_rank_unfused[0][f"{case}_{i}_new"]))
        coll, packs = json.loads(str(out[f"{case}_counts"]))
        assert packs == 0                        # CPU tensors: no launch
        n = len(BUCKETS) * k
        if kind == "ar":
            assert coll == {"all_reduce": n, "reduce_scatter": 0,
                            "all_gather": 0}
        else:
            assert coll == {"all_reduce": 0, "reduce_scatter": n,
                            "all_gather": n}
