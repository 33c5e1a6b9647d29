"""The int8 KV cache (``kv_cache_dtype="int8"``) of the port against the
reference, on the CPU with the reference's weights (bridged): the twin of
the reference's ``test_int8_kv_cache_decode_accuracy`` (stablelm-1.6b
reduced, f32, 12 decode steps from ``init_cache`` within 0.05 of the full
forward's logits), the cache those steps leave against the reference's,
``init_cache``'s leaves, one position per row, a GQA model, a bf16 model
and the serving engine's refusal.

Tolerances: in f32, int8 entries within 1 of the reference's (a value at
.5 may round the other way after an ulp of matmul difference; measured: all
equal); in bf16, within 2 (k and v differ from the reference's by a bf16 ulp
where the two packages' bf16 GEMMs round apart, which moves an entry near
127 by 0.5 and its row's scale by as much again; measured 2, in 10% of the
entries); scales within one bf16 step (2**-7 relative at most); logits
against the reference's int8 decode within 1e-3 in f32 (one flipped entry
moves a logit by about its scale times a weight; measured 1.3e-6) and 3e-2
in bf16 (measured 1.3e-2 at logits up to 1.2).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import stacked as JST  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

LOGIT_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
ENTRY_TOL = {"float32": 1, "bfloat16": 2}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               kv_cache_dtype="int8", dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              kv_cache_dtype="int8", dtype=dtype)
    jparams = jax.jit(JST.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _check_cache(got, want, dtype="float32"):
    """int8 entries within ``ENTRY_TOL``, bf16 scales within one bf16
    step."""
    for (path, g), w in zip(T.leaves_with_paths(got), jax.tree.leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if path.endswith(("['k']", "['v']")):
            assert np.abs(g - w).max() <= ENTRY_TOL[dtype], path
        else:
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=0,
                                       err_msg=path)


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, dtype, steps):
    jcfg, cfg, jparams, _ = _setup(arch, dtype)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, steps),
                                       0, jcfg.vocab))
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    caches = JST.init_cache(jcfg, 2, 16)
    logits = []
    for t in range(steps):
        lg, caches = step(caches, jnp.asarray(toks[:, t]), jnp.int32(t))
        logits.append(np.asarray(lg, np.float32))
    full, _ = jax.jit(lambda t: JST.forward(jparams, jcfg, t))(
        jnp.asarray(toks))
    return toks, logits, caches, np.asarray(full, np.float32)


@pytest.mark.parametrize("arch,dtype", [("stablelm-1.6b", "float32"),
                                        ("qwen2-0.5b", "float32"),
                                        ("stablelm-1.6b", "bfloat16")],
                         ids=["stablelm", "qwen2-gqa", "stablelm-bf16"])
def test_int8_decode_matches_reference(arch, dtype):
    """12 decode steps from ``init_cache`` at one position for the batch:
    each step's logits against the reference's int8 decode, and the cache
    they leave against the reference's."""
    _, cfg, _, params = _setup(arch, dtype)
    toks, want, jcaches, _ = _reference_decode(arch, dtype, 12)
    caches = ST.init_cache(cfg, 2, 16, device="cpu")
    for t in range(12):
        with torch.no_grad():
            lg, caches = ST.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(lg.float().numpy(), want[t],
                                   rtol=LOGIT_TOL[dtype],
                                   atol=LOGIT_TOL[dtype])
    _check_cache(caches, jcaches, dtype)


def test_int8_kv_cache_decode_accuracy():
    """The reference's test on the port: stablelm-1.6b reduced in f32, 12
    int8 decode steps within 0.05 of the full forward's logits; every
    leaf int8, bf16 or f32."""
    _, cfg, _, params = _setup("stablelm-1.6b")
    toks, _, _, _ = _reference_decode("stablelm-1.6b", "float32", 12)
    with torch.no_grad():
        full = ST.forward(params, cfg, torch.from_numpy(toks))
    caches = ST.init_cache(cfg, 2, 16, device="cpu")
    for leaf in T.leaves(caches):
        assert leaf.dtype in (torch.int8, torch.bfloat16, torch.float32)
    errs = []
    for t in range(12):
        with torch.no_grad():
            lg, caches = ST.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, t]), t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 0.05, f"int8 cache decode error too large: {max(errs)}"


def test_init_cache_int8_leaves_match_reference():
    """k, v int8 and k_scale, v_scale bf16 of (layers, B, T, KV), also in an
    f32 model, in the reference's leaf order."""
    jcfg, cfg, _, _ = _setup("qwen2-0.5b")
    want = [(jax.tree_util.keystr(p), l.shape, str(l.dtype)) for p, l in
            jax.tree_util.tree_flatten_with_path(
                JST.init_cache(jcfg, 3, 10))[0]]
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", "")) for p, l
           in T.leaves_with_paths(ST.init_cache(cfg, 3, 10, device="cpu"))]
    assert got == want
    assert [d for _, _, d in got] == ["int8", "bfloat16", "int8", "bfloat16"]


def test_int8_rows_at_their_own_positions():
    """One position per row (the engine's batched decode) against the
    reference's batch-1 steps at those positions, from the cache of 6
    steps."""
    jcfg, cfg, jparams, params = _setup("qwen2-0.5b")
    toks, _, _, _ = _reference_decode("qwen2-0.5b", "float32", 12)
    caches = ST.init_cache(cfg, 2, 16, device="cpu")
    jcaches = JST.init_cache(jcfg, 2, 16)
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    for t in range(6):
        with torch.no_grad():
            _, caches = ST.decode_step(params, cfg, caches,
                                       torch.from_numpy(toks[:, t]), t)
        _, jcaches = step(jcaches, jnp.asarray(toks[:, t]), jnp.int32(t))
    pos = np.array([6, 3])
    with torch.no_grad():
        lg, caches = ST.decode_step(params, cfg, caches,
                                    torch.from_numpy(toks[:, 6]),
                                    torch.from_numpy(pos))
    for b in range(2):
        one = jax.tree.map(lambda a: a[:, b:b + 1], jcaches)
        jl, one = step(one, jnp.asarray(toks[b:b + 1, 6]), jnp.int32(pos[b]))
        np.testing.assert_allclose(lg[b:b + 1].numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL["float32"],
                                   atol=LOGIT_TOL["float32"])
        _check_cache(T.map(lambda a: a[:, b:b + 1], caches), one)


def test_engine_refuses_an_int8_cache():
    """The prefill returns k/v in the activations' dtype and the engine
    would install them by leaf position into the four-leaf int8 cache (the
    reference engine raises a ValueError on the key mismatch): the port's
    engine raises when it is made."""
    _, cfg, _, params = _setup("stablelm-1.6b")
    with pytest.raises(ValueError, match="int8"):
        E.ServeEngine(params, cfg, max_slots=2, cache_len=16)
