"""Parity of the port's decode and serving path with the JAX reference, on
reduced configs with the reference's weights (bridged): ``prefill`` (with
and without the flash kernel) and every cache leaf, ``decode_step`` (one
position for the batch, one per row, a window's ring buffer, the sinusoid
of ``rope_frac == 0``), the serving engine's greedy tokens against the
reference engine's on the same requests, and the port's copy of the
request-trace workload against the original."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import workload as W  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)   # test_flash_kernel_inside_model's


@functools.lru_cache(maxsize=None)
def _setup(arch="tinyllama-1.1b", window=None):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if window:
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _same_caches(got, want, **tol):
    want = jax.tree.leaves(want)
    got_leaves = [g[name] for g in got for name in sorted(g)]
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("S", [64, 128])
def test_prefill_with_kernels_matches_reference(S):
    """Port ``prefill(use_kernels=True)`` against the reference's (its
    attention in the Pallas kernel, interpret mode): the last logits and
    every cache leaf."""
    jcfg, cfg, jparams, params = _setup()
    toks = _tokens((1, S), cfg.vocab, S)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32), 160,
                         use_kernels=True)
    before = K.flash_attention.launches
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks), 160,
                                    use_kernels=True)
    assert K.flash_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _same_caches(caches, jc, **TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b",
                                  "transformer-paper"])
@pytest.mark.parametrize("cache_len", [0, 24, 64])
def test_prefill_without_kernels_matches_reference(arch, cache_len):
    """The reference engine's own prefill (no kernels), batch 2, with a
    cache longer than, shorter than and as long as (0) the prompt."""
    jcfg, cfg, jparams, params = _setup(arch)
    toks = _tokens((2, 40), cfg.vocab, 7)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         cache_len)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks),
                                    cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    _same_caches(caches, jc, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "transformer-paper"])
def test_decode_steps_match_reference(arch):
    """Prefill, then four decode steps with one position for the batch, as
    the reference's ``decode_step`` takes it."""
    jcfg, cfg, jparams, params = _setup(arch)
    toks = _tokens((2, 12), cfg.vocab, 8)
    jl, jc = JST.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32), 32)
    with torch.no_grad():
        logits, caches = ST.prefill(params, cfg, torch.from_numpy(toks), 32)
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    for pos in range(12, 16):
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int64)
        jl, jc = step(jc, jnp.asarray(nxt, jnp.int32), jnp.int32(pos))
        with torch.no_grad():
            logits, caches = ST.decode_step(params, cfg, caches,
                                            torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)
        _same_caches(caches, jc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_batched_decode_rows_match_reference_steps(window):
    """One position per row (the engine's batched decode) against the
    reference's batch-1 step on each row; with a window of 8 the ring
    buffer wraps."""
    jcfg, cfg, jparams, params = _setup(window=window)
    starts = [0, 5, 11]
    jcs = [JST.init_cache(jcfg, 1, 20) for _ in starts]
    caches = ST.init_cache(cfg, len(starts), 20, device="cpu")
    step = jax.jit(lambda c, t, p: JST.decode_step(jparams, jcfg, c, t, p))
    rng = np.random.default_rng(9)
    for it in range(12):
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
            np.testing.assert_allclose(logits[row].numpy(),
                                       np.asarray(jl[0]), rtol=1e-5,
                                       atol=1e-5)
    for row in range(len(starts)):
        _same_caches([{n: c[:, row:row + 1] for n, c in caches[0].items()}],
                     jcs[row], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ engine
def _requests(cls, n, vocab, seed, *, plen=(3, 16), new=(4, 12)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, size=int(rng.integers(*plen)))
        out.append(cls(rid=i, prompt=p.astype(np.int32),
                       max_new_tokens=int(rng.integers(*new))))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run_to_completion()
    return {r.rid: r.output for r in done}


@functools.lru_cache(maxsize=None)
def _reference_outputs(max_slots, cache_len, decode_batch, n, seed):
    jcfg, cfg, jparams, _ = _setup()
    eng = JE.ServeEngine(jparams, jcfg, max_slots=max_slots,
                         cache_len=cache_len, decode_batch=decode_batch)
    out = _serve(eng, _requests(JE.Request, n, cfg.vocab, seed))
    return out, eng.stats()


@pytest.mark.parametrize("max_slots,decode_batch,n", [
    (3, None, 7),      # full-width dispatch, slots refilled
    (2, None, 5),      # more requests than slots: slot reuse
    (4, 2, 5),         # gathered-chunk dispatch, a padded last chunk
])
def test_engine_matches_reference_engine(max_slots, decode_batch, n):
    """The same requests through the reference engine and the port's: the
    greedy tokens are equal, request by request, and the step counts too."""
    _, cfg, _, params = _setup()
    want, want_stats = _reference_outputs(max_slots, 64, decode_batch, n,
                                          max_slots)
    eng = E.ServeEngine(params, cfg, max_slots=max_slots, cache_len=64,
                        decode_batch=decode_batch)
    assert eng.decode_batch == (decode_batch or max_slots)
    got = _serve(eng, _requests(E.Request, n, cfg.vocab, max_slots))
    assert got == want
    assert eng.stats()["decode_steps"] == want_stats["decode_steps"]
    assert eng.stats()["tokens"] == want_stats["tokens"]


def test_engine_eos_stops():
    _, cfg, _, params = _setup()
    prompt = _tokens(6, cfg.vocab, 3).astype(np.int32)
    eng = E.ServeEngine(params, cfg, max_slots=1, cache_len=48)
    first = _serve(eng, [E.Request(rid=0, prompt=prompt, max_new_tokens=2)])
    eng = E.ServeEngine(params, cfg, max_slots=1, cache_len=48)
    done = _serve(eng, [E.Request(rid=0, prompt=prompt, max_new_tokens=16,
                                  eos_id=first[0][1])])
    assert done[0] == first[0]


def test_request_timing_none_until_finished():
    _, cfg, _, params = _setup()
    r = E.Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=4)
    assert r.ttft is None and r.latency is None
    clk = W.VirtualClock(5.0)
    eng = E.ServeEngine(params, cfg, max_slots=1, cache_len=48, clock=clk)
    eng.submit(r)
    assert r.submitted_at == 5.0 and r.ttft is None
    eng.step()
    assert r.ttft == 0.0 and r.latency is None
    clk.advance(1.0)
    eng.run_to_completion()
    assert r.latency == 1.0 and r.latency >= r.ttft >= 0.0


def test_engine_takes_a_duck_typed_plan_and_replays_a_workload():
    """A plan with slots/cache_len/decode_batch fields sets the engine's
    knobs (explicit kwargs win), and ``replay`` on a ``VirtualClock`` gives
    the reference engine's metrics exactly."""
    jcfg, cfg, jparams, params = _setup()

    @dataclasses.dataclass(frozen=True)
    class Plan:
        slots: int = 3
        cache_len: int = 48
        decode_batch: int = 2

    eng = E.ServeEngine(params, cfg, plan=Plan(), clock=W.VirtualClock())
    assert eng.plan == Plan()
    assert (eng.max_slots, eng.cache_len, eng.decode_batch) == (3, 48, 2)
    clamped = E.ServeEngine(params, cfg, plan=Plan(), max_slots=2,
                            decode_batch=8)
    assert (clamped.max_slots, clamped.decode_batch) == (2, 2)

    wl = W.Workload(n_requests=5, rate=64.0, concurrency=3,
                    prompt_lens=(3, 6), new_tokens=(2, 4), seed=2)
    got = W.replay(eng, wl, step_time=1e-3)
    ref = JE.ServeEngine(jparams, jcfg, plan=Plan(),
                         clock=JW.VirtualClock())
    want = JW.replay(ref, JW.Workload(**dataclasses.asdict(wl)),
                     step_time=1e-3)
    assert got == want
    assert got["completed"] == 5 and got["tokens_per_s"] > 0.0
    with pytest.raises(TypeError):
        W.replay(E.ServeEngine(params, cfg, max_slots=1, cache_len=16), wl)
    with pytest.raises(ValueError):     # the prompt fills the cache
        eng.submit(E.Request(rid=9, prompt=np.zeros(48, np.int32)))
        eng.run_to_completion()


# ---------------------------------------------------------------- workload
@pytest.mark.parametrize("kw", [
    {}, dict(n_requests=32, prompt_lens=(16, 2048), new_tokens=(32, 64)),
    dict(n_requests=7, rate=3.5, concurrency=2, seed=11)])
def test_workload_matches_reference(kw):
    got, want = W.Workload(**kw), JW.Workload(**kw)
    assert got.digest() == want.digest()
    assert got.to_tuple() == want.to_tuple()
    assert W.Workload.from_tuple(want.to_tuple()) == got
    assert ([dataclasses.astuple(r) for r in got.requests()]
            == [dataclasses.astuple(r) for r in want.requests()])
    assert got.arrival_fractions() == want.arrival_fractions()
    assert got.total_new_tokens == want.total_new_tokens
    reqs = W.materialize_requests(got, 512)
    ref = JW.materialize_requests(want, 512)
    assert all(isinstance(r, E.Request) for r in reqs)
    for a, b in zip(reqs, ref):
        assert (a.rid, a.max_new_tokens) == (b.rid, b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)
