"""The port's data pipeline, checkpoints and optimizer against the JAX
reference: same tokens for the same seed, checkpoints that each package
restores from the other, and optimizer steps that agree to f32 rounding."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import (params_from_jax, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synthetic_tokens_match_reference(seed, step):
    ref = JD.SyntheticLMDataset(32000, 48, 4, seed=seed)
    got = D.SyntheticLMDataset(32000, 48, 4, seed=seed)
    np.testing.assert_array_equal(got.global_step_batch(step),
                                  ref.global_step_batch(step))
    np.testing.assert_array_equal(got.shard_step_batch(step, 1, 2),
                                  ref.shard_step_batch(step, 1, 2))
    b = D.materialize_batch(get_config("qwen2-0.5b").reduced(), 4, 48,
                            seed=seed, device="cpu")
    jb = JD.materialize_batch(jax_config("qwen2-0.5b").reduced(), 4, 48,
                              seed=seed)
    assert b["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))


def _tree(rng):
    """A (params, opt)-shaped tree with bf16, f32 and int32 leaves."""
    params = {"embed": jnp.asarray(rng.standard_normal((8, 4)), jnp.bfloat16),
              "final_norm": {"scale": jnp.ones((4,), jnp.float32)},
              "groups": [{"w": jnp.asarray(rng.standard_normal((2, 4, 4)),
                                           jnp.float32)}]}
    mu = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape),
                                            jnp.float32), params)
    return (params, JO.OptState(mu, mu, jnp.asarray(7, jnp.int32)))


def test_checkpoints_cross_restore(tmp_path):
    rng = np.random.default_rng(0)
    jtree = _tree(rng)
    # reference -> port
    jax_save(str(tmp_path / "a"), 5, jtree)
    ptree = params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    got, step = restore_checkpoint(str(tmp_path / "a"), ptree)
    assert step == 5
    for g, j in zip(T.leaves(got), jax.tree.leaves(jtree)):
        assert str(g.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_array_equal(
            g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy(),
            np.asarray(j, np.float32 if j.dtype == jnp.bfloat16 else j.dtype))
    # port -> reference, with the same keypaths in meta.json
    save_checkpoint(str(tmp_path / "b"), 6, got)
    back, step = jax_restore(str(tmp_path / "b"), jtree)
    assert step == 6
    for b, j in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert b.dtype == j.dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(j))
    meta = [json.load(open(tmp_path / d / f"step_{s:08d}" / "meta.json"))
            for d, s in (("a", 5), ("b", 6))]
    assert meta[0]["leaves"] == meta[1]["leaves"]


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_clip_and_schedule_match_reference(pdtype):
    """Three clipped AdamW steps with a warmup-cosine lr.  rtol 1e-6: the
    port and XLA round the same f32 expressions, but may fuse a
    multiply-add where the other rounds twice."""
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (7,), (2, 4, 4)]
    jparams = [jnp.asarray(rng.standard_normal(s), pdtype) for s in shapes]
    params = params_from_jax([np.asarray(p) for p in jparams], device="cpu")
    jsched = JO.linear_warmup_cosine(1e-2, warmup=2, total_steps=6)
    sched = O.linear_warmup_cosine(1e-2, warmup=2, total_steps=6)
    for s in range(8):
        np.testing.assert_allclose(sched(s), float(jsched(jnp.asarray(s))),
                                   rtol=1e-7)
    jinit, jupdate = JO.adamw(jsched, weight_decay=0.01)
    init, update = O.adamw(sched, weight_decay=0.01)
    jstate = jinit(jax.tree.map(lambda p: p.astype(jnp.float32), jparams))
    state = init(params)
    for step in range(3):
        g = [rng.standard_normal(s).astype(np.float32) * (step + 1)
             for s in shapes]
        jg = [jnp.asarray(a, pdtype) for a in g]
        tg = params_from_jax([np.asarray(a) for a in jg], device="cpu")
        jg, jnorm = JO.clip_by_global_norm(jg, 1.0)
        tg, norm = O.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        jupd, jstate = jupdate(jg, jstate, jparams)
        jparams = JO.apply_updates(jparams, jupd)
        upd, state = update(tg, state, params)
        params = O.apply_updates(params, upd)
        assert int(state.count) == int(jstate.count) == step + 1
        for p, jp in zip(params, jparams):
            assert str(p.dtype).replace("torch.", "") == pdtype
            # bf16 params: one bf16 ulp where the f32 update lands on a
            # rounding boundary
            tol = 1e-6 if pdtype == "float32" else 8e-3
            np.testing.assert_allclose(p.float().numpy(),
                                       np.asarray(jp, np.float32), rtol=tol,
                                       atol=tol)
        for m, jm in zip(state.mu, jstate.mu):
            # atol: a few f32 ulps of the moments' scale, where
            # b1*m + (1-b1)*g cancels
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6,
                                       atol=1e-8)
