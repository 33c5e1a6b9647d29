"""Parity of the port's per-layer model (``repro_torch.models.model``) with
the reference's (``repro.models.model``), on the CPU in f32: the same
weights (the reference's ``init_params``, bridged) and the same tokens give
the same logits, loss and gradients; ``prefill`` then ``decode_step`` give
the same logits and caches; the per-layer tree has the reference's leaf
order (201 leaves for full tinyllama-1.1b); the port's stacked and
per-layer models agree on the same weights; and the port's ``sgd``
follows the reference's.

Reduced configs: tinyllama at 2 and 3 layers (dense), recurrentgemma
(3 layers, RG-LRU hybrid) and rwkv6 (2 layers).  Tolerances are the
stacked model's parity tests' for each kind: dense 1e-5
(``test_torch_model.py``), hybrid 2e-5 (``test_torch_recurrent.py``),
RWKV 5e-4 (``test_torch_rwkv.py``).  Gradients: rtol 1e-4 and an atol of
a tenth of the kind's forward tolerance, which for the dense model is
``test_torch_model.py``'s 1e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402
from repro_torch.optim import apply_updates, sgd  # noqa: E402

# (arch, layers or None for the reduced config's own depth)
CASES = [("tinyllama-1.1b", 2), ("tinyllama-1.1b", 3),
         ("recurrentgemma-9b", None), ("rwkv6-3b", None)]
IDS = ["tinyllama-2", "tinyllama-3", "recurrentgemma", "rwkv6"]
TOL = {"attn": 1e-5, "rec": 2e-5, "rwkv": 5e-4}
B, S = 2, 24


def _kind(cfg) -> str:
    return ("rec" if cfg.recurrent is not None
            else "rwkv" if cfg.block == "rwkv" else "attn")


@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return jcfg, cfg, jparams, params, toks


def _tol(cfg):
    t = TOL[_kind(cfg)]
    return dict(rtol=t, atol=t)


def _same_caches(got, want, **tol):
    want = jax.tree.leaves(want)
    got = T.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_leaf_order_matches_reference(arch, n_layers):
    """Paths, shapes and dtypes in leaf order equal the reference's, for
    bridged weights and for the port's own ``init_params``."""
    jcfg, cfg, jparams, params, _ = _setup(arch, n_layers)
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in T.leaves_with_paths(params)]
    assert got == want
    own = M.init_params(cfg, seed=0, device="cpu")
    assert [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in T.leaves_with_paths(own)] == want


def test_full_tinyllama_has_201_leaves_in_reference_order():
    """Full width on meta tensors against ``jax.eval_shape`` of the
    reference's ``init_params``: 201 leaves, ``embed``, ``final_norm``,
    each layer's nine, then ``lm_head``."""
    jcfg, cfg = jax_config("tinyllama-1.1b"), get_config("tinyllama-1.1b")
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with torch.device("meta"):
        params = M.init_params(cfg, device="meta")
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in T.leaves_with_paths(params)]
    assert len(got) == 201
    assert got == want
    assert [p for p, _, _ in got[:2]] == ["['embed']",
                                          "['final_norm']['scale']"]
    assert got[-1][0] == "['lm_head']"


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_forward_and_loss_match_reference(arch, n_layers):
    jcfg, cfg, jparams, params, toks = _setup(arch, n_layers)
    (jlogits, jaux), jloss = jax.jit(lambda p, t: (
        JM.forward(p, jcfg, t), JM.loss_fn(p, jcfg, {"tokens": t})))(
            jparams, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        logits, aux = M.forward(params, cfg, torch.from_numpy(toks))
        loss = M.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **_tol(cfg))
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=TOL[_kind(cfg)])


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, n_layers):
    jcfg, _, jparams, _, toks = _setup(arch, n_layers)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    return jax.jit(jax.grad(lambda p: JM.loss_fn(p, jcfg, batch)))(jparams)


# remat checkpoints each layer whatever its kind: one case takes it
@pytest.mark.parametrize("arch,n_layers,remat",
                         [c + (False,) for c in CASES]
                         + [("tinyllama-1.1b", 2, True)],
                         ids=IDS + ["tinyllama-2-remat"])
def test_grads_match_reference(arch, n_layers, remat):
    _, cfg, _, params, toks = _setup(arch, n_layers)
    leaves = [p.clone().requires_grad_(True) for p in T.leaves(params)]
    tree = T.unflatten(params, leaves)
    loss = M.loss_fn(tree, cfg, {"tokens": torch.from_numpy(toks)},
                     remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(_jax_grads(arch, n_layers))
    assert len(grads) == len(want)
    atol = TOL[_kind(cfg)] / 10
    for (path, _), g, w in zip(T.leaves_with_paths(params), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=atol, err_msg=path)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, n_layers):
    jcfg, _, jparams, _, toks = _setup(arch, n_layers)
    return jax.jit(lambda p, t: JM.prefill(p, jcfg, t, 32))(
        jparams, jnp.asarray(toks[:, :S - 3], jnp.int32))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(arch, n_layers, use_kernels):
    """Prefill of S - 3 tokens into a cache of 32, then three decode
    steps, against the reference's kernel-free path; ``use_kernels`` takes
    the kernels' plain versions on CPU tensors."""
    jcfg, cfg, jparams, params, toks = _setup(arch, n_layers)
    tol = _tol(cfg)
    P = S - 3
    jl, jc = _jax_prefill(arch, n_layers)
    with torch.no_grad():
        logits, caches = M.prefill(params, cfg,
                                   torch.from_numpy(toks[:, :P]), 32,
                                   use_kernels=use_kernels)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)
    _same_caches(caches, jc, **tol)
    step = jax.jit(lambda c, t, p: JM.decode_step(jparams, jcfg, c, t, p))
    for pos in range(P, S):
        nxt = toks[:, pos]
        jl, jc = step(jc, jnp.asarray(nxt, jnp.int32), jnp.int32(pos))
        with torch.no_grad():
            logits, caches = M.decode_step(params, cfg, caches,
                                           torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)
        _same_caches(caches, jc, **tol)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "rwkv6-3b"])
def test_stacked_matches_per_layer(arch):
    """The stacked model equals the per-layer loop on the same weights
    (twin of the reference's ``test_stacked_matches_unstacked``), and the
    per-layer ``init_params`` draws the stacked model's weights."""
    cfg = get_config(arch).reduced()
    sp = ST.init_params(cfg, seed=0, device="cpu")
    up = M.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        T.leaves(M.from_stacked(sp, cfg)), T.leaves(up)))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    with torch.no_grad():
        l1 = ST.forward(sp, cfg, toks)
        l2, _ = M.forward(up, cfg, toks)
        loss1 = ST.loss_fn(sp, cfg, {"tokens": toks})
        loss2 = M.loss_fn(up, cfg, {"tokens": toks})
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)


def test_blocks_of_a6_raise():
    """The blocks of ROADMAP A6 are ported and raise nothing: an MLA
    block with routed experts builds; a prefix given to a model without
    one is ignored, as the reference ignores it; the per-layer model of
    the VLM prefix decoder and of the encoder-decoder takes their stub
    inputs (their parity is in tests/test_torch_vlm.py and
    tests/test_torch_encdec.py)."""
    own = M.init_params(get_config("deepseek-v2-lite-16b").reduced(),
                        device="cpu")
    assert "moe" in own["layers"][1] and "w_dkv" in own["layers"][0]["attn"]
    _, cfg, _, params, toks = _setup("tinyllama-1.1b", 2)
    plain = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        want = M.loss_fn(params, cfg, plain)
        got = M.loss_fn(params, cfg, dict(plain, prefix_emb=torch.zeros(
            (B, 4, cfg.d_model))))
    assert torch.equal(got, want)
    from repro_torch.data.pipeline import materialize_batch
    for arch in ("paligemma-3b", "seamless-m4t-medium"):
        c = get_config(arch).reduced()
        batch = materialize_batch(c, 2, 8, device="cpu")
        with torch.no_grad():
            loss = M.loss_fn(M.init_params(c, device="cpu"), c, batch)
        assert torch.isfinite(loss)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    """Three steps of SGD, with and without momentum, on f32 leaves, a
    constant lr and a schedule."""
    rng = np.random.default_rng(7)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    for lr in (0.1, lambda step: 0.1 / (1 + step)):
        jinit, jupdate = JO.sgd(lr, momentum=momentum)
        jp = [jnp.asarray(p) for p in p0]
        jstate = jinit(jp)
        init, update = sgd(lr, momentum=momentum)
        tp = [torch.from_numpy(p.copy()) for p in p0]
        state = init(tp)
        for g in grads:
            ju, jstate = jupdate([jnp.asarray(x) for x in g], jstate, jp)
            jp = JO.apply_updates(jp, ju)
            u, state = update([torch.from_numpy(x) for x in g], state, tp)
            apply_updates(tp, u)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert int(state.count) == int(jstate.count) == 3


def test_quickstart_example_runs():
    """``python -m repro_torch.examples.quickstart --device cpu`` at two
    layers: finite falling losses, a per-layer graph with one gradient per
    leaf, and a search no worse than the unfused start."""
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu", "--layers", "2"])
    losses = out["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert len(out["graph"].grad_prim) == 21
    assert out["best_cost"] <= out["baselines"]["JAX_no_fusion"]
