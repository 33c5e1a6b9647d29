"""Parity of the port's dense model with the JAX reference: the same weights
(the reference's, bridged) and the same tokens give the same logits, loss
and gradients, and the port's leaf order is ``jax.tree.leaves`` order."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import materialize_batch as jax_batch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import stacked as JST  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import stacked as ST  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen2-0.5b", "stablelm-1.6b", "transformer-paper"]
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = JST.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = jax_batch(jcfg, B, S, seed=0)
    tokens = torch.from_numpy(np.asarray(batch["tokens"]).astype(np.int64))
    return jcfg, cfg, jparams, params, batch, {"tokens": tokens}


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_matches_jax(arch):
    """Paths, shapes and dtypes in leaf order equal the reference's, for
    bridged weights and for the port's own initialisation (f32 and bf16)."""
    jcfg, cfg, jparams, params, _, _ = _setup(arch)
    jpaths = [(jax.tree_util.keystr(p), tuple(l.shape), str(l.dtype))
              for p, l in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in T.leaves_with_paths(params)]
    assert got == jpaths
    own = ST.init_params(cfg, seed=0, device="cpu")
    assert [(p, tuple(l.shape)) for p, l in T.leaves_with_paths(own)] == \
        [(p, s) for p, s, _ in jpaths]
    if arch == "tinyllama-1.1b":
        assert len(ST.leaves(own)) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    jlogits, _ = jax.jit(lambda p, t: JST.forward(p, jcfg, t))(
        jparams, jbatch["tokens"])
    jloss = jax.jit(lambda p, b: JST.loss_fn(p, jcfg, b))(jparams, jbatch)
    with torch.no_grad():
        logits = ST.forward(params, cfg, batch["tokens"])
        loss = ST.loss_fn(params, cfg, batch)
    # rtol 1e-5 as stated; atol 1e-5 covers logits that sit near zero,
    # where f32 matmuls summed in another order differ in the last bits
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    jcfg, _, jparams, _, jbatch, _ = _setup(arch)
    return jax.jit(jax.grad(lambda p: JST.loss_fn(p, jcfg, jbatch)))(jparams)


@pytest.mark.parametrize("arch,remat", [("tinyllama-1.1b", False),
                                         ("tinyllama-1.1b", True),
                                         ("qwen2-0.5b", True),
                                         ("transformer-paper", False)])
def test_grads_match_jax_grad(arch, remat):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    jgrads = _jax_grads(arch)
    leaves = ST.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ST.loss_fn(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for (path, _), g, jg in zip(T.leaves_with_paths(params), grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_query_chunked_attention_matches_jax(causal, window):
    """The long-sequence query-chunked path (the reference's
    ``_flash_xla``) at small blocks, GQA with 2 query heads per KV head."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    ref = JL._flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal, window, qb=32, kb=32)
    got = L._flash_xla(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal, window, qb=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    dense = L._sdpa_dense(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        L._causal_bias(128, 128, causal, window, "cpu")[None, None, None])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def _peak_live_bytes(fn, *args) -> int:
    """The most bytes of intermediates alive at once in the traced graph
    of ``fn``'s forward and backward (each value lives from its node to its
    last use; a view shares its base's bytes)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def step(*xs):
        xs = [x.detach().requires_grad_(True) for x in xs]
        return torch.autograd.grad(fn(*xs).square().sum(), xs)

    nodes = list(make_fx(step, tracing_mode="fake")(*args).graph.nodes)
    pos = {n: i for i, n in enumerate(nodes)}
    root, size, last = {}, {}, {}
    for n in nodes:
        if n.op != "call_function" or not isinstance(n.meta.get("val"),
                                                     torch.Tensor):
            continue
        base = n.args[0] if getattr(n.target, "is_view", False) else None
        root[n] = root.get(base, n)
        if root[n] is n:
            size[n] = n.meta["val"].numel() * n.meta["val"].element_size()
    for n, r in root.items():
        last[r] = max([last.get(r, pos[n])] + [pos[u] for u in n.users])
    delta = [0] * (len(nodes) + 1)
    for r, b in size.items():
        delta[pos[r]] += b
        delta[last[r] + 1] -= b
    live = peak = 0
    for d in delta:
        live += d
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_query_chunked_backward_holds_one_block(causal, window):
    """The long-sequence path's forward and backward hold a few of one
    query block's (B,H,qb,T) f32 scores at a time, not the (B,H,S,T) of the
    dense path, 8 blocks here (about 4.3 blocks measured against 24.5 for
    the dense path and 22 for one checkpoint over all rows), and their
    gradients equal the dense path's."""
    rng = np.random.default_rng(1)
    B, S, H, KV, hd, qb = 1, 512, 4, 2, 16, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, hd)).astype(
        np.float32)) for h in (H, KV, KV))

    def chunked(q, k, v):
        return L._flash_xla(q, k, v, causal, window, qb=qb)

    def dense(q, k, v):
        bias = L._causal_bias(S, S, causal, window, "cpu")
        return L._sdpa_dense(q, k, v, bias[None, None, None])

    block = B * H * qb * S * 4
    assert _peak_live_bytes(chunked, q, k, v) <= 6 * block
    assert _peak_live_bytes(dense, q, k, v) > 16 * block
    grads = []
    for f in (chunked, dense):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        grads.append(torch.autograd.grad(f(*xs).square().sum(), xs))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_layer_matches_jax():
    """One tinyllama block in bf16: the port rounds at the reference's
    places.  Tolerance 2e-2, the kernel tests' bf16 tolerance: XLA and
    PyTorch sum bf16 matmuls in different orders."""
    jcfg = jax_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    from repro.models import model as JM
    from repro_torch.models import model as M
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      JM.init_layer(jax.random.PRNGKey(1), jcfg, 0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 16, 256)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout, _, _ = JM._layer_fwd(jp, jcfg, 0, jx, jnp.arange(16))
    with torch.no_grad():
        out = M._layer_fwd(p, cfg, torch.from_numpy(x).bfloat16(),
                           torch.arange(16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("relu", False), ("gelu", False)])
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_mlp_and_norm_variants_match_jax(act, glu, norm):
    """SwiGLU, GeGLU (tanh-approximate GELU, as ``jax.nn.gelu``), plain
    MLPs and both norms, f32: rtol 1e-5, and atol 1e-5 (a few f32 ulps of
    outputs of order 10, summed over 512 terms in another order)."""
    import dataclasses

    from repro.models import layers as JLy
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               act=act, glu=glu, norm=norm)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              act=act, glu=glu, norm=norm)
    rng = np.random.default_rng(5)
    jp = {"w_up": rng.standard_normal((256, 512)).astype(np.float32) / 16,
          "w_down": rng.standard_normal((512, 256)).astype(np.float32) / 23}
    if glu:
        jp["w_gate"] = rng.standard_normal((256, 512)).astype(np.float32) / 16
    jn = {"scale": rng.standard_normal(256).astype(np.float32)}
    if norm == "layer":
        jn["bias"] = rng.standard_normal(256).astype(np.float32)
    x = rng.standard_normal((2, 8, 256)).astype(np.float32)
    want = JLy.mlp_fwd(jp, jcfg, JLy.norm_fwd(jn, jcfg, jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    tn = {k: torch.from_numpy(v) for k, v in jn.items()}
    got = L.mlp_fwd(tp, cfg, L.norm_fwd(tn, cfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
