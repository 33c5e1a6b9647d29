"""The port's GNN fused-op estimator (``repro_torch.core.gnn``) against the
reference's, on the CPU: features bit for bit, the forward and three
epochs of training at carried weights, the estimator inside the simulator,
and the port's copies of ``tests/test_gnn_estimator.py``.

Graphs are traced by the JAX package and carried into the port with
``to_port``; weights are the reference's ``init_params`` carried with
``params_from_reference``.
"""
import copy
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.core as RCO  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.profile_cpu import sample_fused_groups as r_sample  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402

import repro_torch.cluster as PC  # noqa: E402
import repro_torch.core as PCO  # noqa: E402
import repro_torch.plan as PP  # noqa: E402
from repro_torch.core import gnn as PG  # noqa: E402
from repro_torch.core.profile import sample_fused_groups as p_sample  # noqa: E402
from repro_torch.optim import adamw as p_adamw, apply_updates  # noqa: E402
from repro_torch.plan import cache as PCACHE  # noqa: E402

from test_torch_search import NO_DUP, mutated, to_port  # noqa: E402
from test_trace_search import mlp_graph  # noqa: E402

SMALL = dict(n_layers=2, n_heads=2, head_dim=8, mlp_dim=32)
FIG11 = dict(n_layers=2, n_heads=4, head_dim=16, mlp_dim=64)
TINY = dict(n_layers=1, n_heads=2, head_dim=4, mlp_dim=8)


def configs(kw):
    return RG.GNNConfig(**kw), PG.GNNConfig(**kw)


def carried(kw, seed=0):
    """The reference's initial weights at ``seed`` in (reference tree,
    port module on the CPU)."""
    rcfg, pcfg = configs(kw)
    tree = RG.init_params(rcfg, jax.random.PRNGKey(seed))
    return tree, PG.params_from_reference(jax.tree.map(np.asarray, tree),
                                          pcfg, device="cpu")


def ref_leaves(tree) -> list:
    out = []
    for layer in tree["layers"]:
        out += [layer["w"], layer["a_src"], layer["a_dst"]]
    out.append(tree["pool_w"])
    for layer in tree["mlp"]:
        out += [layer["w"], layer["b"]]
    return [np.asarray(x) for x in out]


def stacked(samples):
    return [np.stack([s[k] for s in samples]) for k in range(3)]


@pytest.fixture(scope="module")
def mlp():
    g, _ = mlp_graph(layers=5, d=96, batch=16)
    return g, to_port(g)


@pytest.fixture(scope="module")
def corpus(mlp):
    """Tier A samples in (reference, port), labelled under TPU_V5E."""
    rs = r_sample(mlp[0], 400, random.Random(0), max_members=12,
                  hw=RCO.TPU_V5E)
    ps = p_sample(mlp[1], 400, random.Random(0), max_members=12,
                  hw=PCO.TPU_V5E)
    assert len(rs) > 150
    return rs, ps


@pytest.fixture(scope="module")
def tinyllama():
    from repro.plan import trace_model_graph

    g = trace_model_graph("tinyllama-1.1b", reduced=True, hw=RCO.TPU_V5E)
    return g, to_port(g)


# ----------------------------------------------------------------- features
@pytest.mark.parametrize("seed,n_mut", ((0, 0), (1, 12), (2, 24), (3, 40)))
def test_group_features_match_reference(seed, n_mut, tinyllama):
    """Every group's features, bitwise, on reduced tinyllama after seeded
    op fusion, tensor fusion and bucket algo / comm kind / chunk
    mutations."""
    rg = mutated(RCO, tinyllama[0], seed, n_mut, NO_DUP)
    pg = mutated(PCO, tinyllama[1], seed, n_mut, NO_DUP)
    assert pg.groups == rg.groups
    assert (pg.bucket_algos, pg.bucket_comm, pg.bucket_chunks) == (
        rg.bucket_algos, rg.bucket_comm, rg.bucket_chunks)
    fused = 0
    for gid in rg.groups:
        fused += len(rg.groups[gid]) > 1
        for max_nodes in (48, 4):
            want = RG.group_features(rg, gid, max_nodes)
            got = PG.group_features(pg, gid, max_nodes)
            for w, p in zip(want, got):
                assert p.dtype == w.dtype and np.array_equal(p, w)
    assert (fused > 0) == (n_mut > 0)


def test_group_features_see_comm_dimensions(mlp):
    """Port copy: the features carry (bucket algo, comm kind, chunk count)
    on gradient-producing nodes, change when the search mutates them, and
    the estimator's cache does not replay a stale prediction."""
    g = mlp[1].clone()
    grad_pid = g.grad_prim[g.buckets[0][0]]
    gid = g.provider[grad_pid]
    preds = list(g.group_preds(gid))
    assert preds and g.fuse_nondup(gid, preds[0])
    gid = g.provider[grad_pid]
    assert len(g.groups[gid]) > 1

    feat0, _, _ = PG.group_features(g, gid, 16)
    assert feat0.shape[1] == PG.N_FEATURES
    base = PG.N_FEATURES - PG.N_COMM_FEATURES
    assert feat0[:, base:].any(), "comm features all zero on a grad group"
    bi = next(i for i, b in enumerate(g.buckets) if g.buckets[0][0] in b)
    g.set_bucket_algo(bi, "hier")
    feat1, _, _ = PG.group_features(g, gid, 16)
    assert (feat0[:, base] != feat1[:, base]).any()
    g.set_bucket_chunks(bi, 4)
    feat2, _, _ = PG.group_features(g, gid, 16)
    assert (feat1[:, base + 2] != feat2[:, base + 2]).any()

    _, model = carried(TINY)
    est = PG.GNNEstimator(model, PG.GNNConfig(**TINY), device="cpu")
    t_hier = est.group_time(g, gid)
    g.set_bucket_algo(bi, "tree")
    t_tree = est.group_time(g, gid)
    assert t_hier != t_tree or len(est._cache) == 2
    assert est.queries == 2


# -------------------------------------------------------- forward, training
@pytest.mark.parametrize("kw", [SMALL, FIG11], ids=["small", "fig11"])
def test_forward_matches_reference(kw, corpus):
    tree, model = carried(kw)
    feat, adj, mask = stacked(corpus[0])
    want = np.asarray(RG.forward_batch(tree, feat, adj, mask))
    with torch.no_grad():
        got = PG.forward_batch(model, *map(torch.from_numpy,
                                           (feat, adj, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # padded rows stay finite: the masked logits are the f32 minimum
    assert np.isfinite(got).all()


def test_gradients_and_adamw_step_match_reference(corpus):
    """One batch's gradients at carried weights, then the port's AdamW
    (lr read at the count before its increment) on the GNN's tree fed the
    reference's gradients for three steps."""
    tree, model = carried(SMALL)
    feat, adj, mask = stacked(corpus[0][:32])
    log_t = np.log(np.array([s[3] for s in corpus[0][:32]], np.float32))
    grads = jax.tree.map(np.asarray, jax.grad(RG.loss_fn)(
        tree, feat, adj, mask, log_t))
    rgrads = ref_leaves(grads)
    loss = PG.loss_fn(model, *map(torch.from_numpy,
                                  (feat, adj, mask, log_t)))
    pgrads = torch.autograd.grad(loss, model.tree_leaves())
    for r, p in zip(rgrads, pgrads):
        np.testing.assert_allclose(p.numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))

    sched = lambda step: 3e-3 / (1.0 + step)  # noqa: E731
    rinit, rupdate = r_adamw(sched)
    pinit, pupdate = p_adamw(sched)
    rstate, pstate = rinit(tree), pinit(model.tree_leaves())
    rtree = tree
    for _ in range(3):
        rupd, rstate = rupdate(grads, rstate, rtree)
        rtree = jax.tree.map(lambda p, u: p + u, rtree, rupd)
        pupd, pstate = pupdate([torch.tensor(g) for g in rgrads], pstate,
                               model.tree_leaves())
        apply_updates(model.tree_leaves(), pupd)
    for r, p in zip(ref_leaves(rtree), model.tree_leaves()):
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0, atol=1e-6)
    assert int(pstate.count) == int(rstate.count) == 3


def test_train_three_epochs_matches_reference(corpus):
    """Three epochs from carried weights, batches in the reference's
    order: per-epoch losses within 1e-4 (relative), the trained models'
    log-time predictions within 1e-4, and every parameter within 1e-4
    except the second layer's attention vectors.  There a head whose edge
    logits all sit on one side of the leaky ReLU has an ``a_src``
    gradient that is rounding alone (the softmax is shift-invariant), and
    AdamW normalises that rounding into steps of size lr in either
    package; those two leaves are held to 1e-2 (12 steps of lr 3e-3 are
    3.6e-2)."""
    rs, ps = corpus
    tree, model = carried(SMALL)
    rcfg, pcfg = configs(SMALL)
    rparams, rlosses = RG.train(rs, rcfg, epochs=3, batch_size=32, seed=0)
    model, plosses = PG.train(ps, pcfg, epochs=3, batch_size=32, seed=0,
                              device="cpu", model=model)
    np.testing.assert_allclose(plosses, rlosses, rtol=1e-4)
    feat, adj, mask = stacked(rs)
    want = np.asarray(RG.forward_batch(rparams, feat, adj, mask))
    with torch.no_grad():
        got = PG.forward_batch(model, *map(torch.from_numpy,
                                           (feat, adj, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    second_attention = {4, 5}   # layers[1].a_src, layers[1].a_dst
    for i, (r, p) in enumerate(zip(ref_leaves(rparams),
                                   model.tree_leaves())):
        tol = 1e-2 if i in second_attention else 1e-4
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0, atol=tol,
                                   err_msg=f"leaf {i}")


def test_gnn_trains_and_generalizes(corpus):
    """Port copy: trained on 80% of tier A, the held-out median relative
    error is under 50%."""
    ps = corpus[1]
    n = len(ps)
    tr, te = ps[: int(n * 0.8)], ps[int(n * 0.8):]
    model, losses = PG.train(tr, PG.GNNConfig(**SMALL), epochs=40,
                             batch_size=32, lr=3e-3, seed=0, device="cpu")
    assert losses[-1] < losses[0] * 0.5, "training loss did not drop"
    pred = PG.predict_times(model, te)
    true = np.array([s[3] for s in te])
    rel_err = np.abs(pred - true) / true
    assert np.median(rel_err) < 0.5, f"median rel err {np.median(rel_err)}"


# ---------------------------------------------------------------- estimator
def test_estimator_matches_reference(tinyllama):
    """``group_time`` at carried weights on every group of a fused,
    bucket-mutated reduced tinyllama: singletons exactly, fused groups
    within 1e-5 in log-time."""
    tree, model = carried(SMALL)
    rcfg, pcfg = configs(SMALL)
    rest = RG.GNNEstimator(tree, rcfg)
    pest = PG.GNNEstimator(model, pcfg, device="cpu")
    rg = mutated(RCO, tinyllama[0], 5, 40, NO_DUP)
    pg = mutated(PCO, tinyllama[1], 5, 40, NO_DUP)
    fused = 0
    for gid in rg.groups:
        want, got = rest.group_time(rg, gid), pest.group_time(pg, gid)
        if len(rg.groups[gid]) == 1:
            assert got == want
        else:
            fused += 1
            assert abs(np.log(got) - np.log(want)) < 1e-5
    assert fused and pest.queries == fused


def test_gnn_incremental_equals_full_across_comm_mutations(mlp):
    """Port copy: the comm-sensitive estimator keeps the incremental and
    full replays bit-identical across bucket-dimension mutations."""
    _, model = carried(TINY)
    est = PG.GNNEstimator(model, PG.GNNConfig(**TINY), device="cpu")
    spec = PC.get_preset("a100_nvlink_ib")
    sim_inc = PCO.Simulator(estimator=est, cluster=spec, streams=4,
                            incremental=True)
    sim_full = PCO.Simulator(estimator=est, cluster=spec, streams=4,
                             incremental=False)
    rng = random.Random(3)
    parent = to_port(mlp_graph(layers=3, d=32, batch=4)[0])
    for step in range(30):
        child = parent.clone()
        for _ in range(rng.randint(1, 3)):
            PCO.random_apply(child, rng.choice(PCO.ALL_METHODS), 1, rng)
        ri = sim_inc.run(child)
        rf = sim_full.run(child)
        assert ri.iteration_time == rf.iteration_time, step
        if rng.random() < 0.6:
            parent = child


def test_gnn_estimator_drives_simulator(mlp, corpus):
    """Port copy: a trained estimator prices a graph; singleton groups use
    the profiled times exactly."""
    g = mlp[1]
    cfg = PG.GNNConfig(**SMALL)
    model, _ = PG.train(corpus[1], cfg, epochs=25, batch_size=32, seed=0,
                        device="cpu")
    est = PG.GNNEstimator(model, cfg, device="cpu")
    r = PCO.Simulator(estimator=est, n_devices=64).run(g)
    assert r.iteration_time > 0
    gid = next(iter(g.groups))
    assert est.group_time(g, gid) == g.prims[min(g.groups[gid])].time


def test_gnn_cache_keys_follow_weights(mlp):
    """ROADMAP C13: a GNN-priced compile keys on the estimator's config
    and weights, so two differently trained GNNs never share an entry;
    the same weights share it, and an oracle key carries no digest."""
    cfg = PG.GNNConfig(**TINY)
    a = PG.GNNEstimator(carried(TINY, 0)[1], cfg, device="cpu")
    b = PG.GNNEstimator(carried(TINY, 1)[1], cfg, device="cpu")
    a2 = PG.GNNEstimator(copy.deepcopy(a.model), cfg, device="cpu")
    spec = PC.get_preset("a100_nvlink_ib")
    knobs = PCACHE.knob_digest(alpha=1.05, beta=10, unchanged_limit=10,
                               max_steps=None, methods=None, seed=0)

    def key(est):
        return PCACHE.compile_key(
            mlp[1], PCO.Simulator(estimator=est, cluster=spec), knobs)

    assert a.fingerprint() != b.fingerprint()
    assert key(a) != key(b)
    assert key(a) == key(a2)
    oracle = PCO.Simulator(cluster=spec)
    assert "estimator_fingerprint" not in PCACHE._context_parts(oracle)
    plan = PP.compile(graph=mlp[1], cluster=spec, estimator=a,
                      unchanged_limit=5, max_steps=5)
    assert plan.estimator == "GNNEstimator"
