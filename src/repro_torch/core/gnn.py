"""GNN-based Fused-Op Estimator (paper Sec. 4.3), in PyTorch (port of
``repro/core/gnn.py``).

Encoder: multi-head graph attention layers (eq. (1)) over the fused op's
internal subgraph — node features are (op-category one-hot, log FLOPs,
log in/out bytes, log standalone time) plus, on gradient-producing nodes,
the comm dimensions of the bucket the gradient lands in (collective
algorithm, comm kind, chunk count — the searched communication state).  A
sum-pool layer produces the fused-op embedding (eq. (2)), followed by an FC
regression head.  Loss is squared error in log-time (eq. (3)); training
uses the port's AdamW (:mod:`repro_torch.optim`).

The features are the reference's, bit for bit (numpy).  The model is an
``nn.Module`` whose parameters, in :meth:`GNN.tree_leaves` order, are the
reference's parameter tree flattened; :func:`params_from_reference` carries
a reference tree across.  Samples are padded to ``max_nodes`` so a batch
is one tensor.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..cluster import BUCKET_COMM_KINDS, COLLECTIVE_ALGOS
from ..device import resolve_device
from ..optim import adamw, apply_updates
from .graph import DOT, EW, FusionGraph, LAYOUT, OPAQUE, REDUCE

CATEGORIES = (EW, REDUCE, DOT, LAYOUT, OPAQUE)
# per-node features: op-category one-hot, log flops/in_b/out_b/time, and —
# for gradient-producing prims — the comm dimensions of the bucket the
# gradient lands in (collective algorithm, comm kind, chunk count), so the
# estimator is not blind to the searched communication state
N_COMM_FEATURES = 3
N_FEATURES = len(CATEGORIES) + 4 + N_COMM_FEATURES


def _param_bucket_index(g: FusionGraph) -> dict[int, int]:
    """grad-param leaf index -> bucket index (buckets partition the params)."""
    out: dict[int, int] = {}
    for bi, bucket in enumerate(g.buckets):
        for param in bucket:
            out[param] = bi
    return out


# ------------------------------------------------------------------ features
def group_features(g: FusionGraph, gid: int, max_nodes: int,
                   param_bucket: dict[int, int] | None = None):
    """(feat [N,F], adj [N,N], mask [N]) for the members of one fused
    group.  ``param_bucket`` (grad-param -> bucket index) may be passed by
    callers that already hold the map (the estimator caches it); otherwise
    it is built lazily on the first gradient-producing member."""
    members = sorted(g.groups[gid])
    n = min(len(members), max_nodes)
    members = members[:n]
    index = {pid: i for i, pid in enumerate(members)}
    feat = np.zeros((max_nodes, N_FEATURES), np.float32)
    adj = np.zeros((max_nodes, max_nodes), np.float32)
    mask = np.zeros((max_nodes,), np.float32)
    base = len(CATEGORIES)
    for i, pid in enumerate(members):
        p = g.prims[pid]
        feat[i, CATEGORIES.index(p.category)] = 1.0
        feat[i, base + 0] = np.log1p(p.flops) / 30.0
        feat[i, base + 1] = np.log1p(p.in_bytes) / 30.0
        feat[i, base + 2] = np.log1p(p.out_bytes) / 30.0
        feat[i, base + 3] = np.log1p(p.time * 1e9) / 30.0
        if p.grad_param >= 0:
            if param_bucket is None:
                param_bucket = _param_bucket_index(g)
            bi = param_bucket.get(p.grad_param)
            if bi is not None:
                feat[i, base + 4] = (
                    (COLLECTIVE_ALGOS.index(g.bucket_algos[bi]) + 1.0)
                    / len(COLLECTIVE_ALGOS))
                feat[i, base + 5] = (
                    (BUCKET_COMM_KINDS.index(g.bucket_comm[bi]) + 1.0)
                    / len(BUCKET_COMM_KINDS))
                feat[i, base + 6] = np.log2(g.bucket_chunks[bi]) / 4.0
        mask[i] = 1.0
        adj[i, i] = 1.0
        for q in g.ppreds[pid]:
            j = index.get(q)
            if j is not None:
                adj[j, i] = 1.0
                adj[i, j] = 1.0  # undirected message passing + self loops
    return feat, adj, mask


# -------------------------------------------------------------------- model
@dataclasses.dataclass(frozen=True)
class GNNConfig:
    n_layers: int = 3          # paper uses 6 graph-conv layers
    n_heads: int = 4
    head_dim: int = 16
    mlp_dim: int = 64
    n_mlp: int = 3             # paper: 3 dense layers
    max_nodes: int = 48


class _GATLayer(nn.Module):
    def __init__(self, w, a_src, a_dst):
        super().__init__()
        self.w = nn.Parameter(w)            # [K, F_in, D]
        self.a_src = nn.Parameter(a_src)    # [K, D]
        self.a_dst = nn.Parameter(a_dst)


class _Dense(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class GNN(nn.Module):
    """The estimator's network.  ``forward`` maps a padded batch
    (feat [B,N,F], adj [B,N,N], mask [B,N]) to predicted log-times [B]."""

    def __init__(self, cfg: GNNConfig, leaves: Sequence[torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        it = iter(leaves)
        self.layers = nn.ModuleList(
            _GATLayer(next(it), next(it), next(it))
            for _ in range(cfg.n_layers))
        self.pool_w = nn.Parameter(next(it))
        self.mlp = nn.ModuleList(_Dense(next(it), next(it))
                                 for _ in range(cfg.n_mlp))

    def tree_leaves(self) -> list:
        """Parameters in the reference tree's order: each layer's ``w``,
        ``a_src``, ``a_dst``; ``pool_w``; each dense layer's ``w``, ``b``."""
        out = []
        for layer in self.layers:
            out += [layer.w, layer.a_src, layer.a_dst]
        out.append(self.pool_w)
        for layer in self.mlp:
            out += [layer.w, layer.b]
        return out

    def forward(self, feat, adj, mask):
        neg = torch.finfo(torch.float32).min
        b, n = feat.shape[:2]
        # masked logits take the f32 minimum, not -inf, so a padded row's
        # softmax stays finite before it is zeroed
        edge = (adj * mask[:, None, :] * mask[:, :, None] > 0)[:, None]
        e = feat
        for layer in self.layers:
            h = torch.einsum("bnf,kfd->bknd", e, layer.w)          # [B,K,N,D]
            s_src = torch.einsum("bknd,kd->bkn", h, layer.a_src)
            s_dst = torch.einsum("bknd,kd->bkn", h, layer.a_dst)
            logits = F.leaky_relu(s_src[..., :, None] + s_dst[..., None, :],
                                  0.2)                              # [B,K,N,N]
            logits = torch.where(edge, logits, neg)
            gamma = torch.where(edge, torch.softmax(logits, dim=-1), 0.0)
            out = torch.einsum("bknm,bkmd->bknd", gamma, h)         # aggregate
            # heads concatenate as [K,N,D] -> [N,K,D] -> [N, K*D]
            e = F.elu(out).transpose(1, 2).reshape(b, n, -1)
            e = e * mask[..., None]
        x = F.elu(torch.einsum("bnf,fd->bd", e * mask[..., None],
                               self.pool_w))                        # eq. (2)
        for i, layer in enumerate(self.mlp):
            x = x @ layer.w + layer.b
            if i < len(self.mlp) - 1:
                x = F.relu(x)
        return x[:, 0]


def init_params(cfg: GNNConfig, seed: int = 0, device="cuda") -> GNN:
    """A GNN with the reference's initial distributions (scaled normals,
    zero biases), drawn from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    leaves = []
    f_in = N_FEATURES
    for _ in range(cfg.n_layers):
        leaves += [normal(cfg.n_heads, f_in, cfg.head_dim,
                          scale=1.0 / np.sqrt(f_in)),
                   normal(cfg.n_heads, cfg.head_dim, scale=0.1),
                   normal(cfg.n_heads, cfg.head_dim, scale=0.1)]
        f_in = cfg.n_heads * cfg.head_dim
    leaves.append(normal(f_in, cfg.mlp_dim, scale=1.0 / np.sqrt(f_in)))
    d = cfg.mlp_dim
    for i in range(cfg.n_mlp):
        d_out = 1 if i == cfg.n_mlp - 1 else cfg.mlp_dim
        leaves += [normal(d, d_out, scale=1.0 / np.sqrt(d)),
                   torch.zeros(d_out)]
        d = d_out
    return GNN(cfg, leaves).to(resolve_device(device))


def params_from_reference(tree: dict, cfg: GNNConfig, device="cuda") -> GNN:
    """The reference's ``init_params`` / ``train`` tree (leaves as numpy
    arrays or anything ``np.asarray`` takes) as the port's module."""
    leaves = []
    for layer in tree["layers"]:
        leaves += [layer["w"], layer["a_src"], layer["a_dst"]]
    leaves.append(tree["pool_w"])
    for layer in tree["mlp"]:
        leaves += [layer["w"], layer["b"]]
    leaves = [torch.from_numpy(np.array(x, np.float32)) for x in leaves]
    return GNN(cfg, leaves).to(resolve_device(device))


def _batch(samples, device):
    """Stacked (feat, adj, mask) tensors and f32 log-times on ``device``."""
    feat, adj, mask = (torch.from_numpy(np.stack([s[k] for s in samples]))
                       .to(device) for k in range(3))
    log_t = torch.from_numpy(np.array(
        [np.log(max(s[3], 1e-9)) for s in samples], np.float32)).to(device)
    return feat, adj, mask, log_t


def forward_batch(model: GNN, feat, adj, mask):
    """Predicted log-times for a padded batch (the reference vmaps its
    one-graph ``forward``; the module is batched)."""
    return model(feat, adj, mask)


def loss_fn(model: GNN, feat, adj, mask, log_t):
    pred = forward_batch(model, feat, adj, mask)
    return torch.mean(torch.square(pred - log_t))  # eq. (3), log-space MSE


def train(
    samples: Sequence[tuple],  # (feat, adj, mask, time_seconds)
    cfg: GNNConfig = GNNConfig(),
    *,
    epochs: int = 60,
    batch_size: int = 32,
    lr: float = 3e-3,
    seed: int = 0,
    device="cuda",
    model: GNN | None = None,
    verbose: bool = False,
) -> tuple[GNN, list[float]]:
    """Train from ``model`` (default: :func:`init_params` at ``seed``).
    Batches follow the reference: a ``default_rng(seed)`` permutation each
    epoch, the last partial batch dropped.  Returns (model, per-epoch mean
    losses)."""
    dev = resolve_device(device)
    model = (init_params(cfg, seed, dev) if model is None
             else model.to(dev))
    leaves = model.tree_leaves()
    init, update = adamw(lr)
    opt_state = init(leaves)
    feat, adj, mask, log_t = _batch(samples, dev)
    n = len(samples)
    rng = np.random.default_rng(seed)
    losses = []
    for ep in range(epochs):
        order = rng.permutation(n)
        ep_loss = 0.0
        nb = 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i: i + batch_size]).to(dev)
            loss = loss_fn(model, feat[idx], adj[idx], mask[idx],
                           log_t[idx])
            grads = torch.autograd.grad(loss, leaves)
            updates, opt_state = update(list(grads), opt_state, leaves)
            apply_updates(leaves, updates)
            ep_loss += float(loss.detach())
            nb += 1
        losses.append(ep_loss / max(nb, 1))
        if verbose and ep % 10 == 0:
            print(f"  gnn epoch {ep}: loss {losses[-1]:.4f}")
    return model, losses


@torch.no_grad()
def predict_times(model: GNN, samples) -> np.ndarray:
    dev = model.pool_w.device
    feat, adj, mask, _ = _batch(samples, dev)
    return np.exp(forward_batch(model, feat, adj, mask).cpu().numpy())


# ----------------------------------------------------------------- estimator
class GNNEstimator:
    """Drop-in for :class:`repro_torch.core.costs.OracleEstimator`, backed
    by the trained GNN for multi-op groups; singleton groups use profiled
    times.

    ``comm_sensitive`` tells the simulator's delta path that predictions
    depend on the searched comm dimensions (bucket algo / comm kind /
    chunks): cached per-group times from an ancestor schedule are stale
    across bucket-dimension mutations, so those journals must fall back to
    a full replay (the comm-blind oracle keeps the fast delta path).

    Each query is a batch-1 forward on ``device`` that waits for its
    result; ``queries`` and ``query_seconds`` (host clock) count them."""

    comm_sensitive = True

    def __init__(self, model: GNN, cfg: GNNConfig, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self._cache: dict = {}
        self._bucket_maps: dict = {}
        self.queries = 0
        self.query_seconds = 0.0

    def fingerprint(self) -> str:
        """Digest of the config and weights: the plan cache keys a
        GNN-priced compile on it, so two differently trained estimators
        never share a cache entry."""
        h = hashlib.sha256(json.dumps(dataclasses.asdict(self.cfg),
                                      sort_keys=True).encode())
        for p in self.model.tree_leaves():
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:20]

    def _param_bucket(self, g: FusionGraph) -> dict[int, int]:
        # content-keyed so clones sharing a bucket partition share the map
        key = tuple(g.buckets)
        m = self._bucket_maps.get(key)
        if m is None:
            # bucket mutations mint a new partition per candidate: bound
            # the cache so a long search cannot accumulate O(n_params)
            # dicts without end
            if len(self._bucket_maps) >= 256:
                self._bucket_maps.clear()
            m = _param_bucket_index(g)
            self._bucket_maps[key] = m
        return m

    @torch.no_grad()
    def _predict(self, feat, adj, mask) -> float:
        t0 = time.perf_counter()
        x = [torch.from_numpy(a[None]).to(self.device)
             for a in (feat, adj, mask)]
        out = forward_batch(self.model, *x)[0].cpu().numpy()
        self.queries += 1
        self.query_seconds += time.perf_counter() - t0
        return float(np.exp(out))

    def group_time(self, g: FusionGraph, gid: int) -> float:
        members = g.groups[gid]
        if len(members) == 1:
            (pid,) = members
            return g.prims[pid].time
        # the feature vector carries the comm dimensions of any member
        # gradient's bucket, so the cache must key on them too or a comm
        # mutation would replay a stale prediction.  Most groups produce no
        # gradients: their key is (members, ()) with no bucket scan at all.
        grad_params = [g.prims[pid].grad_param for pid in members
                       if g.prims[pid].grad_param >= 0]
        if grad_params:
            pb = self._param_bucket(g)
            comm_key = tuple(
                (g.bucket_algos[bi], g.bucket_comm[bi], g.bucket_chunks[bi])
                for bi in sorted({pb[p] for p in grad_params if p in pb})
            )
        else:
            comm_key = ()
        key = (members, comm_key)
        t = self._cache.get(key)
        if t is None:
            feat, adj, mask = group_features(
                g, gid, self.cfg.max_nodes,
                param_bucket=self._param_bucket(g) if grad_params else None)
            t = self._predict(feat, adj, mask)
            self._cache[key] = t
        return t
