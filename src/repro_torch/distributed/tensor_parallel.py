"""Tensor parallelism over a ``model`` process group, Megatron style: the
part GSPMD plays in the reference's ``layout="tp"`` step.

:class:`ModelGroup` holds the group and this rank's index in it;
:class:`TPContext` adds the spec of every leaf of a model's stacked
parameter tree by the reference's rules
(:mod:`repro_torch.distributed.sharding`), for every block the port has:
attention, the FFN, MLA, the routed experts (sharded by expert: expert
parallelism), the RG-LRU block and RWKV-6's time and channel mix.
:func:`shard_params` takes a full tree to this rank's local slices and
:func:`gather_params` takes them back; :func:`shard_caches` and
:func:`gather_caches` do the same for a model's decode caches, by the
rules' ``cache_specs`` on the model group.

The model code computes on local slices and calls the group's conjugate
collectives, each an autograd function:

* ``copy`` -- identity forward, all-reduce of the gradient backward: the
  input of a column-parallel projection, whose local output heads (or FFN
  columns) each see only part of the input's gradient;
* ``reduce`` -- all-reduce forward, identity backward: the partial sums of
  a row-parallel projection;
* ``gather`` -- all-gather along a dim forward, this rank's slice of the
  gradient backward: the output columns of a projection sharded on its
  output dim.

Placed so, every activation that all ranks of the group hold whole (the
residual stream, the loss) has the whole gradient on every rank, and every
replicated leaf's gradient comes out complete and equal on every rank:
a replicated leaf of which a rank uses only a slice (a bias of local
heads, the shared KV heads of unaligned attention, the RWKV decay, MLA's
latent) is passed through ``copy`` before it is sliced, and a value that
every rank computes whole from replicated leaves reaches a sharded
projection through ``copy`` on that path alone (the MoE router's combine
weights: its load-balance loss is whole on every rank already).
Explicit collectives stand where DTensor's
propagation would not: the model's functional layers mix plain tensors
(rope tables, masks, positions) into every op.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import tree as T
from ..models.config import ModelConfig
from . import sharding as SH

def check_heads(cfg: ModelConfig, size: int) -> None:
    """The port computes each MLA head whole on one rank: an MLA block
    whose head projections the rules shard over ``size`` ranks needs
    ``n_heads % size == 0``, which every config meets at the production
    mesh's model degree 16.  Grouped-query attention has its own path for
    heads that do not divide, as the reference's rules do, and RWKV-6
    computes the heads its columns cover (``rwkv_time_mix``)."""
    if cfg.block == "mla" and size > 1 \
            and (cfg.n_heads * cfg.hd) % size == 0 and cfg.n_heads % size:
        raise NotImplementedError(
            f"tensor parallelism for {cfg.name}: {cfg.n_heads} "
            f"{cfg.block.upper()} heads do not split over {size} model "
            f"ranks, and the port computes each head on one rank")


class ModelGroup:
    """A ``model`` process group (default: the world), this rank's index in
    it, and the conjugate collectives over it.  ``calls`` counts the
    collectives it runs."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.calls = {"all_reduce": 0, "all_gather": 0}

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(t, op=op, group=self.group)
        self.calls["all_reduce"] += 1

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        out = gather_leaf(t, dim, self.group)
        self.calls["all_gather"] += 1
        return out

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromModel.apply(x, self, dim % x.dim())

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the group, with no gradient."""
        out = x.detach().clone()
        self.all_reduce(out, dist.ReduceOp.MAX)
        return out


class TPContext(ModelGroup):
    """A :class:`ModelGroup` with the spec of each leaf of ``cfg``'s
    stacked parameter tree on a ``model`` dim of the group's size.
    :meth:`layer` gives decoder layer ``li``'s view, which finds the specs
    of that layer's own group (a DeepSeek-V2 model's dense first layers
    and its MoE layers, a hybrid's ``cycle`` and ``tail`` and each one's
    ``b{j}`` positions).

    With ``data``, the data group, the context is ZeRO-3's (mode
    ``"fsdp_tp"``): the specs are the rules' ``fsdp=True`` specs on
    ``mesh_shape`` (the model slice, then the largest free dim over the
    data ranks; routed experts over the data ranks, each expert's FFN
    dim over ``model``), ``ddims`` holds each leaf's data-sharded dim, and
    :meth:`unshard` all-gathers a subtree's data shards where it is used,
    the gather's backward reduce-scattering the gradient and taking its
    mean over the data ranks.  ``data_calls`` counts the data group's
    collectives.  ``cache_dims`` holds each leaf's model-sharded dim of
    the stacked decode caches by the rules' ``cache_specs`` on the model
    group (the rows are the caller's)."""

    def __init__(self, cfg: ModelConfig, group=None, *, data=None,
                 mesh_shape=None):
        from ..models import model as M
        from ..models import stacked as ST

        super().__init__(group)
        check_heads(cfg, self.size)
        self.fsdp = data is not None
        self.data = data
        if self.fsdp:
            self.data_rank = dist.get_rank(data)
            self.data_size = dist.get_world_size(data)
            self.data_calls = {"all_gather": 0, "reduce_scatter": 0,
                               "all_reduce": 0}
        with torch.device("meta"):
            full = ST.init_params(cfg, device="meta")
        # a cache's specs on the model group alone: its rows are the
        # caller's, as a batch's are
        model_only = {"model": self.size}
        self.cache_dims = [SH.spec_dim(s) for s in SH.cache_specs(
            ST.init_cache(cfg, 1, 1, device="meta"), model_only)]
        cache_layers = [
            {tuple(SH.path_names(path)): SH.spec_dim(sp)
             for (path, _), sp in zip(T.leaves_with_paths(c),
                                      SH.cache_specs(c, model_only,
                                                     stacked=False))}
            for c in M.init_cache(cfg, 1, 1, device="meta")]
        shape = dict(mesh_shape) if self.fsdp else {"model": self.size}
        self.specs = SH.param_specs(full, shape, fsdp=self.fsdp, cfg=cfg)
        self.dims = [SH.spec_dim(s) for s in self.specs]
        self.ddims = [SH.spec_dim(s, "data") for s in self.specs]
        self._by_names, self._dd_top = {}, {}
        by_group: dict = {}
        for (path, _), d, dd in zip(T.leaves_with_paths(full), self.dims,
                                    self.ddims):
            names = SH.path_names(path)
            # a layer's view of a stacked leaf drops the layer dim
            d_layer, dd_layer = (None if e is None else e - 1
                                 for e in (d, dd))
            if names[0] == "groups":
                by_group.setdefault(int(names[1]), {})[tuple(names[2:])] = \
                    (d_layer, dd_layer)
                continue
            self._dd_top[tuple(names)] = dd
            if names[:2] == ["encoder", "layers"]:
                self._by_names[("encoder", *names[2:])] = d_layer
            else:
                self._by_names[tuple(names)] = d
        self._layers = []
        for gi, g in enumerate(ST.layer_groups(cfg)):
            dims = by_group[gi]
            if g["kind"] == "plain":
                per_pos = [dims]
            else:
                per_pos = [{n[1:]: d for n, d in dims.items()
                            if n[0] == f"b{j}"} for j in range(g["cycle"])]
            for _ in range(g["count"]):
                self._layers += [
                    _LayerView(self, {n: d for n, (d, _) in p.items()},
                               {n: dd for n, (_, dd) in p.items()},
                               cache_layers[len(self._layers) + j])
                    for j, p in enumerate(per_pos)]

    def dim(self, *names: str) -> Optional[int]:
        """The model-sharded dim of a top-level leaf (``dim("embed")``) or
        of an encoder layer's (``dim("encoder", "attn", "wq")``), or
        None."""
        return self._by_names[names]

    def layer(self, li: int) -> "_LayerView":
        """Decoder layer ``li``'s view of the context: the same group and
        collectives, and ``dim("attn", "wq")`` of that layer's leaves."""
        return self._layers[li]

    def data_local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` over the data group."""
        n = t.shape[dim] // self.data_size
        return t.narrow(dim, self.data_rank * n, n)

    def unshard(self, tree, ddims: Optional[dict] = None):
        """``tree`` (the top-level leaves but ``groups`` by default, or a
        layer's subtree with its view's ``ddims``) with every data-sharded
        leaf all-gathered over the data group; ``groups`` is passed
        through.  Without ZeRO-3, ``tree`` itself."""
        if not self.fsdp:
            return tree
        ddims = self._dd_top if ddims is None else ddims
        out = []
        for path, leaf in T.leaves_with_paths(tree):
            names = tuple(SH.path_names(path))
            dd = None if names[0] == "groups" else ddims[names]
            out.append(leaf if dd is None
                       else _GatherFromData.apply(leaf, self, dd))
        return T.unflatten(tree, out)

    def data_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        out = gather_leaf(t, dim, self.data)
        self.data_calls["all_gather"] += 1
        return out

    def data_all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.data)
        self.data_calls["all_reduce"] += 1

    def data_mean_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the mean of ``g`` over the
        data group, summed in f32 as the bucketed sync sums, in ``g``'s
        dtype."""
        gf = g.float().movedim(dim, 0).contiguous()
        out = gf.new_empty((gf.shape[0] // self.data_size, *gf.shape[1:]))
        dist.reduce_scatter_tensor(out, gf, group=self.data)
        self.data_calls["reduce_scatter"] += 1
        return out.div_(self.data_size).movedim(0, dim).contiguous().to(
            g.dtype)


class _LayerView:
    """One decoder layer's view of a :class:`TPContext`: ``dim`` reads the
    layer's own leaves, ``cache_dim`` its cache's and :meth:`unshard`
    gathers its leaves; everything else is the context's."""

    def __init__(self, tp: TPContext, dims: dict, ddims: dict, cdims: dict):
        self._tp, self._dims, self._ddims = tp, dims, ddims
        self._cdims = cdims

    def dim(self, *names: str) -> Optional[int]:
        return self._dims[names]

    def cache_dim(self, *names: str) -> Optional[int]:
        """The model-sharded dim of the layer's cache leaf ``names``
        (``cache_dim("k")``, ``cache_dim("tmix", "prev")``; batch first,
        no layer dim), or None."""
        return self._cdims[names]

    def unshard(self, tree):
        return self._tp.unshard(tree, self._ddims)

    def __getattr__(self, name):
        return getattr(self._tp, name)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.tp.all_reduce(g)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.contiguous().clone()
        tp.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.data_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.data_mean_scatter(g, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.local(g, ctx.dim).contiguous(), None, None


def gather_leaf(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The slices of ``t`` along ``dim`` held by the ranks of ``group``,
    concatenated in rank order (one ``all_gather_into_tensor``)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def shard_params(params, tp: TPContext):
    """This rank's slices of a full parameter tree (fresh tensors): the
    model slice, then under ZeRO-3 the data slice of that."""
    out = []
    for p, d, dd in zip(T.leaves(params), tp.dims, tp.ddims):
        if d is not None:
            p = tp.local(p, d)
        if dd is not None:
            p = tp.data_local(p, dd)
        out.append(p if d is None and dd is None else p.clone())
    return T.unflatten(params, out)


def shard_caches(caches, tp: TPContext):
    """This rank's shards (fresh tensors) of whole stacked decode caches
    (``stacked.init_cache``'s layout) over the model group, by the rules'
    ``cache_specs``; the rows stay the caller's."""
    return T.unflatten(caches, [
        c if d is None else tp.local(c, d).clone()
        for c, d in zip(T.leaves(caches), tp.cache_dims)])


@torch.no_grad()
def gather_caches(caches, tp: TPContext):
    """The whole stacked caches of which ``caches`` holds this rank's
    shards, as fresh tensors (a decode step writes the shards in place);
    every rank of the model group gets them."""
    return T.unflatten(caches, [
        c.clone() if d is None else tp.all_gather(c, d)
        for c, d in zip(T.leaves(caches), tp.cache_dims)])


@torch.no_grad()
def gather_params(params, tp: TPContext):
    """The full tree of which ``params`` holds this rank's slices; every
    rank of the mesh gets it.  Replicated leaves are returned as they
    are."""
    out = []
    for p, d, dd in zip(T.leaves(params), tp.dims, tp.ddims):
        p = p.detach()
        if dd is not None:
            p = tp.data_all_gather(p, dd)
        out.append(p if d is None else tp.all_gather(p, d))
    return T.unflatten(params, out)
