"""Tensor parallelism over a ``model`` process group, Megatron style: the
part GSPMD plays in the reference's ``layout="tp"`` step.

:class:`ModelGroup` holds the group and this rank's index in it;
:class:`TPContext` adds the spec of every leaf of a model's stacked
parameter tree by the reference's rules
(:mod:`repro_torch.distributed.sharding`), for every block the port has:
attention, the FFN, MLA, the routed experts (sharded by expert: expert
parallelism), the RG-LRU block and RWKV-6's time and channel mix.
:func:`shard_params` takes a full tree to this rank's local slices and
:func:`gather_params` takes them back.

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
    """The port computes each attention, WKV or MLA head whole on one rank:
    a block whose head projections the rules shard over ``size`` ranks
    needs ``n_heads % size == 0`` (grouped-query attention has its own
    path for heads that do not divide, as the reference's rules do)."""
    per_head = cfg.block in ("rwkv", "mla")
    if per_head and size > 1 and (cfg.n_heads * cfg.hd) % size == 0 \
            and cfg.n_heads % size:
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
    ``b{j}`` positions)."""

    def __init__(self, cfg: ModelConfig, group=None):
        from ..models import stacked as ST

        super().__init__(group)
        check_heads(cfg, self.size)
        with torch.device("meta"):
            full = ST.init_params(cfg, device="meta")
        self.specs = SH.param_specs(full, {"model": self.size}, cfg=cfg)
        self.dims = [SH.spec_dim(s) for s in self.specs]
        self._by_names = {}
        by_group: dict = {}
        for (path, _), d in zip(T.leaves_with_paths(full), self.dims):
            names = SH.path_names(path)
            # a layer's view of a stacked leaf drops the layer dim
            d_layer = None if d is None else d - 1
            if names[0] == "groups":
                by_group.setdefault(int(names[1]), {})[tuple(names[2:])] = \
                    d_layer
            elif names[:2] == ["encoder", "layers"]:
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
                self._layers += [_LayerView(self, p) for p in per_pos]

    def dim(self, *names: str) -> Optional[int]:
        """The model-sharded dim of a top-level leaf (``dim("embed")``) or
        of an encoder layer's (``dim("encoder", "attn", "wq")``), or
        None."""
        return self._by_names[names]

    def layer(self, li: int) -> "_LayerView":
        """Decoder layer ``li``'s view of the context: the same group and
        collectives, and ``dim("attn", "wq")`` of that layer's leaves."""
        return self._layers[li]


class _LayerView:
    """One decoder layer's view of a :class:`TPContext`: ``dim`` reads the
    layer's own leaves; everything else is the context's."""

    def __init__(self, tp: TPContext, dims: dict):
        self._tp, self._dims = tp, dims

    def dim(self, *names: str) -> Optional[int]:
        return self._dims[names]

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
    concatenated in rank order."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_params(params, tp: TPContext):
    """This rank's slices of a full parameter tree (fresh tensors)."""
    return T.unflatten(params, [
        p if d is None else tp.local(p, d).clone()
        for p, d in zip(T.leaves(params), tp.dims)])


@torch.no_grad()
def gather_params(params, tp: TPContext):
    """The full tree of which ``params`` holds this rank's slices; every
    rank of the group gets it.  Replicated leaves are returned as they
    are."""
    return T.unflatten(params, [
        p if d is None else tp.all_gather(p.detach(), d)
        for p, d in zip(T.leaves(params), tp.dims)])
