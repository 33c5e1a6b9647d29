"""DisCo-enacted train step over ``torch.distributed`` (port of
``repro/distributed/train_step.py``: mode ``ddp_tp`` with ``layout="dp"``
or ``layout="tp"`` on a ``("data", "model")`` mesh, each with optional
ZeRO-1 moments, and mode ``fsdp_tp``, ZeRO-3 under the tensor-parallel
layout).

Gradient synchronisation is explicit: the leaves are partitioned into the
buckets of a searched :class:`GradSyncStrategy`, and each bucket is
synchronised as one fused tensor (the paper's tensor fusion) with the
bucket's own collective kind and chunk count:

* ``ar``: the CUDA bucket-pack kernel stages the leaves, converted, into
  one f32 buffer (one launch per bucket), then one ``all_reduce`` per
  chunk, then ``/ dp``;
* ``rs_ag``: the same staging, then per chunk, pad to a multiple of dp,
  ``reduce_scatter_tensor``, ``/ dp`` on the shard,
  ``all_gather_into_tensor``;
* fused buckets: the CUDA pack kernel stages the leaves straight into the
  chunk-major, dp-padded f32 layout, each chunk is reduce-scattered,
  divided and all-gathered in place, and the CUDA unpack kernel casts the
  result back into the gradient leaves.

Every path sums in f32 and divides the sum (never the addends) by dp, so
all of them give the same numbers.  Each collective call adds one to
``COLLECTIVES[kind]`` and its payload's bytes to ``COLLECTIVE_BYTES[kind]``:
the whole buffer the collective reduces or assembles (an all-gather's
output, the others' input), the size NCCL's bus-bandwidth factors apply
to.

Under ``torch.profiler`` the step's phases are named (``step.fwd``,
``step.bwd``, ``step.sync`` and one ``sync.bucket`` per bucket inside it,
``step.clip``, ``step.update``; see :mod:`repro_torch.spans`).

Two deliberate differences from the reference:
* a failure on the fused path raises; the reference swallows every
  exception there and silently takes its plain path;
* the fused path runs whenever a bucket is marked fused, including in a
  group of one rank, where the reference skips it.  At dp=1 both compute
  the same function (a sum over one rank divided by one, then a lossless
  f32 round trip), and it lets one card run the kernels of the path.

Buckets run in order on one stream, so ``barriers`` (the reference's
optimization-barrier fences between buckets) hold by construction.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import tree as T
from ..kernels import ops as K
from ..kernels.ref import chunk_cuts
from ..models.config import ModelConfig
from ..optim import adamw, apply_updates, clip_by_global_norm
from ..optim import zero1 as zero1_opt
from ..spans import span
from . import sharding as SH
from . import tensor_parallel as TP

COLLECTIVES = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
COLLECTIVE_BYTES = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}


def reset_collectives() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0
        COLLECTIVE_BYTES[kind] = 0


# ----------------------------------------------------------------- strategy
@dataclasses.dataclass
class GradSyncStrategy:
    """Tensor-fusion strategy: a partition of parameter leaves into ordered
    buckets (leaf indices in ``jax.tree.leaves`` order, see
    :func:`repro_torch.tree.leaves`), each synchronised as one fused
    tensor.  ``comms[i]`` is bucket ``i``'s collective kind (``"ar"`` or
    ``"rs_ag"``), ``chunks[i]`` the number of even element ranges it is
    cut into, each its own collective, and ``fused[i]`` marks it for the
    pack/unpack kernel path."""
    buckets: list[list[int]]
    barriers: bool = False
    comms: Optional[list[str]] = None
    chunks: Optional[list[int]] = None
    fused: Optional[list[int]] = None

    def comm_kind(self, i: int) -> str:
        return self.comms[i] if self.comms else "ar"

    def chunk_count(self, i: int) -> int:
        return max(int(self.chunks[i]), 1) if self.chunks else 1

    def is_fused(self, i: int) -> bool:
        return bool(self.fused[i]) if self.fused else False

    @staticmethod
    def per_tensor(params) -> "GradSyncStrategy":
        n = len(T.leaves(params))
        return GradSyncStrategy([[i] for i in range(n)])

    @staticmethod
    def single_bucket(params) -> "GradSyncStrategy":
        n = len(T.leaves(params))
        return GradSyncStrategy([list(range(n))])

    @staticmethod
    def size_capped(params, cap_bytes: int = 25 * 2**20) -> "GradSyncStrategy":
        """DDP-style: consecutive leaves bucketed up to a byte cap."""
        buckets, cur, cur_b = [], [], 0
        for i, l in enumerate(T.leaves(params)):
            b = l.numel() * l.element_size()
            if cur and cur_b + b > cap_bytes:
                buckets.append(cur)
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += b
        if cur:
            buckets.append(cur)
        return GradSyncStrategy(buckets)

    @staticmethod
    def from_buckets(buckets, comms=None, chunks=None, params=None,
                     barriers: bool = False, fused=None) -> "GradSyncStrategy":
        """Build a strategy from explicit per-bucket state.  With
        ``params``, bucket entries are clipped to the real leaf count and
        uncovered leaves get singleton unfused AllReduce buckets (the
        reference's clip-to-leaves contract)."""
        buckets = [list(b) for b in buckets]
        comms = (list(comms) if comms is not None
                 else ["ar"] * len(buckets))
        chunks = ([int(k) for k in chunks] if chunks is not None
                  else [1] * len(buckets))
        fused = ([int(bool(f)) for f in fused] if fused is not None
                 else [0] * len(buckets))
        if params is not None:
            n = len(T.leaves(params))
            seen: set = set()
            kept, kcomms, kchunks, kfused = [], [], [], []
            for b, kind, k, fz in zip(buckets, comms, chunks, fused):
                bk = [i for i in b if i < n]
                seen.update(bk)
                if bk:
                    kept.append(bk)
                    kcomms.append(kind)
                    kchunks.append(k)
                    kfused.append(fz)
            rest = [i for i in range(n) if i not in seen]
            kept.extend([[i] for i in rest])
            kcomms.extend(["ar"] * len(rest))
            kchunks.extend([1] * len(rest))
            kfused.extend([0] * len(rest))
            buckets, comms, chunks, fused = kept, kcomms, kchunks, kfused
        return GradSyncStrategy(buckets, barriers=barriers, comms=comms,
                                chunks=chunks, fused=fused)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"buckets": self.buckets, "barriers": self.barriers,
                       "comms": self.comms, "chunks": self.chunks,
                       "fused": self.fused}, f)

    @staticmethod
    def load(path: str, params=None) -> "GradSyncStrategy":
        """Read a strategy file: a ``repro.plan`` artifact, through the
        port's own :class:`repro_torch.plan.Plan` (only its tensor-fusion
        half is enacted), or a legacy ``strategy.json`` as :meth:`save`
        writes it.  With ``params``, a Plan's buckets are clipped to the
        real leaves by ``Plan.grad_sync(params)``, and a legacy file's
        likewise."""
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict) or "buckets" not in d:
            raise ValueError(f"{path}: not a strategy file or Plan artifact")
        if "schema" in d:
            from ..plan import Plan
            return Plan.from_dict(d, source=path).grad_sync(params)
        strat = GradSyncStrategy(d["buckets"], d.get("barriers", False),
                                 comms=d.get("comms"), chunks=d.get("chunks"),
                                 fused=d.get("fused"))
        if params is None:
            return strat
        return GradSyncStrategy.from_buckets(
            strat.buckets, strat.comms, strat.chunks, params=params,
            barriers=strat.barriers, fused=strat.fused)


# -------------------------------------------------------------- collectives
def _all_reduce(t: torch.Tensor, group) -> None:
    dist.all_reduce(t, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVE_BYTES["all_reduce"] += t.numel() * t.element_size()


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    dist.reduce_scatter_tensor(out, inp, group=group)
    COLLECTIVES["reduce_scatter"] += 1
    COLLECTIVE_BYTES["reduce_scatter"] += inp.numel() * inp.element_size()


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    dist.all_gather_into_tensor(out, inp, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_BYTES["all_gather"] += out.numel() * out.element_size()


def _rs_ag_mean(part: torch.Tensor, dp: int, group) -> torch.Tensor:
    """Mean of an f32 range over the group by reduce-scatter + all-gather,
    padded to a multiple of dp."""
    n0 = part.numel()
    pad = (-n0) % dp
    if pad:
        part = torch.cat([part, part.new_zeros(pad)])
    shard = part.new_empty(part.numel() // dp)
    _reduce_scatter(shard, part.contiguous(), group)
    shard.div_(dp)
    out = part.new_empty(part.numel())
    _all_gather(out, shard, group)
    return out[:n0]


def _fused_bucket_sync(leaves: list, dp: int, chunks: int, group) -> None:
    """Fused bucket: pack kernel (leaves -> chunk-major, dp-padded f32
    staging, cast fused) -> per chunk reduce-scatter, ``/ dp`` on the
    shard, all-gather into the chunk's own staging -> unpack kernel (f32 ->
    grad dtype), written in place into the leaves (on the training path,
    the parameters' ``.grad`` tensors: no second gradient copy)."""
    total = sum(l.numel() for l in leaves)
    k = min(max(int(chunks), 1), max(total, 1))
    parts = K.fused_pack(leaves, total, dp, k)
    for part in parts:
        shard = part.new_empty(part.numel() // dp)
        _reduce_scatter(shard, part, group)
        shard.div_(dp)
        _all_gather(part, shard, group)
    K.fused_unpack(parts, [l.shape for l in leaves],
                   [l.dtype for l in leaves], out=leaves)


def sync_grads(grads: list, strategy: GradSyncStrategy,
               group=None) -> list:
    """Bucketed gradient mean over ``group`` (default: the world), each
    bucket fused into one tensor with its searched collective kind and
    chunk count.  Returns the synced gradients in leaf order.  A fused
    bucket's gradients are overwritten in place by the unpack kernel; an
    unfused bucket's come back as views of its reduced buffer, in the
    dtype of the bucket's concatenation (f32 when its leaves mix f32 and
    bf16), as in the reference."""
    dp = dist.get_world_size(group)
    out: list = [None] * len(grads)
    for bi, bucket in enumerate(strategy.buckets):
        with span("sync.bucket"):
            leaves = [grads[i] for i in bucket]
            if strategy.is_fused(bi):
                _fused_bucket_sync(leaves, dp, strategy.chunk_count(bi),
                                   group)
                for i, g in zip(bucket, leaves):
                    out[i] = g
                continue
            # the dtype the bucket's concatenation has in the reference
            dt = functools.reduce(torch.promote_types,
                                  [g.dtype for g in leaves])
            n = sum(g.numel() for g in leaves)
            # reduce in f32, as the reference does: one pack kernel stages
            # the leaves, converted, into the f32 buffer
            f32 = K.bucket_pack(leaves, n, torch.float32)

            def reduce_one(part):
                if strategy.comm_kind(bi) == "rs_ag":
                    return _rs_ag_mean(part, dp, group)
                part = part.contiguous()
                _all_reduce(part, group)
                return part / dp

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


def _mean(g: torch.Tensor, dp: int, group) -> torch.Tensor:
    """The f32 mean of ``g`` over the group (one all-reduce)."""
    g = g.float()
    _all_reduce(g, group)
    return g.div_(dp)


# --------------------------------------------------------------- step build
def _rank_shard(batch: dict, dp: int, rank: int) -> dict:
    """This rank's rows of the global batch (the reference shards the
    batch's leading dim over the data axes in rank order)."""
    out = {}
    for key, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch dim {v.shape[0]} of {key!r} does not "
                             f"split over {dp} ranks")
        per = v.shape[0] // dp
        out[key] = v[rank * per:(rank + 1) * per]
    return out


def build_train_step(
    cfg: ModelConfig,
    *,
    mode: str = "ddp_tp",
    layout: str = "dp",
    strategy: Optional[GradSyncStrategy] = None,
    optimizer=None,
    grad_accum: int = 1,
    remat: bool = True,
    clip_norm: float = 1.0,
    lr: float = 3e-4,
    loss_fn: Optional[Callable] = None,
    group=None,
    mesh=None,
    zero1: bool = False,
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``step.loss_and_grads(params, batch)`` (the step's
    part before the sync, clip and update) and ``step.tp``.  ``params``
    is the parameter tree, updated in place; ``batch`` is the global
    batch, of which each data rank takes its rows.

    ``layout="dp"``: every rank of ``group`` (default: the world) is a
    data rank holding the whole tree.  ``layout="tp"``: ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`) is a ``("data", "model")``
    mesh; ``params`` holds this rank's slices of the model
    (:func:`repro_torch.distributed.tensor_parallel.shard_params` with
    ``step.tp``; every architecture, the routed experts sharded by
    expert), the model group runs the tensor-parallel forward and
    backward, and the data group syncs the local slices' gradients bucket
    by bucket (the bucket indices are the tree's; each bucket's bytes
    shrink by the slicing), as the reference's Megatron-DDP style sync
    does.  Each data rank routes its own rows through the experts, as the
    reference's ``layout="dp"`` does; its ``layout="tp"`` routes the
    global batch (ROADMAP C21).  ``zero1=True`` keeps each AdamW moment's slice along the leaf's
    largest free dim that the data group's size divides (the reference's
    ZeRO-1 rule; a moment still whole in ``opt_state`` is sliced on the
    way in) and all-gathers the updated parameter slices over the data
    group.

    ``mode="fsdp_tp"`` (ZeRO-3) runs the tensor-parallel layout on
    ``mesh`` (``layout`` is not read) with every leaf held as this rank's
    slice under the rules' ``fsdp=True`` specs (``shard_params`` with
    ``step.tp``): each layer's leaves are all-gathered over the data group
    inside the block that remat checkpoints, the gather's backward
    reduce-scatters the gradient and takes its mean over the data ranks,
    the leaves no rule shards over the data ranks are all-reduced to their
    mean, the clip's norm counts every element once, and AdamW steps the
    shards, its moments sharded with them.  As in the reference, no Plan's
    buckets are enacted in this mode: a ``strategy`` raises
    ``ValueError``, as does ``zero1``."""
    fsdp = mode == "fsdp_tp"
    if mode not in ("ddp_tp", "fsdp_tp") or layout not in ("dp", "tp"):
        raise ValueError(f"mode={mode!r} layout={layout!r}: the port has "
                         f"mode 'ddp_tp' with layout 'dp' or 'tp', and "
                         f"mode 'fsdp_tp'")
    if fsdp and (strategy is not None or zero1):
        raise ValueError("mode='fsdp_tp' enacts no DisCo buckets and shards "
                         "every moment already: pass no strategy and no "
                         "zero1")
    opt_init, opt_update = optimizer or adamw(lr, weight_decay=0.01)
    if loss_fn is None:
        from ..models import stacked as ST
        loss_fn = ST.loss_fn
    tp = None
    if layout == "tp" or fsdp:
        if mesh is None:
            raise ValueError(f"mode={mode!r} layout={layout!r} needs a "
                             f"('data', 'model') mesh")
        tp = (TP.TPContext(cfg, mesh.model, data=mesh.data,
                           mesh_shape=mesh.shape) if fsdp
              else TP.TPContext(cfg, mesh.model))
        group = mesh.data
    z1 = None   # ZeRO-1's (update, apply, shard_state), made at step 1

    def zero1_of(leaves):
        """ZeRO-1 on ``leaves``: the reference's rule on each leaf's spec.
        A model-sharded dim is not free, and a free dim has its full size
        in the local slice, so the local shapes give the rule's answer."""
        specs = (tp.specs if tp is not None
                 else [(None,) * p.dim() for p in leaves])
        data = {"data": dist.get_world_size(group)}
        dims = [SH.spec_dim(SH.zero1_spec(p.shape, sp, data), "data")
                for p, sp in zip(leaves, specs)]
        return zero1_opt(opt_update, dims, group)

    def local_loss(params, batch):
        if tp is None:
            return loss_fn(params, cfg, batch, remat=remat)
        return loss_fn(params, cfg, batch, remat=remat, tp=tp)

    def grads_of(params, leaves, batch):
        if grad_accum > 1:
            micro = [{k: v.chunk(grad_accum)[i] for k, v in batch.items()}
                     for i in range(grad_accum)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for mb in micro:
                with span("step.fwd"):
                    l = local_loss(params, mb)
                with span("step.bwd"):
                    for a, g in zip(acc, torch.autograd.grad(l, leaves)):
                        a.add_(g)
                loss = loss + l.detach()
            scale = 1.0 / grad_accum
            return loss * scale, [a.mul_(scale) for a in acc]
        with span("step.fwd"):
            loss = local_loss(params, batch)
        with span("step.bwd"):
            loss.backward()
        return loss.detach(), [p.grad for p in leaves]

    def loss_and_grads(params, batch):
        """This rank's loss and local gradients on its rows of ``batch``:
        the step before any sync, clip or update."""
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        dp, rank = dist.get_world_size(group), dist.get_rank(group)
        return grads_of(params, leaves, _rank_shard(batch, dp, rank))

    def step(params, opt_state, batch):
        nonlocal z1
        leaves = T.leaves(params)
        dp = dist.get_world_size(group)
        strat = strategy or GradSyncStrategy.per_tensor(params)
        loss, grads = loss_and_grads(params, batch)
        with span("step.sync"):
            if fsdp:
                grads = [g if dd is not None else _mean(g, dp, group)
                         for g, dd in zip(grads, tp.ddims)]
            else:
                grads = sync_grads(grads, strat, group)
            dist.all_reduce(loss, group=group)
            loss = loss / dp
        with span("step.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm, tp)
        for p in leaves:
            p.grad = None
        with span("step.update"):
            update, apply = opt_update, apply_updates
            if zero1:
                z1 = z1 or zero1_of(leaves)
                update, apply, shard_state = z1
                opt_state = shard_state(opt_state, leaves)
            updates, opt_state = update(grads, opt_state, leaves)
            apply(leaves, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    step.tp = tp
    step.loss_and_grads = loss_and_grads
    return step
