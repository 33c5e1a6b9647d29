"""Optimizers as functions on lists of tensors (port of
``repro/optim/optimizers.py``).

An optimizer is a pair ``(init_fn, update_fn)``:
    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)
over lists of tensors in leaf order.  The arithmetic follows the
reference's: f32 moments, bias correction, decoupled weight decay inside
the update, the lr read at the count before the increment, and bf16
operands promoted to f32 wherever the reference's expression promotes
them.  ``apply_updates`` writes into the parameters in place (the
reference returns new arrays) so a step holds one copy of the weights.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.tensor_parallel import gather_leaf
from ..kernels import ops as K


class OptState(NamedTuple):
    mu: list         # first moments, f32
    nu: list         # second moments, f32
    count: torch.Tensor   # 0-d int32 on the CPU: steps taken


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: int) -> float:
        t = np.float32(min(step, total_steps)) / np.float32(max(total_steps, 1))
        cos = np.float32(0.5) * (1 + np.cos(np.float32(np.pi) * t))
        return float(np.float32(base_lr)
                     * (np.float32(final_frac)
                        + np.float32(1 - final_frac) * cos))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: int) -> float:
        if step < warmup:
            return float(np.float32(base_lr) * np.float32(step + 1)
                         / np.float32(max(warmup, 1)))
        return cos(step - warmup)
    return fn


def clip_by_global_norm(grads: list, max_norm: float, tp=None):
    """Scale ``grads`` to global f32 norm at most ``max_norm``.  Returns
    (f32 clipped grads, norm).  Each gradient that is not f32 is cast up
    first by the convert-copy kernel's wrapper, as the reference's
    ``g * scale`` promotes a bf16 gradient.  With a tensor-parallel
    context ``tp`` the gradients are this rank's slices: the squares of
    the model-sharded leaves are summed over its group, and each
    replicated leaf, equal on every rank, counts once.  Under ZeRO-3
    (``tp.fsdp``) the squares are summed over each group a leaf is
    sharded over, the model group, the data group or both, and an element
    replicated over a group counts once."""
    g32 = [g if g.dtype == torch.float32 else K.convert_copy(g, torch.float32)
           for g in grads]
    if tp is None:
        gnorm = torch.sqrt(sum(g.square().sum() for g in g32))
    elif tp.fsdp:
        # sums of squares sharded over [model and data, data only, model
        # only, neither]
        parts = torch.zeros(4, device=g32[0].device)
        for g, d, dd in zip(g32, tp.dims, tp.ddims):
            parts[(d is None) + 2 * (dd is None)] += g.square().sum()
        by_model = parts[0::2].clone()
        tp.all_reduce(by_model)
        by_data = torch.stack([by_model[0], parts[1]])
        tp.data_all_reduce(by_data)
        gnorm = torch.sqrt(by_data.sum() + by_model[1] + parts[3])
    else:
        sharded = torch.zeros((), device=g32[0].device)
        replicated = torch.zeros((), device=g32[0].device)
        for g, d in zip(g32, tp.dims):
            if d is None:
                replicated = replicated + g.square().sum()
            else:
                sharded = sharded + g.square().sum()
        tp.all_reduce(sharded)
        gnorm = torch.sqrt(sharded + replicated)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return [g * scale for g in g32], gnorm


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: list) -> OptState:
        return OptState(
            [torch.zeros_like(p, dtype=torch.float32) for p in params],
            [torch.zeros_like(p, dtype=torch.float32) for p in params],
            torch.zeros((), dtype=torch.int32))

    def update(grads: list, state: OptState, params: list):
        step = int(state.count)
        c = np.float32(step + 1)
        mu_hat_s = float(np.float32(1.0) / (1 - np.float32(b1) ** c))
        nu_hat_s = float(np.float32(1.0) / (1 - np.float32(b2) ** c))
        step_lr = lr_fn(step)
        updates = []
        for m, v, g, p in zip(state.mu, state.nu, grads, params):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m * mu_hat_s) / (torch.sqrt(v * nu_hat_s) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.detach().float()
            updates.append(upd.mul_(-step_lr))
        return updates, OptState(state.mu, state.nu,
                                 torch.tensor(step + 1, dtype=torch.int32))

    return init, update


def zero1(update, dims: list, group):
    """ZeRO-1 over the data-parallel ``group`` for an optimizer's
    ``update``: each leaf with a dim in ``dims`` (None: none) keeps only
    this rank's slice of its moments along that dim, and its update covers
    only the matching slice of the parameter.  Returns ``(update, apply,
    shard_state)``: ``apply(params, updates)`` writes the updated slices
    and all-gathers them over the group; ``shard_state(state, params)``
    cuts each moment that is still whole to this rank's slice.  The
    optimizer must be elementwise, as AdamW is: the parameters then come
    out bit-equal to the unsharded update's."""
    dp, rank = dist.get_world_size(group), dist.get_rank(group)

    def piece(t, d):
        if d is None:
            return t
        n = t.shape[d] // dp
        return t.narrow(d, rank * n, n)

    def z_update(grads: list, state, params: list):
        return update([piece(g, d) for g, d in zip(grads, dims)], state,
                      [piece(p, d) for p, d in zip(params, dims)])

    @torch.no_grad()
    def z_apply(params: list, updates: list) -> list:
        apply_updates([piece(p, d) for p, d in zip(params, dims)], updates)
        for p, d in zip(params, dims):
            if d is not None:
                p.copy_(gather_leaf(piece(p, d), d, group))
        return params

    def shard_state(state: OptState, params: list) -> OptState:
        def cut(moments):
            return [piece(m, d).clone()
                    if d is not None and m.shape == p.shape else m
                    for m, p, d in zip(moments, params, dims)]
        return OptState(cut(state.mu), cut(state.nu), state.count)

    return z_update, z_apply, shard_state


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0):
    """SGD, with momentum when ``momentum`` is nonzero: the velocity
    ``momentum * m + g`` is kept in each parameter's dtype, as the
    reference's ``zeros_like`` moments are, and the update is ``-lr *
    velocity`` (the gradient itself without momentum)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: list) -> OptState:
        mu = [torch.zeros_like(p) for p in params] if momentum else []
        return OptState(mu, [], torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(grads: list, state: OptState, params: list):
        step = int(state.count)
        step_lr = lr_fn(step)
        if momentum:
            for m, g in zip(state.mu, grads):
                m.mul_(momentum).add_(g)
        vel = state.mu if momentum else grads
        updates = [v * -step_lr for v in vel]
        return updates, OptState(state.mu, state.nu,
                                 torch.tensor(step + 1, dtype=torch.int32))

    return init, update


@torch.no_grad()
def apply_updates(params: list, updates: list) -> list:
    """``p + u`` in f32, cast back to each parameter's dtype, in place."""
    for p, u in zip(params, updates):
        p.copy_(p.float() + u)
    return params
