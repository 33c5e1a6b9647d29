"""Sharding rules: which dims of each parameter, optimizer moment and batch
lie over which mesh dims (the port's own copy of
``repro/distributed/sharding.py``'s rules).

A spec is a tuple with one entry per dim of the leaf: ``None``
(replicated), a mesh-dim name (``"model"``, ``"data"``) or a tuple of
names (``("pod", "data")``).  The rules work on the leaf paths of
:func:`repro_torch.tree.leaves_with_paths` and plain shapes, and touch no
device state, so they hold for every architecture of the reference at any
mesh shape:

* tensor parallelism shards the flattened projection dims over ``model``
  (column-parallel ``wq``/``wk``/``wv``/``w_up``/``w_gate``/...,
  row-parallel ``wo``/``w_down``/...), never splitting an attention head:
  with unaligned heads the non-head dim is sharded instead;
* the embedding and the LM head shard their vocab dim;
* MoE expert stacks shard their expert dim (expert parallelism);
* norms, biases, routers and low-rank down projections are replicated;
* ``fsdp=True`` further shards the largest free dim over the data dims
  (ZeRO-3), and :func:`zero1_spec` does the same for an optimizer moment
  (ZeRO-1).

Where the reference reads the data dims' size from a module-level cache
that ``param_shardings`` fills, these functions take it as ``dp_size``.
"""
from __future__ import annotations

import math
import re
from typing import Mapping, Optional, Sequence

from .. import tree as T

# leaf-name -> (model-sharded dim index) for 2D weights
_OUT_SHARDED = {"wq", "wk", "wv", "w_up", "w_gate", "w_uq", "w_uk", "w_uv",
                "w_x", "w_ri", "w_ii", "w_r", "w_k", "w_v", "w_g", "c_k",
                "c_r"}
_IN_SHARDED = {"wo", "w_down", "w_out", "w_o", "c_v"}
_EXPERT_LEAVES = {"w_up", "w_gate", "w_down"}  # under a "moe" subtree
_REPLICATED = {"router", "w_dq", "w_dkv", "w_kr", "conv_w", "conv_b", "lam",
               "w0", "wA", "wB", "bonus", "in_proj", "vision_proj"}
_Q_LEAVES = {"wq", "bq"}
_KV_LEAVES = {"wk", "wv", "bk", "bv"}
_QO_LEAVES = {"wo"}

_PATH_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")

Spec = tuple


def path_names(path: str) -> list[str]:
    """The dict keys and sequence indices of a keypath string, as the
    reference's ``_path_names`` reads a jax keypath (attribute names, such
    as an ``OptState``'s ``.mu``, are skipped as it skips them)."""
    return [key if key else idx
            for key, idx, _ in _PATH_PART.findall(path) if key or idx]


def _dp_entry(dp_axes: Sequence[str]):
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def param_spec(path: str, shape, *, model_size: int, dp_axes: tuple = (),
               fsdp: bool = False, dp_size: int = 1, q_aligned: bool = True,
               kv_aligned: bool = True) -> Spec:
    """The spec of the parameter at ``path`` with ``shape``.  ``dp_axes``
    names the data dims and ``dp_size`` is the product of their sizes
    (both read only with ``fsdp``)."""
    names = path_names(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names and "shared" not in names
    shape = tuple(shape)
    # stacked (looped-layer) params carry a leading layer dim under
    # "groups"/"layers": the rules apply to the trailing dims
    stacked = (("groups" in names or "layers" in names) and len(shape) >= 2
               and name not in ("embed", "lm_head"))
    lead: tuple = ()
    if stacked:
        lead = (None,)
        shape = shape[1:]
    spec: list = [None] * len(shape)

    if in_moe and name in _EXPERT_LEAVES and shape[0] % model_size == 0:
        if (fsdp and dp_axes and shape[0] % dp_size == 0
                and shape[-1] % model_size == 0):
            # full expert parallelism: experts over the data dims, each
            # expert's FFN dim over model
            spec[0] = _dp_entry(dp_axes)
            spec[-1] = "model"
            return (*lead, *spec)
        spec[0] = "model"          # expert parallelism over the TP dim
    elif name == "embed" and shape[0] % model_size == 0:
        spec[0] = "model"          # vocab-sharded embedding
    elif name == "lm_head" and shape[-1] % model_size == 0:
        spec[-1] = "model"
    elif (name in _REPLICATED or "ln" in name or "norm" in name
          or name.startswith("mu") or name.startswith("cmu")
          or name.startswith("b") or "scale" in name or "bias" in name):
        pass
    elif name in _Q_LEAVES or name in _KV_LEAVES or name in _QO_LEAVES:
        # Megatron's head alignment: never split an attention head
        aligned = q_aligned if name in (_Q_LEAVES | _QO_LEAVES) else kv_aligned
        if aligned:
            if (len(shape) == 2 and name in _QO_LEAVES
                    and shape[0] % model_size == 0):
                spec[0] = "model"
            elif (len(shape) == 2 and name not in _QO_LEAVES
                  and shape[1] % model_size == 0):
                spec[1] = "model"
            elif len(shape) == 1 and shape[0] % model_size == 0:
                spec[0] = "model"
        elif len(shape) == 2 and name in (_Q_LEAVES | _QO_LEAVES):
            # unaligned heads: shard the dim that is not the heads'
            if name in _Q_LEAVES and shape[0] % model_size == 0:
                spec[0] = "model"
            elif name in _QO_LEAVES and shape[1] % model_size == 0:
                spec[1] = "model"
    elif (len(shape) == 2 and name in _OUT_SHARDED
          and shape[1] % model_size == 0):
        spec[1] = "model"
    elif (len(shape) == 2 and name in _IN_SHARDED
          and shape[0] % model_size == 0):
        spec[0] = "model"

    if fsdp and dp_axes and name not in ("embed", "lm_head"):
        # the largest free dim over the data dims (ZeRO-3); the embedding
        # and the head stay vocab-sharded only
        free = sorted((i for i, s in enumerate(spec) if s is None),
                      key=lambda i: -shape[i])
        for i in free:
            if shape[i] % dp_size == 0:
                spec[i] = _dp_entry(dp_axes)
                break
    return (*lead, *spec)


def dp_axes_of(mesh_shape: Mapping[str, int]) -> tuple:
    """The data dims of a mesh, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def dp_size_of(mesh_shape: Mapping[str, int]) -> int:
    return math.prod(mesh_shape[a] for a in dp_axes_of(mesh_shape))


def head_alignment(cfg, mesh_shape: Mapping[str, int]) -> dict:
    """Whether q / kv attention projections may shard over ``model``
    without splitting a head."""
    m = mesh_shape.get("model", 1)
    return {"q_aligned": cfg is None or cfg.n_heads % m == 0,
            "kv_aligned": cfg is None or cfg.n_kv_heads % m == 0}


def param_specs(params, mesh_shape: Mapping[str, int], *,
                fsdp: bool = False, cfg=None) -> list:
    """Each leaf's spec, in leaf order, on a mesh of ``mesh_shape``
    (a mapping from mesh-dim name to size); a 0-dim leaf's is ``()``."""
    kw = dict(model_size=mesh_shape.get("model", 1),
              dp_axes=dp_axes_of(mesh_shape), fsdp=fsdp,
              dp_size=dp_size_of(mesh_shape),
              **head_alignment(cfg, mesh_shape))
    return [param_spec(path, leaf.shape, **kw) if len(leaf.shape) else ()
            for path, leaf in T.leaves_with_paths(params)]


def batch_pspec(batch_dim_size: int, mesh_shape: Mapping[str, int],
                ndim: int) -> Spec:
    """Shard the leading batch dim over all data dims that divide it."""
    axes = dp_axes_of(mesh_shape)
    if axes and batch_dim_size % dp_size_of(mesh_shape) == 0:
        return (_dp_entry(axes), *([None] * (ndim - 1)))
    return (None,) * ndim


def zero1_spec(shape, spec: Spec, mesh_shape: Mapping[str, int]) -> Spec:
    """ZeRO-1: an optimizer moment's spec is its parameter's ``spec`` with
    the largest free dim that the data dims' size divides sharded over
    them."""
    dp_axes = dp_axes_of(mesh_shape)
    dp = dp_size_of(mesh_shape)
    shape = tuple(shape)
    if not shape or dp == 1:
        return spec
    out = list(spec) + [None] * (len(shape) - len(spec))
    free = sorted((i for i, s in enumerate(out) if s is None),
                  key=lambda i: -shape[i])
    for i in free:
        if shape[i] % dp == 0:
            out[i] = _dp_entry(dp_axes)
            break
    return tuple(out)


def spec_dim(spec: Spec, name: str = "model") -> Optional[int]:
    """The dim of a spec that lies over mesh dim ``name``, or None."""
    for i, s in enumerate(spec):
        if s == name or (isinstance(s, tuple) and name in s):
            return i
    return None
