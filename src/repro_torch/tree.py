"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples.

Leaf order equals ``jax.tree.leaves`` order: dict keys sorted, sequences in
order, NamedTuple fields in declaration order.  Plan buckets are indices
into this order, so it must never differ from the reference's.  Key paths
are rendered as ``jax.tree_util.keystr`` renders them (``['groups'][0]``,
``.mu``), which the checkpoint layout stores.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += leaves_with_paths(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like ``template`` holding ``new_leaves`` in leaf
    order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(getattr(t, n)) for n in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` applied leaf-wise over trees of one
    structure."""
    columns = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
