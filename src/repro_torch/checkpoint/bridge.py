"""Weight bridge: the reference's parameters, as numpy, into the port.

``params_from_jax`` takes the reference's parameter tree after
``jax.tree.map(np.asarray, params)`` (nested dicts and lists of numpy
arrays; bfloat16 arrays carry numpy's ``bfloat16`` extension dtype) and
returns the same tree of torch tensors.  The port keeps the reference's
layout (``x @ W`` with ``W`` of shape (d_in, d_out), stacked layer dims,
MoE expert stacks (layers, E, d_in, d_out) and the ``shared`` experts'
subtree), so no leaf is transposed or reordered.
"""
from __future__ import annotations

import numpy as np

from .. import tree as T
from ..device import resolve_device
from .store import _from_numpy


def params_from_jax(tree_of_numpy, device="cuda"):
    dev = resolve_device(device)
    return T.map(lambda a: _from_numpy(np.asarray(a), np.asarray(a).dtype.name,
                                       dev), tree_of_numpy)
