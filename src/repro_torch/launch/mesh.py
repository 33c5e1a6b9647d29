"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``'s ``make_debug_mesh``).

A mesh lays the ranks of the default process group out row-major over
named dims, as a jax mesh lays out its devices: on a ``("data", "model")``
mesh of shape (dp, tp), rank ``d * tp + m`` holds data index ``d`` and
model index ``m``.  Each rank gets the process group of its own row along
each dim: the ranks that share its data index form its ``model`` group,
and those that share its model index its ``data`` group.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


@dataclasses.dataclass
class Mesh:
    """A ``DeviceMesh`` with its dims' sizes and this rank's groups."""
    device_mesh: DeviceMesh
    shape: dict          # dim name -> size, in mesh order
    data: dist.ProcessGroup
    model: dist.ProcessGroup


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh of ``shape`` over the default process
    group, which must hold exactly ``prod(shape)`` ranks (NCCL for
    ``cuda``, gloo for ``cpu``)."""
    if tuple(axes) != ("data", "model"):
        raise ValueError(f"axes {axes}: only ('data', 'model') meshes are "
                         f"ported")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    dm = init_device_mesh(resolve_device(device).type, tuple(shape),
                          mesh_dim_names=tuple(axes))
    return Mesh(dm, dict(zip(axes, shape)), dm.get_group("data"),
                dm.get_group("model"))
