"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``: ``make_debug_mesh``, ``make_production_mesh``
and the ``cluster_from_mesh`` bridge).

A mesh lays the ranks of the default process group out row-major over
named dims, as a jax mesh lays out its devices: on a ``("data", "model")``
mesh of shape (dp, tp), rank ``d * tp + m`` holds data index ``d`` and
model index ``m``.  Each rank gets the process group of its own row along
each dim: the ranks that share its data index form its ``model`` group,
and those that share its model index its ``data`` group.  On the
multi-pod ``("pod", "data", "model")`` mesh the data group spans pod x
data, as the reference's ``dp_axes`` does: rank ``(p * data + d) * tp +
m`` has data index ``p * data + d``.

Production mesh: single pod 16x16 = 256 ranks over ``("data", "model")``,
multi pod 2x16x16 = 512 over ``("pod", "data", "model")``.  One host runs
one rank of such a world through torch's ``fake`` process-group backend
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


@dataclasses.dataclass
class Mesh:
    """A ``DeviceMesh`` with its dims' sizes and this rank's groups.
    ``shape`` maps every dim of the mesh, in mesh order, to its size;
    ``device_mesh`` is laid out over (data ranks, model ranks), the data
    ranks spanning every dim but ``model``."""
    device_mesh: DeviceMesh
    shape: dict          # dim name -> size, in mesh order
    data: dist.ProcessGroup
    model: dist.ProcessGroup


def make_mesh(shape: dict, device="cuda") -> Mesh:
    """A mesh of ``shape`` (dim name -> size, in mesh order, with a
    ``model`` dim) over the default process group, which must hold exactly
    ``prod(shape)`` ranks."""
    n = math.prod(shape.values())
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape.values())} mesh needs {n} ranks, "
                           f"the process group has {dist.get_world_size()}")
    tp = shape["model"]
    dm = init_device_mesh(resolve_device(device).type, (n // tp, tp),
                          mesh_dim_names=("data", "model"))
    return Mesh(dm, dict(shape), dm.get_group("data"), dm.get_group("model"))


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh of ``shape`` over the default process
    group, which must hold exactly ``prod(shape)`` ranks (NCCL for
    ``cuda``, gloo for ``cpu``)."""
    if tuple(axes) != ("data", "model"):
        raise ValueError(f"axes {axes}: only ('data', 'model') meshes are "
                         f"ported")
    return make_mesh(dict(zip(axes, shape)), device)


# the reference's production meshes, keyed by ``multi_pod``
PRODUCTION_SHAPES = {False: {"data": 16, "model": 16},
                     True: {"pod": 2, "data": 16, "model": 16}}


def make_production_mesh(multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production mesh over the default process group:
    ``(16, 16)`` over ``("data", "model")`` (256 ranks), or ``(2, 16,
    16)`` over ``("pod", "data", "model")`` (512) with ``multi_pod``."""
    return make_mesh(dict(PRODUCTION_SHAPES[multi_pod]), device)


def cluster_from_mesh(mesh, hw=None):
    """Lift a mesh onto a :class:`repro_torch.cluster.ClusterSpec`: the
    intra-pod dims collapse into the v5e-style ICI levels
    (``tpu_pod_levels``, at ``hw.ici_bw``), a ``pod`` dim becomes an outer
    DCN level.  Only ``mesh.shape`` (dim name -> size) is read, so any
    object with such a mapping works.  ``hw`` defaults to ``H100_SXM``;
    given ``TPU_V5E`` the spec is the reference's."""
    from ..cluster import ClusterSpec, dcn_level, tpu_pod_levels
    from ..core.hw import H100_SXM

    hw = hw or H100_SXM
    shape = dict(mesh.shape)
    pods = int(shape.pop("pod", 1))
    ici = 1
    for v in shape.values():
        ici *= int(v)
    levels = tpu_pod_levels(ici, bw=hw.ici_bw)
    if pods > 1:
        levels = levels + (dcn_level(pods),)
    name = "mesh_" + "x".join(str(s) for s in
                              ([pods] if pods > 1 else []) + list(shape.values()))
    return ClusterSpec(name, levels)
