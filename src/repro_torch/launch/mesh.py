"""Device meshes: ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, the JAX package's
``launch/mesh.py``.

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the ``pod`` axis is a second data-parallel axis.
The caller initialises the default process group
(``torch.distributed.init_process_group`` with its backend, address,
world size and rank); a mesh is never built in a world of another size,
and there is no fallback to one rank.

The spec functions (``batch_axes``, ``data_shards`` and
``launch/shardings.py``) read only a mesh's ``mesh_dim_names`` and
``shape``, so an :class:`AbstractMesh` -- a mesh's shape without ranks --
serves them too, as ``jax.sharding.AbstractMesh`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import platform


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names, without ranks or devices."""
    shape: tuple
    mesh_dim_names: tuple


def _device_type(device_type: str | None) -> str:
    return device_type or platform.default_device().type


def _build(shape: tuple, names: tuple, device_type: str | None) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group "
                           "(torch.distributed.init_process_group) before building a mesh")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the default group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over ``device_type`` ranks (None: the CUDA card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type: str | None = None):
    """A (data, model) mesh over a small world (tests, one card)."""
    return _build((data, model), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (everything except model)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def data_shards(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))
