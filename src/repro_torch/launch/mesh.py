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

:func:`mesh_groups` gives a rank its two process groups on a mesh: the
ranks along ``model`` (tensor parallelism) and the ranks along the
flattened batch axes (("pod", "data") or ("data",): data parallelism,
FSDP and the sequence-sharded cache).  The rank lists are a pure function
of the mesh's shape (:func:`group_ranks`): ranks are laid out row-major
over the mesh's axes, as ``init_device_mesh`` lays them out.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, NamedTuple

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


def group_ranks(shape: tuple, names: tuple, axes: tuple) -> list[list[int]]:
    """The rank lists of the groups along ``axes`` of a mesh of ``shape``
    (axis ``names``), ranks row-major over the mesh: one list for each
    coordinate of the other axes, in row-major order, each list ordered
    along ``axes`` flattened in mesh order (the first axis major)."""
    along = [names.index(a) for a in names if a in axes]
    other = [i for i in range(len(shape)) if i not in along]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    out = []
    for fixed in itertools.product(*(range(shape[i]) for i in other)):
        base = sum(c * strides[i] for c, i in zip(fixed, other))
        out.append([base + sum(c * strides[i] for c, i in zip(moving, along))
                    for moving in itertools.product(*(range(shape[i]) for i in along))])
    return out


def coordinate(mesh, rank: int) -> dict:
    """``rank``'s coordinate along each axis of ``mesh`` (row-major)."""
    out, rest = {}, rank
    for name, size in reversed(list(zip(mesh.mesh_dim_names, mesh.shape))):
        out[name] = rest % size
        rest //= size
    return out


class MeshGroups(NamedTuple):
    """A rank's groups on a mesh, along ``model`` and along the flattened
    batch axes, and its index in each."""
    model: Any
    batch: Any
    model_index: int
    batch_index: int


_GROUPS: dict = {}


def mesh_groups(mesh) -> MeshGroups:
    """This rank's :class:`MeshGroups` on ``mesh``, built on the first call
    for a mesh (every rank of the default group must make that call: each
    ``new_group`` is collective) and kept for later ones."""
    held = _GROUPS.get(id(mesh))
    if held is not None and held[0] is mesh:
        return held[1]
    shape, names = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    if isinstance(mesh, DeviceMesh):
        laid = mesh.mesh.flatten().tolist()
        if laid != list(range(math.prod(shape))):
            raise ValueError(f"mesh ranks {laid} are not laid out row-major")
    rank = dist.get_rank()
    mine = {}
    for kind, axes in (("model", ("model",)), ("batch", batch_axes(mesh))):
        for ranks in group_ranks(shape, names, axes):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[kind] = (group, tuple(ranks))
    (model, mranks), (batch, branks) = mine["model"], mine["batch"]
    groups = MeshGroups(model, batch, mranks.index(rank), branks.index(rank))
    _GROUPS[id(mesh)] = (mesh, groups)
    return groups
