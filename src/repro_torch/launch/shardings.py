"""Logical axis names -> mesh partition specs -> DTensor placements, the
JAX package's ``launch/shardings.py`` (t5x/MaxText-style rules).

TP ("model"): attention heads, d_ff columns, vocab, experts, SSM heads.
FSDP (all batch axes: ("pod", "data") multi-pod, ("data",) single): the
d_model ("embed"/"embed_out") axis of every large matrix; the train step
gathers one layer at a time, so per-rank weight memory is
O(params / (fsdp * tp) + one layer).

A :class:`PartitionSpec` holds, per tensor dim, ``None``, a mesh axis name
or a tuple of them, as JAX's does.  :func:`to_placements` turns one into
the DTensor placements of a ``DeviceMesh`` (one per mesh dim: ``Shard(i)``
where tensor dim i is split over that axis, else ``Replicate()``);
:func:`to_shardings` pairs every spec of a tree with its mesh as a
:class:`NamedSharding`.  Trees are walked in ``jax.tree_util``'s order
(:mod:`..tree`).  The spec functions read only ``mesh.mesh_dim_names`` and
``mesh.shape`` (``mesh.AbstractMesh`` serves); the placements need a real
``DeviceMesh`` only to distribute tensors.

:func:`local_block` cuts a rank's block of a tensor from its spec with no
collective, from a full tensor that every rank holds (drawn from the same
seed): at qwen2.5-3b, :func:`distribute`'s scatter from rank 0 would push
about 12 GB of f32 parameters through the group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..tree import tree_map
from .mesh import batch_axes, coordinate


def _normalize(entry):
    """As JAX stores an entry: () is None, a one-name tuple its name."""
    if isinstance(entry, tuple) and len(entry) < 2:
        return entry[0] if entry else None
    return entry


class PartitionSpec(tuple):
    """Per tensor dim: None, a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_normalize(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: ``spec`` and its DTensor
    ``placements``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def _mesh_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i is split over it, else
    ``Replicate()``.  A dim split over several axes takes them in mesh
    order (JAX's major-to-minor), which DTensor's default order is."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _mesh_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise NotImplementedError(f"dim {dim} is split over {axes}, out of mesh order")
        for axis in axes:
            if not isinstance(out[names.index(axis)], Replicate):
                raise ValueError(f"mesh axis {axis!r} splits two dims of {spec}")
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def logical_rules(mesh) -> dict:
    fsdp = batch_axes(mesh)
    return {
        "layers": None,
        "vocab": "model",
        "embed": fsdp,
        "embed_out": fsdp,
        "heads": "model",
        "kv": "model",
        "hd": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,
        "norm": None,
        "ssm_heads": "model",
        "ssm_group": None,
        "state": None,
        "conv": None,
        "conv_ch": None,
    }


def _is_axes_tuple(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def is_pspec(x) -> bool:
    return isinstance(x, PartitionSpec)


def axes_to_pspec(axes: tuple, rules: dict) -> PartitionSpec:
    return PartitionSpec(*[rules[a] for a in axes])


def param_pspecs(mesh, axes_tree):
    """Logical-axes tree (``models.model.param_axes``) -> PartitionSpec
    tree."""
    rules = logical_rules(mesh)
    return tree_map(lambda ax: axes_to_pspec(ax, rules), axes_tree, is_leaf=_is_axes_tuple)


def param_shardings(mesh, axes_tree):
    return to_shardings(mesh, param_pspecs(mesh, axes_tree))


def activation_pspec(mesh, *, seq_parallel: bool = False) -> PartitionSpec:
    """(B, S, d) activations: batch over all data axes; ``seq_parallel``
    also splits the sequence over the model axis between blocks."""
    return PartitionSpec(batch_axes(mesh), "model" if seq_parallel else None, None)


def logits_pspec(mesh) -> PartitionSpec:
    return PartitionSpec(batch_axes(mesh), None, "model")


def batch_pspec(mesh) -> PartitionSpec:
    return PartitionSpec(batch_axes(mesh), None)


def cache_pspecs(mesh, cache, *, seq_sharded: bool):
    """PartitionSpec tree for a ``models.model.Cache``.

    seq_sharded=True (long-context decode, batch < data shards): attention
    K/V caches split their *sequence* dim over the data axes and heads
    over model; otherwise the batch splits over data and heads over model.
    A leaf's kind is the last dict key above it.
    """
    bd = batch_axes(mesh)
    b_ax = None if seq_sharded else bd
    s_ax = bd if seq_sharded else None

    def spec_for(name, leaf):
        nd = leaf.ndim
        if name in ("k", "v", "mk", "mv"):          # (layers, B, S, KV, hd)
            return PartitionSpec(None, b_ax, s_ax, "model", None)
        if name == "ssm":                           # (layers, B, H, N, P)
            return PartitionSpec(None, None if seq_sharded else bd, "model", None, None)
        if name == "x":                             # conv state (layers, B, K-1, H*P)
            return PartitionSpec(None, b_ax, None, "model")
        if name == "bc":
            return PartitionSpec(None, b_ax, None, None)
        if nd == 1:                                 # lens (B,)
            return PartitionSpec(b_ax)
        return PartitionSpec(*([None] * nd))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {key: walk(sub, key) for key, sub in sorted(tree.items())}
        if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
            return type(tree)(*(walk(sub, name) for sub in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(sub, name) for sub in tree)
        return spec_for(name, tree)
    return walk(cache, None)


def to_shardings(mesh, pspec_tree):
    """Every spec of a tree as a :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), pspec_tree, is_leaf=is_pspec)


def distribute(x, sharding: NamedSharding, src_data_rank: int | None = 0):
    """``x`` as a DTensor laid out by ``sharding``: rank ``src_data_rank``'s
    copy scattered to the ranks, or with None every rank's own copy cut
    locally (no collective)."""
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=src_data_rank)


def batch_dim(mesh, spec: PartitionSpec):
    """The tensor dim that ``spec`` splits over the mesh's batch axes (the
    FSDP dim), or None."""
    bd = set(batch_axes(mesh))
    dims = [d for d, entry in enumerate(spec) if set(_mesh_axes(entry)) & bd]
    return dims[0] if dims else None


def local_block(x, sharding: NamedSharding, rank: int):
    """Rank ``rank``'s block of the full tensor ``x`` under ``sharding``,
    a contiguous copy (the full tensor can be freed), cut without a
    collective: along each tensor dim split over mesh axes, the block at
    the rank's coordinate along those axes (flattened in mesh order, the
    first major), as DTensor's ``Shard`` lays it out.  A dim the shards do
    not divide raises ``ValueError``."""
    mesh, spec = sharding.mesh, sharding.spec
    where = coordinate(mesh, rank)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = x
    for dim, entry in enumerate(spec):
        axes = _mesh_axes(entry)
        if not axes:
            continue
        shards, index = 1, 0
        for axis in axes:
            shards, index = shards * sizes[axis], index * sizes[axis] + where[axis]
        if x.shape[dim] % shards:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {shards} "
                             f"shards ({entry})")
        block = x.shape[dim] // shards
        out = out.narrow(dim, index * block, block)
    return out.clone()


def local_blocks(tree, shardings, rank: int):
    """:func:`local_block` of every leaf of ``tree``."""
    return tree_map(lambda x, s: local_block(x, s, rank), tree, shardings)
