"""Chunked, manifest-driven checkpoints with atomic commit and elastic
restore: the JAX package's ``checkpoint/chunked.py`` and its on-disk
format, so a checkpoint written by either package restores in the other.

Layout (one directory per step):

    ckpt_dir/
      step_00000120.tmp-<nonce>/   # staging (never read)
      step_00000120/
        manifest.json              # tree structure, shapes, chunking, step
        leaf<id>.c<k>.npy          # chunk k of leaf <id>

Leaves are numbered in ``jax.tree_util``'s order (:mod:`..tree`) and each
is split along axis 0 into ``chunks`` pieces; restore concatenates
whatever number of chunks it finds (elastic).  Chunks and manifest land
in a staging directory that is renamed into place (atomic on POSIX).
Leaves go through ``.cpu().numpy()``: float32, int32 and int8 leaves
(parameters, moments, Q8 codes, monitor counters, steps) round-trip; a
bfloat16 leaf, which numpy cannot hold, raises ``TypeError``.

A tree that holds DTensors (a train state on a mesh) is saved by every
rank of the default group together: each leaf is gathered whole
(``full_tensor()``, a collective, in leaf order on every rank), rank 0
writes the full arrays in the format above, and the other ranks wait at
a barrier until its rename has committed.  ``restore_checkpoint(
shardings=)`` gives each rank its block back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import platform
from ..launch.shardings import distribute
from ..tree import tree_flatten


@dataclasses.dataclass
class Manifest:
    step: int
    treedef: str
    leaves: list            # [{id, shape, dtype, chunks}]
    extra: dict

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        return cls(**json.loads(s))


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype; checkpoint float32 leaves")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, chunks: int = 4,
                    extra: dict | None = None, keep: int = 3) -> str:
    """Write ``tree`` (a tree of tensors or arrays) as a chunked
    checkpoint; returns its path.  A tree holding DTensors is written by
    rank 0 of the default group, every rank calling (module docstring)."""
    leaves, treedef = tree_flatten(tree)
    sharded = any(isinstance(leaf, DTensor) for leaf in leaves)
    writer = not sharded or dist.get_rank() == 0
    final = _step_dir(ckpt_dir, step)
    tmp = final + f".tmp-{secrets.token_hex(4)}"
    if writer:
        os.makedirs(tmp, exist_ok=True)

    manifest_leaves = []
    for i, leaf in enumerate(leaves):
        if not writer:
            if isinstance(leaf, DTensor):
                leaf.full_tensor()      # the gather every rank joins; rank 0 keeps it
            continue
        arr = _to_numpy(leaf)
        nchunks = min(chunks, arr.shape[0]) if arr.ndim > 0 else 1
        bounds = np.array_split(np.arange(arr.shape[0] if arr.ndim else 1), nchunks)
        for k, idx in enumerate(bounds):
            part = arr[idx[0]:idx[-1] + 1] if arr.ndim else arr
            np.save(os.path.join(tmp, f"leaf{i:05d}.c{k}.npy"), part)
        manifest_leaves.append({"id": i, "shape": list(arr.shape),
                                "dtype": str(arr.dtype), "chunks": nchunks})

    if writer:
        man = Manifest(step=step, treedef=repr(treedef), leaves=manifest_leaves,
                       extra=extra or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(man.to_json())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        _gc(ckpt_dir, keep)
    if sharded:
        dist.barrier()                 # no rank reads the directory before the commit
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # stale staging dirs from crashed writers
    for d in os.listdir(ckpt_dir):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and ".tmp" not in d
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template, *, step: int | None = None, device=None,
                       shardings=None):
    """Rebuild the tree.  ``template`` fixes the structure (and each
    leaf's shape); the chunk count on disk is independent of it
    (elastic).  Leaves become tensors on ``device``; None places each on
    its template leaf's device, or on the CUDA card where the template
    leaf is not a tensor.  With ``shardings`` (a matching tree of
    ``launch.shardings.NamedSharding``, or None at a leaf) each such leaf
    becomes a DTensor on its mesh, every rank keeping its own block of the
    array it read (resharding on restore).  Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        man = Manifest.from_json(f.read())

    leaves_t, treedef = tree_flatten(template)
    if len(leaves_t) != len(man.leaves):
        raise ValueError(f"template has {len(leaves_t)} leaves, checkpoint {len(man.leaves)}")
    shard_leaves = (treedef.flatten_up_to(shardings) if shardings is not None
                    else [None] * len(leaves_t))

    out = []
    for meta, tmpl, shd in zip(man.leaves, leaves_t, shard_leaves):
        parts = [np.load(os.path.join(d, f"leaf{meta['id']:05d}.c{k}.npy"))
                 for k in range(meta["chunks"])]
        arr = (parts[0] if len(parts) == 1 and not meta["shape"]
               else np.concatenate(parts, axis=0))
        arr = arr.reshape(meta["shape"]).astype(meta["dtype"])
        expect = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {meta['id']}: checkpoint shape {arr.shape}, "
                             f"template {expect}")
        where = (torch.device(device) if device is not None
                 else tmpl.device if isinstance(tmpl, torch.Tensor)
                 else platform.default_device())
        leaf = torch.from_numpy(np.array(arr, order="C")).to(where)
        if shd is not None:
            leaf = distribute(leaf, shd, src_data_rank=None)
        out.append(leaf)
    return treedef.unflatten(out), man
