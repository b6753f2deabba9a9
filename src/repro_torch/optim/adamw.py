"""AdamW with decoupled weight decay and global-norm clipping.

The JAX package's ``optim/adamw.py``: an (init, update) pair, so the
train step can take Q8Adam (int8 moments) instead; moments are float32
trees mirroring the parameters, walked in ``jax.tree_util``'s leaf order
(:mod:`..tree`).

One difference in form: ``update`` writes the new parameters and moments
**into the given tensors** and returns those same tensors (the JAX
package returns new arrays).  At qwen2.5-3b's width a second copy of the
parameters and moments (37 GB) would not fit on the card beside the
first; the elementwise update runs in slices of :data:`CHUNK` elements,
so its temporaries stay small.  A caller that needs the old values keeps
a copy.  The step's learning rate and bias corrections are host float32
scalars computed as XLA computes them (``_libm``), placed on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..tree import tree_flatten, tree_map
from ._libm import powf

CHUNK = 1 << 25         # elements per slice of the elementwise update
NORM_CHUNK = 1 << 25    # elements per partial sum of a leaf's squares


class Optimizer(NamedTuple):
    init: Callable        # params -> opt_state
    update: Callable      # (grads, opt_state, params) -> (new_params, new_state, stats)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def _slices(n: int, size: int | None = None):
    size = size or CHUNK
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def _flat(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"optimizer leaves must be contiguous, got strides {x.stride()}")
    return x.view(-1)


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    flat = x.to(torch.float32).reshape(-1)
    parts = [torch.sum(torch.square(flat[sl])) for sl in _slices(flat.numel(), NORM_CHUNK)]
    total = parts[0] if parts else torch.zeros((), dtype=torch.float32, device=x.device)
    for part in parts[1:]:
        total = total + part
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of their squares."""
    leaves, _ = tree_flatten(tree)
    return torch.sqrt(sum(_square_sum(leaf) for leaf in leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, tree), norm


def local(x):
    """A rank's own block of a DTensor (a view: in-place updates reach
    it); a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _split_dims(p) -> list[bool]:
    return [isinstance(pl, Shard) for pl in p.placements]


def square_sums(params: list, grads: list) -> list[torch.Tensor]:
    """Each gradient leaf's sum of squares over its whole tensor.  ``grads``
    are the ranks' own blocks of ``params``' leaves: where a parameter is a
    DTensor split over mesh dims, the blocks' partial sums are added over
    those dims' groups (one ``all_reduce`` of all leaves' sums a dim)."""
    sums = [_square_sum(g) for g in grads]
    meshes = {p.device_mesh for p in params if isinstance(p, DTensor) and any(_split_dims(p))}
    if not meshes:
        return sums
    if len(meshes) > 1:
        raise ValueError("the parameters lie on more than one mesh")
    mesh = meshes.pop()
    vec = torch.stack(sums)
    for dim in range(mesh.ndim):
        if mesh.size(dim) == 1:
            continue
        split = torch.tensor([isinstance(p, DTensor) and _split_dims(p)[dim] for p in params],
                             device=vec.device)
        # a leaf replicated over this dim counts once: rank 0's copy
        vec = torch.where(split | (mesh.get_local_rank(dim) == 0), vec, 0.0)
        dist.all_reduce(vec, group=mesh.get_group(dim))
    return list(vec.unbind())


def _clip_in_place(grads: list, max_norm: float, params: list) -> torch.Tensor:
    norm = torch.sqrt(sum(square_sums(params, grads)))
    scale = _clip_scale(norm, max_norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _scalars(device, *values) -> list[torch.Tensor]:
    """Host float32 scalars as 0-d tensors on ``device`` (a tensor, not a
    CPU scalar: CUDA turns a division by a CPU scalar into a product with
    its reciprocal)."""
    return [torch.tensor(np.float32(v), dtype=torch.float32, device=device) for v in values]


def bias_corrections(step: int, b1: float, b2: float) -> tuple[np.float32, np.float32]:
    """``1 - b ** step`` in float32 for both betas, as XLA computes it."""
    return (np.float32(1.0) - powf(b1, np.float32(step)),
            np.float32(1.0) - powf(b2, np.float32(step)))


def make_adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    """lr_fn: step (int32 tensor) -> learning rate (float32 scalar tensor)."""

    def init(params):
        leaves, _ = tree_flatten(params)
        device = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        leaves, treedef = tree_flatten(params)
        gl = [local(g).to(torch.float32).contiguous() for g in treedef.flatten_up_to(grads)]
        ml = treedef.flatten_up_to(state.m)
        vl = treedef.flatten_up_to(state.v)
        gnorm = _clip_in_place(gl, clip_norm, leaves)
        step = local(state.step) + 1
        lr = lr_fn(step).to(step.device)
        bc1, bc2 = _scalars(step.device, *bias_corrections(int(step), b1, b2))
        for p, g, m, v in zip(leaves, gl, ml, vl):
            pf, gf, mf, vf = _flat(local(p)), _flat(g), _flat(local(m)), _flat(local(v))
            for sl in _slices(pf.numel()):
                gs, ms, vs, ps = gf[sl], mf[sl], vf[sl], pf[sl]
                ms.mul_(b1).add_(gs * (1 - b1))
                vs.mul_(b2).add_(gs * (1 - b2) * gs)
                delta = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
                if p.ndim > 1:           # no decay on unstacked norms and biases
                    delta.add_(ps.to(torch.float32) * weight_decay)
                ps.sub_((delta.mul_(lr)).to(p.dtype))
        return (params, AdamWState(step, state.m, state.v),
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init=init, update=update)
