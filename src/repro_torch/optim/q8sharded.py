"""Q8Adam with rank-local int8 moments (ZeRO-style), the JAX package's
``optim/q8sharded.py``.

Each rank dequantizes, updates and requantizes only its own block of
every parameter: no collective inside the update (the gradients arrive
reduced; the global-norm clip, over the whole tree, is the one exchange).
The quantization runs over the rank's local block, so the int8 codes of
a leaf are (ranks * local blocks, 256) with dim 0 split over every mesh
axis (:func:`state_pspecs`): 2.03 B per parameter of optimizer memory on
any topology.

Parameters are DTensors placed by ``launch.shardings.param_pspecs`` (or
plain tensors: the whole leaf is then the local block, as on a one-rank
mesh).  The moments of a DTensor parameter are DTensors over the same
mesh, ``Shard(0)`` on every mesh dim.  Stochastic rounding draws from
``rkey = fold_in(PRNGKey(seed), step)`` (the step before this update):
leaf i's moments take ``fold_in(rkey, 2*i)`` and ``fold_in(rkey, 2*i + 1)``,
the same key on every rank, over the local block's shape.  Parameters are
updated in place, as ``make_q8adam``'s are.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from ..core import prng
from ..launch.shardings import PartitionSpec, is_pspec, to_placements
from ..tree import tree_flatten, tree_map
from .adamw import Optimizer, _clip_in_place, _scalars, bias_corrections, local
from .q8adam import Q8State, QTensor, dequantize, dequantize_v, quantize, quantize_v

__all__ = ["Q8State", "state_pspecs", "make_q8adam_sharded"]


def _all_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def state_pspecs(mesh, param_pspecs):
    """PartitionSpec tree of the Q8 state mirroring a param spec tree."""
    qspec = QTensor(codes=PartitionSpec(_all_axes(mesh), None),
                    scales=PartitionSpec(_all_axes(mesh), None))
    return Q8State(step=PartitionSpec(),
                   m=tree_map(lambda _: qspec, param_pspecs, is_leaf=is_pspec),
                   v=tree_map(lambda _: qspec, param_pspecs, is_leaf=is_pspec))


def _like(p, qt: QTensor) -> QTensor:
    """A local QTensor as the moment of parameter ``p``: DTensors split
    over every mesh dim where ``p`` is a DTensor."""
    if not isinstance(p, DTensor):
        return qt
    placements = [Shard(0)] * p.device_mesh.ndim
    return QTensor(*(DTensor.from_local(x, p.device_mesh, placements, run_check=False)
                     for x in qt))


def make_q8adam_sharded(mesh, lr_fn, param_pspecs, *, b1: float = 0.9, b2: float = 0.95,
                        eps: float = 1e-8, weight_decay: float = 0.1, clip_norm: float = 1.0,
                        seed: int = 23) -> Optimizer:
    """Q8Adam over ``mesh``; ``param_pspecs`` is the parameters' spec tree,
    which ``init`` holds their DTensor placements to."""

    def init(params):
        leaves, treedef = tree_flatten(params)
        for p, spec in zip(leaves, treedef.flatten_up_to(param_pspecs)):
            if isinstance(p, DTensor) and tuple(p.placements) != to_placements(mesh, spec):
                raise ValueError(f"a parameter placed {p.placements} where its spec is {spec}")
        device = local(leaves[0]).device if leaves else None
        zeros = lambda p: torch.zeros(local(p).shape, dtype=torch.float32, device=local(p).device)
        return Q8State(step=torch.zeros((), dtype=torch.int32, device=device),
                       m=tree_map(lambda p: _like(p, quantize(zeros(p))), params),
                       v=tree_map(lambda p: _like(p, quantize_v(zeros(p))), params))

    @torch.no_grad()
    def update(grads, state: Q8State, params):
        leaves, treedef = tree_flatten(params)
        gl = [local(g).to(torch.float32).contiguous() for g in treedef.flatten_up_to(grads)]
        ml = treedef.flatten_up_to(state.m)
        vl = treedef.flatten_up_to(state.v)
        gnorm = _clip_in_place(gl, clip_norm, leaves)
        prev = local(state.step)
        step = prev + 1
        lr = lr_fn(step).to(step.device)
        bc1, bc2 = _scalars(step.device, *bias_corrections(int(step), b1, b2))
        rkey = prng.fold_in(prng.PRNGKey(seed), int(prev))
        new_m, new_v = [], []
        for i, (p, g, mq, vq) in enumerate(zip(leaves, gl, ml, vl)):
            pl = local(p)
            m = dequantize(QTensor(*map(local, mq)), pl.shape) * b1 + g * (1 - b1)
            v = dequantize_v(QTensor(*map(local, vq)), pl.shape) * b2 + g * (1 - b2) * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.ndim > 1:
                delta = delta + pl.to(torch.float32) * weight_decay
            pl.sub_((delta * lr).to(pl.dtype))
            new_m.append(_like(p, quantize(m, prng.fold_in(rkey, 2 * i))))
            new_v.append(_like(p, quantize_v(v, prng.fold_in(rkey, 2 * i + 1))))
        return (params, Q8State(step, treedef.unflatten(new_m), treedef.unflatten(new_v)),
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init=init, update=update)
