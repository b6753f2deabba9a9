"""Data parallelism over a mesh's batch axes: the collectives that the
JAX package's GSPMD inserts into a sharded train step, written out.

Each rank holds its own block of every parameter split over the batch
axes (``launch.shardings``: the "embed"/"embed_out" dim) and its own rows
of the batch.  The model's forward (``models.model.forward(..., dp=)``)
calls back here:

* :meth:`DataParallel.gather_top` and :meth:`gather_layer` all-gather a
  leaf's blocks along its split dim just before use -- the top-level
  leaves once, a layer's when the layer runs (inside its remat region, so
  a recomputed layer gathers again).  The gather's backward
  reduce-scatters the gradient, so each rank's gradient of its block is
  the sum over ranks.
* :meth:`DataParallel.moe` runs an MoE layer on the global batch's
  routing groups (``min(GROUP, B * S)`` tokens): where a rank's tokens are
  whole groups, locally with the load-balance and router-z means taken
  over the ranks; where a group spans ranks, on the all-gathered tokens,
  every rank keeping its own rows.  Either way the aux losses are the
  global batch's, and each rank adds ``1 / ranks`` of them to its loss.

The ranks are the default process group's, in mesh order (the mesh spans
the world, its model axis 1), so rank r's rows and blocks are the r-th
along the flattened batch axes, as JAX lays out a dim split over
("pod", "data").
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import moe as moe_mod


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (sums)."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        world = dist.get_world_size()
        grad = grad.movedim(ctx.dim, 0).contiguous()
        out = grad.new_empty((grad.shape[0] // world,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad)
        return out.movedim(0, ctx.dim), None


class _AllReduce(torch.autograd.Function):
    """Sum over ranks; the gradient of every rank's input is the sum of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    return _AllReduce.apply(x)


class DataParallel:
    """The collectives of one data-parallel train step.  ``split_dims`` is
    a tree like the parameters' holding, per leaf, the dim split over the
    batch axes (None: replicated)."""

    def __init__(self, split_dims):
        self.split_dims = split_dims
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()

    def _gather_tree(self, tree, dims, shift: int):
        if isinstance(tree, dict):
            return {k: self._gather_tree(v, dims[k], shift) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._gather_tree(v, d, shift) for v, d in zip(tree, dims))
        return tree if dims is None else gather(tree, dims - shift)

    def gather_top(self, params: dict) -> dict:
        """Every leaf outside the stacked layers, gathered."""
        out = dict(params)
        for key in ("embed", "final_norm", "lm_head"):
            if key in params:
                out[key] = self._gather_tree(params[key], self.split_dims[key], 0)
        if "encoder" in params:
            out["encoder"] = dict(params["encoder"], norm=self._gather_tree(
                params["encoder"]["norm"], self.split_dims["encoder"]["norm"], 0))
        return out

    def gather_layer(self, layer, path: tuple):
        """One layer of the stack at ``path`` (("groups", i) or
        ("encoder", "layers")), its leaves unstacked, gathered."""
        dims = self.split_dims
        for key in path:
            dims = dims[key]
        return self._gather_tree(layer, dims, 1)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of equal-sized per-rank means."""
        return all_reduce(x) / self.world

    def moe(self, fn, x: torch.Tensor):
        """``fn(x, group=, mean=None) -> (out, aux)`` (a bound
        ``models.moe.moe_ffn``) on the global batch's routing groups."""
        b, s, _ = x.shape
        group = min(moe_mod.GROUP, b * s * self.world)
        if (b * s) % group == 0:
            out, aux = fn(x, group=group, mean=self.mean)
        else:
            out, aux = fn(gather(x, 0), group=group)
            out = out[self.rank * b:(self.rank + 1) * b]
        return out, {k: v / self.world for k, v in aux.items()}
