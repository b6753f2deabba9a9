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

The ranks are those of ``group`` (None: the default process group), in
mesh order: the batch group of ``launch.mesh.mesh_groups``, so rank r of
the group holds the r-th rows and blocks along the flattened batch axes,
as JAX lays out a dim split over ("pod", "data").  Under a (2, 2) mesh the
batch group of model column 0 is ranks {0, 2}.  A group of one rank makes
no collective: every gather and sum is the tensor itself.

Serving (``launch/serve.py``) uses the same gathers for the FSDP-placed
weights.  With ``seq_sharded`` (the ``long_500k`` cache regime: a batch
smaller than the data shards) the ranks of the group hold the whole
batch, each its own block of the cache's positions, and decode attention
all-gathers its scores over the group (:meth:`DataParallel.gather_scores`)
and sums its P . V partials (:meth:`DataParallel.sum`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import moe as moe_mod


def _size(group) -> int:
    return dist.get_world_size(group)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward
    reduce-scatters (sums)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        world = _size(ctx.group)
        grad = grad.movedim(ctx.dim, 0).contiguous()
        out = grad.new_empty((grad.shape[0] // world,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient of every rank's input
    is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    return x if _size(group) == 1 else _AllReduce.apply(x, group)


def gather_forward(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """All-gather along ``dim`` with no backward (decode's scores)."""
    if _size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class DataParallel:
    """The collectives over a mesh's batch axes.  ``split_dims`` is a tree
    like the parameters' holding, per leaf, the dim split over the batch
    axes (None: replicated); ``group`` the batch axes' process group
    (None: the default group); ``seq_sharded`` marks a serving rank that
    holds the whole batch and its block of the cache's positions."""

    def __init__(self, split_dims, group=None, *, seq_sharded: bool = False):
        self.split_dims = split_dims
        self.group = group
        self.world = _size(group)
        self.rank = dist.get_rank(group)
        self.seq_sharded = seq_sharded

    def _gather_tree(self, tree, dims, shift: int):
        if isinstance(tree, dict):
            return {k: self._gather_tree(v, dims[k], shift) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._gather_tree(v, d, shift) for v, d in zip(tree, dims))
        return tree if dims is None else gather(tree, dims - shift, self.group)

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
        return all_reduce(x, self.group) / self.world

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group's ranks, the same bits on every rank."""
        return all_reduce(x, self.group)

    def gather_scores(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block along the last dim, in rank order (no
        gradient): a sequence-sharded decode's scores."""
        return gather_forward(x, -1, self.group)

    def moe(self, fn, x: torch.Tensor, seq_shards: int = 1):
        """``fn(x, group=, mean=None) -> (out, aux)`` (a bound
        ``models.moe.moe_ffn``) on the global batch's routing groups.
        With ``seq_sharded`` every rank holds the global batch: ``fn(x)``.
        ``seq_shards``: ``x`` holds one of that many blocks of the sequence
        (tensor parallelism's ``seq_parallel``; ``fn`` gathers them)."""
        if self.seq_sharded:
            return fn(x)
        b, s = x.shape[0], x.shape[1] * seq_shards
        group = min(moe_mod.GROUP, b * s * self.world)
        if (b * s) % group == 0:
            out, aux = fn(x, group=group, mean=self.mean)
        else:
            out, aux = fn(gather(x, 0, self.group), group=group)
            out = out[self.rank * b:(self.rank + 1) * b]
        return out, {k: v / self.world for k, v in aux.items()}
