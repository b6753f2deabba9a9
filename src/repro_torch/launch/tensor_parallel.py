"""Tensor parallelism over a mesh's ``model`` axis: the collectives that
the JAX package's GSPMD inserts at the TP boundaries of a sharded
program, written out (as ``launch/data_parallel.py`` writes out the batch
axes' ones).

Each rank of the model group holds its block of every leaf split over
``model`` by ``launch/shardings.py``: a contiguous block of the attention
heads and KV heads, of the ``d_ff`` columns, of the vocabulary, of the
experts and of the SSM heads.  The model runs on those blocks
(``models/``, ``tp=``) and calls back here:

* :meth:`TensorParallel.copy` is Megatron's *f*: the identity forward, an
  all-reduce of the gradient backward.  It marks the replicated
  activations entering a column-parallel product (q/k/v, ``w_gate`` and
  ``w_up``, the router and the experts, the SSM projections, the logits).
* :meth:`TensorParallel.reduce` is Megatron's *g*: an all-reduce forward,
  the identity backward.  It sums the partial outputs of a row-parallel
  product (``wo``, ``w_down``, the experts' combine) into the replicated
  activation.
* :meth:`TensorParallel.embed`: a vocab-parallel lookup.  Each rank looks
  up the ids of its vocabulary range and writes zeros elsewhere, then the
  group sums; one non-zero term plus zeros is exact, so the lookup equals
  the one-process table's bit for bit.
* :meth:`TensorParallel.gather`: an all-gather along a dim -- the router
  logits of the rank's experts (every rank then routes on all E experts),
  and the last-token logits' vocabulary blocks.

A group of one rank makes no collective: every method is the identity.
All-reduce and all-gather give the same bits on every rank (gloo and NCCL
alike), so the replicated activations stay equal across the group;
``check=True`` holds them to that once a layer
(:meth:`TensorParallel.check_replicated`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# Replicated activations held equal across a model group by
# ``check_replicated`` in this process.
checks = 0


class _Copy(torch.autograd.Function):
    """*f*: identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """*g*: all-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps the rank's own block
    of the gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        size = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.block = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None


def same_on_every_rank(parts) -> bool:
    """Whether the ranks' copies of a replicated tensor are equal bit for
    bit (a signed zero or a NaN's payload counts)."""
    first = parts[0].contiguous().view(torch.uint8)
    return all(torch.equal(first, p.contiguous().view(torch.uint8)) for p in parts[1:])


class TensorParallel:
    """The model axis's collectives for one rank.  ``group`` is the
    model group of ``launch.mesh.mesh_groups`` (None: the default group)."""

    def __init__(self, group=None, *, check: bool = False):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.check = check

    def block(self, n: int) -> tuple[int, int]:
        """(first index, count) of this rank's contiguous block of ``n``
        (heads, experts, vocabulary rows); raises ``ValueError`` unless the
        group's size divides ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over a model axis of {self.size}")
        return self.rank * (n // self.size), n // self.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _GatherDim.apply(x, dim, self.group)

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the full table for ``ids``, from this rank's block of
        its rows (``table``, (V / size, d)): the block's ids looked up,
        zeros elsewhere, summed over the group."""
        if self.size == 1:
            return table[ids]
        start = self.rank * table.shape[0]
        local = ids - start
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(inside, local, 0)]
        return self.reduce(torch.where(inside[..., None], rows, 0.0))

    def check_replicated(self, x: torch.Tensor, what: str) -> None:
        """With ``check``: raise unless ``x`` is the same, bit for bit, on
        every rank of the group."""
        if not self.check or self.size == 1:
            return
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        if not same_on_every_rank(parts):
            raise RuntimeError(f"{what}: a replicated activation differs across the model "
                               f"group")
        global checks
        checks += 1
