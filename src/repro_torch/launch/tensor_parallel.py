"""Tensor parallelism over a mesh's ``model`` axis: the collectives that
the JAX package's GSPMD inserts at the TP boundaries of a sharded
program, written out (as ``launch/data_parallel.py`` writes out the batch
axes' ones), forward and backward.

Each rank of the model group holds its block of every leaf split over
``model`` by ``launch/shardings.py``: a contiguous block of the attention
heads and KV heads, of the ``d_ff`` columns, of the vocabulary, of the
experts and of the SSM heads.  The model runs on those blocks
(``models/``, ``tp=``) and calls back here:

* :meth:`TensorParallel.copy` enters a column-parallel product (q/k/v,
  ``w_gate`` and ``w_up``, the router and the experts, the SSM
  projections, the logits).  It is Megatron's *f*: the identity forward,
  an all-reduce of the gradient backward, so the replicated activation's
  gradient is the sum of the ranks' partial ones.
* :meth:`TensorParallel.reduce` leaves a row-parallel product (``wo``,
  ``w_down``, the experts' combine).  It is Megatron's *g*: an all-reduce
  of the partial outputs forward, the identity backward.
* With ``seq_parallel`` (Megatron-SP, the JAX package's
  ``activation_pspec(seq_parallel=True)``) the activations between blocks
  are the rank's block of the sequence: norms and residual adds run on
  S / tp tokens.  Then :meth:`copy` all-gathers along S (its backward
  reduce-scatters: the sum of the partials, the rank's block kept) and
  :meth:`reduce` reduce-scatters along S (its backward all-gathers).
* :meth:`TensorParallel.sum_grads` is *f* and :meth:`all_reduce` is *g*
  whatever the mode.  The first marks an activation that every rank
  computes whole but whose gradient each rank gets only in part: the MoE
  router's probabilities (``models/moe.py``; each rank's combine reads
  its own experts).  The second sums per-token partials over the
  vocabulary blocks in the loss (``models.model.lm_loss``).
* :meth:`TensorParallel.embed`: a vocab-parallel lookup.  Each rank looks
  up the ids of its vocabulary range and writes zeros elsewhere, then the
  group sums (:meth:`reduce`); one non-zero term plus zeros is exact, so
  the lookup equals the one-process table's bit for bit.
* :meth:`TensorParallel.gather`: an all-gather along a dim whose backward
  keeps the rank's block of the gradient.  That is right only where every
  rank receives the same gradient: the router logits of the rank's
  experts (every rank routes on all E; the partial gradients are summed
  before, by :meth:`sum_grads`) and serving's last-token logits.  The
  training loss takes the vocabulary blocks with no gather
  (``models.model.lm_loss``).

A group of one rank makes no collective: every method is the identity.
All-reduce, all-gather and reduce-scatter give the same bits on every
rank (gloo and NCCL alike), so the replicated activations stay equal
across the group; ``check=True`` holds them to that once a layer, and
the gradient arriving at each layer's output too
(:meth:`check_replicated`, :meth:`check_grad`).  Under ``seq_parallel``
the activations between blocks are not replicated, so nothing is checked.

Every rank issues the same collectives in the same order: the model code
takes no data-dependent branch around a call here, and a layer that remat
recomputes in the backward reruns its forward collectives on every rank.
A rank that skipped one would hang the group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .data_parallel import gather as _gather_summing

# Replicated activations (and their gradients) held equal across a model
# group by ``check_replicated`` in this process.
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


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps the rank's own block
    of the gradient (every rank must receive the same gradient)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.rank, ctx.block = dim, dist.get_rank(group), x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the group, each rank keeping its block along ``dim``;
    the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        size = dist.get_world_size(group)
        if x.shape[dim] % size:
            raise ValueError(f"a dim of {x.shape[dim]} does not split over {size} ranks")
        full = x.movedim(dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // size,) + tuple(full.shape[1:]))
        dist.reduce_scatter_tensor(out, full, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


def same_on_every_rank(parts) -> bool:
    """Whether the ranks' copies of a replicated tensor are equal bit for
    bit (a signed zero or a NaN's payload counts)."""
    first = parts[0].contiguous().view(torch.uint8)
    return all(torch.equal(first, p.contiguous().view(torch.uint8)) for p in parts[1:])


class TensorParallel:
    """The model axis's collectives for one rank.  ``group`` is the
    model group of ``launch.mesh.mesh_groups`` (None: the default group);
    ``seq_parallel`` splits the sequence (dim 1 of a (B, S, d) activation)
    over the group between blocks (module docstring)."""

    def __init__(self, group=None, *, check: bool = False, seq_parallel: bool = False):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.check = check
        self.seq_parallel = seq_parallel

    @property
    def seq_shards(self) -> int:
        """The blocks the sequence is split into between blocks."""
        return self.size if self.seq_parallel else 1

    def block(self, n: int) -> tuple[int, int]:
        """(first index, count) of this rank's contiguous block of ``n``
        (heads, experts, vocabulary rows, sequence positions); raises
        ``ValueError`` unless the group's size divides ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over a model axis of {self.size}")
        return self.rank * (n // self.size), n // self.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        if self.seq_parallel:
            return _gather_summing(x, 1, self.group)
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        if self.seq_parallel:
            return _ReduceScatter.apply(x, 1, self.group)
        return _Reduce.apply(x, self.group)

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        """*f* in either mode: identity forward, the gradient all-reduced."""
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """*g* in either mode: the sum forward, identity backward."""
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _GatherDim.apply(x, dim, self.group)

    def seq_block(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of a model input's sequence (dim 1) under
        ``seq_parallel``; else ``x``."""
        if self.seq_shards == 1:
            return x
        first, count = self.block(x.shape[1])
        return x.narrow(1, first, count)

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the full table for ``ids``, from this rank's block of
        its rows (``table``, (V / size, d)): the block's ids looked up,
        zeros elsewhere, summed over the group (under ``seq_parallel``
        the rank keeps its block of the sequence)."""
        if self.size == 1:
            return table[ids]
        start = self.rank * table.shape[0]
        local = ids - start
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(inside, local, 0)]
        return self.reduce(torch.where(inside[..., None], rows, 0.0))

    def check_replicated(self, x: torch.Tensor, what: str) -> None:
        """With ``check``: raise unless ``x`` is the same, bit for bit, on
        every rank of the group (nothing under ``seq_parallel``)."""
        if not self.check or self.size == 1 or self.seq_parallel:
            return
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.group)
        if not same_on_every_rank(parts):
            raise RuntimeError(f"{what}: a replicated activation differs across the model "
                               f"group")
        global checks
        checks += 1

    def check_grad(self, x: torch.Tensor, what: str) -> None:
        """With ``check``: the gradient that reaches ``x`` in the backward
        (the sum of the residual's and of the next block's *f*) is held
        to :meth:`check_replicated`.  Every rank registers the hook, so
        the check's all-gather runs on every rank at the same point of
        the backward."""
        if self.check and self.size > 1 and not self.seq_parallel and x.requires_grad:
            x.register_hook(lambda g: self.check_replicated(g, f"the gradient of {what}"))
