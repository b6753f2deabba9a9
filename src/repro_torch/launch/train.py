"""The train step: forward and backward, the optimizer, and the SJPC
stream monitor.

The JAX package's ``launch/train.py``.  ``make_train_step(cfg, dims,
optimizer, mesh=None, ...)`` returns ``step_fn(state, batch) -> (state,
metrics)``, which the fault-tolerant driver (``runtime/driver.py``) and
``examples/train_lm_sketch_torch.py`` run.  Gradients come from
``torch.autograd`` on the float32 parameter leaves (cast to
``compute_dtype`` inside ``models.model.forward``); the optimizer updates
the parameters and moments in place (``optim/adamw.py``).  The monitor's
records go through ``sjpc.update`` with ``kernels.ops.make_sjpc_update_fn``
as its scatter, so on the card each update launches the ``sample_weights``
kernel once and the ``fingerprint`` and ``sketch_update`` kernels once per
lattice level.

With a ``mesh`` (``launch/mesh.py``: (data, model) or (pod, data, model))
the step is one rank's part of the function the meshless step computes,
at the same ``Dims`` (``compute_dims(cfg, tp=<model axis size>)``), as
GSPMD splits the JAX package's jitted step:

* the state's parameters and moments are DTensors in
  :func:`state_shardings`'s layout (the one serving under a mesh reads):
  "embed" dims split over the batch axes, gathered one layer at a time by
  ``launch/data_parallel.py`` (FSDP; the gathers' backward
  reduce-scatters), and heads, KV heads, ``d_ff``, the vocabulary,
  experts and SSM heads split over ``model``, run by
  ``launch/tensor_parallel.py`` (Megatron's *f*/*g*, the vocab-parallel
  loss; with ``seq_parallel`` the sequence is split over ``model``
  between blocks);
* the batch is the rank's own rows along the batch axes; the ranks of a
  model group hold the same rows;
* loss and gradients are the global batch's: each rank's token mean is
  weighted by its share of the batch group's token count, and each
  gradient leaf is summed over the groups :func:`grad_sums` names;
* loss, total loss, the MoE aux losses and ``grad_norm`` are the same
  bits on every rank;
* the monitor's merged mode (one shard of counters) all-gathers the
  token ids over the batch group and updates every rank's copy with the
  whole batch; its deferred mode (one shard per batch rank, replicated
  over ``model``) updates each rank's block with its own rows and no
  collective, the ranks of a model group identical blocks.

A group of one rank makes no collective, so on a (1, 1) mesh the step
equals the meshless one bit for bit.  Every rank issues the same
collectives in the same order: the step's sums walk the leaves in tree
order on every rank, and a leaf with no gradient is summed as zeros.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import platform
from ..kernels import ops
from ..models import model as M
from ..models.config import ArchConfig, Dims
from ..optim.adamw import AdamWState, Optimizer, local
from ..sketchstream.monitor import (MonitorState, SketchMonitorConfig, init_monitor,
                                    monitor_update_local)
from ..tree import tree_flatten, tree_map
from . import shardings as SH
from .data_parallel import DataParallel
from .mesh import axis_size, batch_axes, mesh_groups
from .tensor_parallel import TensorParallel


class TrainState(NamedTuple):
    params: Any
    opt: Any
    monitor: Any            # MonitorState | None
    step: torch.Tensor      # () int32


MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001


def _check_mesh(mesh, dims: Dims) -> None:
    if dims.tp != axis_size(mesh, "model"):
        raise ValueError(f"Dims built for tp={dims.tp} on a model axis of "
                         f"{axis_size(mesh, 'model')}: use compute_dims(cfg, "
                         f"tp={axis_size(mesh, 'model')})")
    if math.prod(mesh.shape) != dist.get_world_size():
        raise ValueError(f"the mesh's {math.prod(mesh.shape)} ranks are not the "
                         f"{dist.get_world_size()} ranks of the default group")


# Logical axes of the leaves replicated over ``model`` whose gradient is a
# per-rank partial whatever the mode: mamba's ``wB``, ``wC`` and
# ``conv_bc`` make B and C for every group, and each rank reads only its
# heads' groups (``models.ssm._rank_groups``).
PARTIAL_OVER_MODEL = ("ssm_group", "conv_ch")


def grad_sums(spec, axes: tuple, batch: tuple, *, seq_parallel: bool = False
              ) -> tuple[bool, bool]:
    """Whether a leaf's gradient is summed over the batch group and over
    the model group after the backward: ``spec`` is the leaf's
    ``PartitionSpec`` (mesh axes), ``axes`` its logical axes (how the
    model uses it) and ``batch`` the mesh's batch axes.

    * Over the batch group, unless the leaf is split over a batch axis:
      then its FSDP gather's reduce-scatter has summed it already.
    * Over the model group never where the leaf is split over ``model``
      (its gradient is its block's).  A leaf replicated over ``model`` is
      summed only where its gradient is a per-rank partial: the SSM's B/C
      projections (:data:`PARTIAL_OVER_MODEL`), and under
      ``seq_parallel`` the norms, which then see the rank's block of the
      sequence alone.  Otherwise the norms' gradients are whole on every
      rank, since *f*'s backward summed the activation's gradient; a sum
      would multiply them by tp."""
    split = {a for entry in spec for a in SH._mesh_axes(entry)}
    over_batch = not split & set(batch)
    if "model" in split:
        return over_batch, False
    partial = (any(a in PARTIAL_OVER_MODEL for a in axes)
               or (seq_parallel and "norm" in axes))
    return over_batch, partial


def _rewrap(like, value):
    """``value`` (a rank's block) as a DTensor laid out as ``like``."""
    if not isinstance(like, DTensor):
        return value
    return DTensor.from_local(value, like.device_mesh, like.placements, run_check=False)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``group``, in rank order (no gradient)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _MeshPlan(NamedTuple):
    """What a step on a mesh needs beside the state: the groups, the FSDP
    dim of every leaf and each leaf's :func:`grad_sums`."""
    groups: Any
    split: list
    sums: list


def _mesh_plan(mesh, cfg: ArchConfig, dims: Dims, seq_parallel: bool) -> _MeshPlan:
    axes = M.param_axes(M.init_params(torch.Generator(), cfg, dims, device="meta"))
    specs = tree_flatten(SH.param_pspecs(mesh, axes), is_leaf=SH.is_pspec)[0]
    axes = tree_flatten(axes, is_leaf=lambda x: isinstance(x, tuple)
                        and all(isinstance(a, str) for a in x))[0]
    bd = batch_axes(mesh)
    return _MeshPlan(mesh_groups(mesh), [SH.batch_dim(mesh, spec) for spec in specs],
                     [grad_sums(spec, ax, bd, seq_parallel=seq_parallel)
                      for spec, ax in zip(specs, axes)])


def make_train_step(cfg: ArchConfig, dims: Dims, optimizer: Optimizer, mesh=None, *,
                    monitor_cfg: SketchMonitorConfig | None = None, monitor_params=None,
                    remat: str = "full", ssm_chunk: int = 128, attn_chunk: int = 2048,
                    compute_dtype=torch.bfloat16, seq_parallel: bool = False,
                    probs_dtype=torch.float32, impl: str | None = None,
                    check_replicated: bool = False):
    """Returns step_fn(state, batch) -> (state, metrics).

    ``batch`` holds ``tokens`` and ``labels`` (B, S), optionally ``mask``
    and an encoder-decoder's ``enc_feats``; tensors on the state's device
    or numpy arrays.  With a ``mesh`` they are this rank's rows of the
    global batch (rank r of the batch group holds the r-th of
    ``data_shards`` equal slices, whatever its model coordinate), the
    state comes from ``make_train_state(..., mesh=mesh)``, and ``dims``
    must be ``compute_dims(cfg, tp=<model axis size>)`` (else
    ``ValueError``); ``seq_parallel`` splits the sequence over ``model``
    between blocks (the tokens' S a multiple of the model axis), and
    ``check_replicated`` holds every layer's output and its gradient
    equal across the model group, bit for bit (the module docstring).
    ``impl`` names the implementation of the kernel ops the step runs
    (the monitor's, and flash attention's forward and backward above
    ``CHUNKED_THRESHOLD``); None goes by the device.  The returned state
    holds the input state's parameter and moment tensors, updated."""
    plan = None
    if mesh is not None:
        _check_mesh(mesh, dims)
        plan = _mesh_plan(mesh, cfg, dims, seq_parallel)
    elif seq_parallel:
        raise ValueError("seq_parallel splits the sequence over a mesh's model axis")
    update_fn = ops.make_sjpc_update_fn(impl=impl)

    def loss_fn(params, batch, dp, tp):
        logits, aux = M.forward(params, cfg, dims, batch["tokens"],
                                enc_feats=batch.get("enc_feats"), compute_dtype=compute_dtype,
                                remat=remat, ssm_chunk=ssm_chunk, attn_chunk=attn_chunk,
                                probs_dtype=probs_dtype, impl=impl, dp=dp, tp=tp)
        mask = batch.get("mask")
        loss = M.lm_loss(logits, batch["labels"], cfg.vocab_size, mask=mask, tp=tp)
        if dp is not None and dp.world > 1:
            # this rank's share of the global token mean (the ranks of a
            # model group hold the same rows, so the batch group's count)
            count = (torch.as_tensor(mask, device=logits.device).to(torch.float32).sum()
                     if mask is not None else
                     torch.tensor(float(logits.shape[0] * logits.shape[1]),
                                  device=logits.device))
            total_count = count.clone()
            dist.all_reduce(total_count, group=dp.group)
            loss = loss * (count / total_count)
        total = loss
        if cfg.num_experts:
            total = (total + MOE_LB_WEIGHT * aux["moe_lb_loss"]
                     + MOE_Z_WEIGHT * aux["moe_z_loss"])
        return total, (loss, aux)

    def update_monitor(monitor: MonitorState, tokens, step):
        if monitor_cfg is None:
            return monitor
        counters, n = local(monitor.counters), local(monitor.n)
        if mesh is not None:
            tokens = torch.as_tensor(tokens, device=counters.device)
            if monitor.counters.shape[0] == 1:
                # the merged mode: the whole global batch into every rank's copy
                tokens = _gather_rows(tokens, plan.groups.batch)
        # merged: every record of the batch into the one shard; deferred:
        # this rank's rows into its own block
        c, n = monitor_update_local(monitor_cfg, monitor_params, counters[0], n[0], tokens,
                                    step, update_fn=update_fn, impl=impl)
        return MonitorState(_rewrap(monitor.counters, c[None]), _rewrap(monitor.n, n[None]),
                            step)

    def step_fn(state: TrainState, batch):
        leaves, treedef = tree_flatten(state.params)
        dp = tp = None
        if plan is not None:
            dp = DataParallel(treedef.unflatten(plan.split), plan.groups.batch)
            tp = TensorParallel(plan.groups.model, check=check_replicated,
                                seq_parallel=seq_parallel)
            with torch.no_grad():
                leaves = [local(p) for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, (loss, aux) = loss_fn(treedef.unflatten(leaves), batch, dp, tp)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {"loss": loss.detach(), "total_loss": total.detach()}
        if cfg.num_experts:
            metrics.update({k: aux[k].detach() for k in ("moe_lb_loss", "moe_z_loss")})
        if plan is not None:
            # grad_sums: over the batch group where no FSDP gather summed
            # the leaf; over the model group where it is a per-rank partial
            for g, (over_batch, over_model) in zip(grads, plan.sums):
                if over_batch and dp.world > 1:
                    dist.all_reduce(g, group=dp.group)
                if over_model and tp.size > 1:
                    dist.all_reduce(g, group=tp.group)
            if dp.world > 1:
                values = torch.stack(list(metrics.values()))
                dist.all_reduce(values, group=dp.group)
                metrics = dict(zip(metrics, values.unbind()))
        params, opt, stats = optimizer.update(treedef.unflatten(grads), state.opt,
                                              state.params)
        step = local(state.step)
        monitor = update_monitor(state.monitor, batch["tokens"], step)
        return (TrainState(params, opt, monitor, _rewrap(state.step, step + 1)),
                {**metrics, **stats})

    return step_fn


def make_train_state(generator: torch.Generator, cfg: ArchConfig, dims: Dims,
                     optimizer: Optimizer, *,
                     monitor_cfg: SketchMonitorConfig | None = None, device=None, mesh=None):
    """A fresh state: random float32 parameters drawn from ``generator``
    (``models.model.init_params``), the optimizer's zero state and an
    empty monitor, on ``device`` (None: the CUDA card).  Returns (state,
    monitor_params); the JAX package also returns the logical-axes tree,
    which is ``models.model.param_axes(state.params)`` here.

    With a ``mesh``, every rank draws the whole tree from ``generator``
    (seeded alike on every rank) and keeps its blocks in
    :func:`state_shardings`'s layout as DTensors, cut locally
    (``shardings.local_block``: no collective; a scatter from rank 0 would
    push about 12 GB through the group at qwen2.5-3b's width); the
    optimizer's state is built from the placed parameters."""
    device = platform.resolve(device)
    params = M.init_params(generator, cfg, dims, device=device)
    monitor = monitor_params = None
    if monitor_cfg is not None:
        monitor_params, monitor = init_monitor(monitor_cfg, device=device)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is not None:
        _check_mesh(mesh, dims)
        shard = state_shardings(mesh, TrainState(params, None, monitor, step),
                                M.param_axes(params))
        params = tree_map(_own_block, params, shard.params)
        if monitor is not None:
            monitor = MonitorState(_own_block(monitor.counters, shard.monitor.counters),
                                   _own_block(monitor.n, shard.monitor.n), monitor.step)
    return TrainState(params, optimizer.init(params), monitor, step), monitor_params


def _own_block(x: torch.Tensor, sharding) -> DTensor:
    """This rank's block of the full ``x`` as a DTensor laid out by
    ``sharding``, cut without a collective."""
    return DTensor.from_local(SH.local_block(x, sharding, dist.get_rank()), sharding.mesh,
                              sharding.placements, run_check=False)


def state_shardings(mesh, state: TrainState, axes_tree):
    """``NamedSharding`` tree of a TrainState: parameters by their logical
    axes; AdamW moments as their parameters (other optimizers' states,
    such as ``optim.q8sharded``'s, carry their own specs: replicated
    here); the monitor's counters split over the batch axes when it has a
    shard per rank, else replicated."""
    pshard = SH.param_shardings(mesh, axes_tree)
    rep = SH.NamedSharding(mesh, SH.PartitionSpec())
    bd = batch_axes(mesh)
    if isinstance(state.opt, AdamWState):
        opt = AdamWState(step=rep, m=pshard, v=pshard)
    else:
        opt = tree_map(lambda _: rep, state.opt)
    mon = None
    if state.monitor is not None:
        shards = state.monitor.counters.shape[0]
        cspec = SH.PartitionSpec(bd, None, None, None) if shards > 1 else SH.PartitionSpec()
        nspec = SH.PartitionSpec(bd) if shards > 1 else SH.PartitionSpec()
        mon = MonitorState(counters=SH.NamedSharding(mesh, cspec),
                           n=SH.NamedSharding(mesh, nspec), step=rep)
    return TrainState(params=pshard, opt=opt, monitor=mon, step=rep)
