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

With a ``mesh`` (``launch/mesh.py``; its model axis 1) the step is one
rank of a data-parallel step over the batch axes: the state's parameters
and moments are DTensors placed by ``launch/shardings.py`` (the "embed"
dim split over the batch axes), the batch is the rank's own rows, and
``launch/data_parallel.py`` gathers each layer's weights before it runs
and reduce-scatters their gradients.  Loss and gradients are the global
batch's: each rank's token mean is weighted by its share of the global
token count and the ranks' gradients are summed.  The monitor's merged
mode (one shard of counters) all-gathers the token ids and updates every
rank's copy with the whole batch; its deferred mode (one shard per rank)
updates each rank's own block with its own rows and no collective.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

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
from .mesh import axis_size, batch_axes, data_shards

# Serving runs tensor-parallel (``launch/serve.py``); the train step's
# backward through ``launch/tensor_parallel.py``'s f/g pairs and the
# gathers over the batch group alone are the next item.
TENSOR_PARALLEL_ITEM = "ROADMAP.md queue 1 item 1 (tensor-parallel training)"


class TrainState(NamedTuple):
    params: Any
    opt: Any
    monitor: Any            # MonitorState | None
    step: torch.Tensor      # () int32


MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001


def _check_mesh(mesh) -> None:
    if axis_size(mesh, "model") > 1:
        raise NotImplementedError(f"a mesh whose model axis is {axis_size(mesh, 'model')} "
                                  f"waits for {TENSOR_PARALLEL_ITEM}")
    if data_shards(mesh) != dist.get_world_size():
        raise ValueError(f"the mesh's {data_shards(mesh)} batch shards are not the "
                         f"{dist.get_world_size()} ranks of the default group")


def _split_dim(p):
    """The tensor dim of a parameter split over the batch axes, or None."""
    if not isinstance(p, DTensor):
        return None
    names = p.device_mesh.mesh_dim_names
    dims = {pl.dim for name, pl in zip(names, p.placements)
            if name != "model" and isinstance(pl, Shard)}
    return dims.pop() if dims else None


def _rewrap(like, value):
    """``value`` (a rank's block) as a DTensor laid out as ``like``."""
    if not isinstance(like, DTensor):
        return value
    return DTensor.from_local(value, like.device_mesh, like.placements, run_check=False)


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows, in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def make_train_step(cfg: ArchConfig, dims: Dims, optimizer: Optimizer, mesh=None, *,
                    monitor_cfg: SketchMonitorConfig | None = None, monitor_params=None,
                    remat: str = "full", ssm_chunk: int = 128, attn_chunk: int = 2048,
                    compute_dtype=torch.bfloat16, probs_dtype=torch.float32,
                    impl: str | None = None):
    """Returns step_fn(state, batch) -> (state, metrics).

    ``batch`` holds ``tokens`` and ``labels`` (B, S), optionally ``mask``
    and an encoder-decoder's ``enc_feats``; tensors on the state's device
    or numpy arrays.  With a ``mesh`` they are this rank's rows of the
    global batch (rank r holds the r-th of ``data_shards`` equal slices) and
    the state comes from ``make_train_state(..., mesh=mesh)``; a mesh whose
    model axis is larger than 1 raises ``NotImplementedError``.  ``impl``
    names the implementation of the kernel ops the step runs (the
    monitor's, and flash attention's forward and backward above
    ``CHUNKED_THRESHOLD``); None goes by the device.  The returned state
    holds the input state's parameter and moment tensors, updated."""
    if mesh is not None:
        _check_mesh(mesh)
    update_fn = ops.make_sjpc_update_fn(impl=impl)

    def loss_fn(params, batch, dp):
        logits, aux = M.forward(params, cfg, dims, batch["tokens"],
                                enc_feats=batch.get("enc_feats"), compute_dtype=compute_dtype,
                                remat=remat, ssm_chunk=ssm_chunk, attn_chunk=attn_chunk,
                                probs_dtype=probs_dtype, impl=impl, dp=dp)
        mask = batch.get("mask")
        loss = M.lm_loss(logits, batch["labels"], cfg.vocab_size, mask=mask)
        if dp is not None:
            # this rank's share of the global token mean
            count = (torch.as_tensor(mask, device=logits.device).to(torch.float32).sum()
                     if mask is not None else
                     torch.tensor(float(logits.shape[0] * logits.shape[1]),
                                  device=logits.device))
            total_count = count.clone()
            dist.all_reduce(total_count)
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
                tokens = _gather_rows(tokens)
        # merged: every record of the batch into the one shard; deferred:
        # this rank's rows into its own block
        c, n = monitor_update_local(monitor_cfg, monitor_params, counters[0], n[0], tokens,
                                    step, update_fn=update_fn, impl=impl)
        return MonitorState(_rewrap(monitor.counters, c[None]), _rewrap(monitor.n, n[None]),
                            step)

    def step_fn(state: TrainState, batch):
        leaves, treedef = tree_flatten(state.params)
        dp = None
        if mesh is not None:
            splits = [_split_dim(p) for p in leaves]
            dp = DataParallel(treedef.unflatten(splits))
            with torch.no_grad():
                leaves = [local(p) for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, (loss, aux) = loss_fn(treedef.unflatten(leaves), batch, dp)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {"loss": loss.detach(), "total_loss": total.detach()}
        if cfg.num_experts:
            metrics.update({k: aux[k].detach() for k in ("moe_lb_loss", "moe_z_loss")})
        if dp is not None:
            # a replicated leaf's gradient is this rank's part; a split
            # leaf's came back summed from its gathers
            for g, split in zip(grads, splits):
                if split is None:
                    dist.all_reduce(g)
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values)
            metrics = dict(zip(metrics, values.unbind()))
        params, opt, stats = optimizer.update(treedef.unflatten(grads), state.opt,
                                              state.params)
        monitor = update_monitor(state.monitor, batch["tokens"], state.step)
        return TrainState(params, opt, monitor, state.step + 1), {**metrics, **stats}

    return step_fn


def make_train_state(generator: torch.Generator, cfg: ArchConfig, dims: Dims,
                     optimizer: Optimizer, *,
                     monitor_cfg: SketchMonitorConfig | None = None, device=None, mesh=None):
    """A fresh state: random float32 parameters drawn from ``generator``
    (``models.model.init_params``), the optimizer's zero state and an
    empty monitor, on ``device`` (None: the CUDA card).  Returns (state,
    monitor_params); the JAX package also returns the logical-axes tree,
    which is ``models.model.param_axes(state.params)`` here.

    With a ``mesh``, the parameters and the monitor are placed by
    :func:`state_shardings` (rank 0's draw scattered to the ranks) and the
    optimizer's state is built from the placed parameters."""
    device = platform.resolve(device)
    params = M.init_params(generator, cfg, dims, device=device)
    monitor = monitor_params = None
    if monitor_cfg is not None:
        monitor_params, monitor = init_monitor(monitor_cfg, device=device)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is not None:
        _check_mesh(mesh)
        shard = state_shardings(mesh, TrainState(params, None, monitor, step),
                                M.param_axes(params))
        params = tree_map(SH.distribute, params, shard.params)
        if monitor is not None:
            monitor = MonitorState(SH.distribute(monitor.counters, shard.monitor.counters),
                                   SH.distribute(monitor.n, shard.monitor.n), monitor.step)
    return TrainState(params, optimizer.init(params), monitor, step), monitor_params


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
