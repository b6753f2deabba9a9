"""The train step: forward and backward, the optimizer, and the SJPC
stream monitor.

The JAX package's ``launch/train.py`` without a mesh.
``make_train_step(cfg, dims, optimizer, ...)`` returns
``step_fn(state, batch) -> (state, metrics)``, which the fault-tolerant
driver (``runtime/driver.py``) and ``examples/train_lm_sketch_torch.py``
run.  Gradients come from ``torch.autograd`` on the float32 parameter
leaves (cast to ``compute_dtype`` inside ``models.model.forward``); the
optimizer updates the parameters and moments in place
(``optim/adamw.py``).  The monitor runs the JAX package's merged mode:
the batch's records go through ``sjpc.update`` into the one shard of
counters, with ``kernels.ops.make_sjpc_update_fn`` as its scatter, so on
the card each step launches the ``sample_weights`` kernel once and the
``fingerprint`` and ``sketch_update`` kernels once per lattice level.

The deferred-merge mode over a data-parallel mesh (the JAX package's
``shard_map`` call site) and ``state_shardings`` wait for the multi-card
slice (ROADMAP queue 1): a ``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import platform
from ..kernels import ops
from ..models import model as M
from ..models.config import ArchConfig, Dims
from ..optim.adamw import Optimizer
from ..sketchstream.monitor import (MonitorState, SketchMonitorConfig, init_monitor,
                                    monitor_update_local)
from ..tree import tree_flatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    monitor: Any            # MonitorState | None
    step: torch.Tensor      # () int32


MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001


def make_train_step(cfg: ArchConfig, dims: Dims, optimizer: Optimizer, mesh=None, *,
                    monitor_cfg: SketchMonitorConfig | None = None, monitor_params=None,
                    remat: str = "full", ssm_chunk: int = 128, attn_chunk: int = 2048,
                    compute_dtype=torch.bfloat16, probs_dtype=torch.float32,
                    impl: str | None = None):
    """Returns step_fn(state, batch) -> (state, metrics).

    ``batch`` holds ``tokens`` and ``labels`` (B, S), optionally ``mask``
    and an encoder-decoder's ``enc_feats``; tensors on the state's device
    or numpy arrays.  ``impl`` names the implementation of the kernel ops
    the step runs (the monitor's, and flash attention's forward and
    backward above ``CHUNKED_THRESHOLD``); None goes by the device.  The returned state
    holds the input state's parameter and moment tensors, updated."""
    if mesh is not None:
        raise NotImplementedError("a mesh (the deferred-merge monitor under shard_map and "
                                  "sharded state) waits for the multi-card slice, ROADMAP "
                                  "queue 1 item 1")
    update_fn = ops.make_sjpc_update_fn(impl=impl)

    def loss_fn(params, batch):
        logits, aux = M.forward(params, cfg, dims, batch["tokens"],
                                enc_feats=batch.get("enc_feats"), compute_dtype=compute_dtype,
                                remat=remat, ssm_chunk=ssm_chunk, attn_chunk=attn_chunk,
                                probs_dtype=probs_dtype, impl=impl)
        loss = M.lm_loss(logits, batch["labels"], cfg.vocab_size, mask=batch.get("mask"))
        total = loss
        if cfg.num_experts:
            total = (total + MOE_LB_WEIGHT * aux["moe_lb_loss"]
                     + MOE_Z_WEIGHT * aux["moe_z_loss"])
        return total, (loss, aux)

    def update_monitor(monitor: MonitorState, tokens, step):
        if monitor_cfg is None:
            return monitor
        # the merged mode: every record of the batch into one shard
        c, n = monitor_update_local(monitor_cfg, monitor_params, monitor.counters[0],
                                    monitor.n[0], tokens, step, update_fn=update_fn,
                                    impl=impl)
        return MonitorState(c[None], n[None], step)

    def step_fn(state: TrainState, batch):
        leaves, treedef = tree_flatten(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, (loss, aux) = loss_fn(state.params, batch)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = treedef.unflatten(torch.zeros_like(p) if g is None else g
                                  for p, g in zip(leaves, grads))
        params, opt, stats = optimizer.update(grads, state.opt, state.params)
        monitor = update_monitor(state.monitor, batch["tokens"], state.step)
        metrics = {"loss": loss.detach(), "total_loss": total.detach(), **stats}
        if cfg.num_experts:
            metrics.update({k: aux[k].detach() for k in ("moe_lb_loss", "moe_z_loss")})
        return TrainState(params, opt, monitor, state.step + 1), metrics

    return step_fn


def make_train_state(generator: torch.Generator, cfg: ArchConfig, dims: Dims,
                     optimizer: Optimizer, *,
                     monitor_cfg: SketchMonitorConfig | None = None, device=None):
    """A fresh state: random float32 parameters drawn from ``generator``
    (``models.model.init_params``), the optimizer's zero state and an
    empty monitor, on ``device`` (None: the CUDA card).  Returns (state,
    monitor_params); the JAX package also returns the logical-axes tree,
    which only its shardings read."""
    device = platform.resolve(device)
    params = M.init_params(generator, cfg, dims, device=device)
    opt = optimizer.init(params)
    monitor = monitor_params = None
    if monitor_cfg is not None:
        monitor_params, monitor = init_monitor(monitor_cfg, device=device)
    return (TrainState(params, opt, monitor, torch.zeros((), dtype=torch.int32, device=device)),
            monitor_params)
