"""The multi-rank half of ``tests/test_torch_tp_train.py``: tensor-parallel
training on gloo ranks on the CPU, and the inputs the ranks share with the
parent test.

Each rank builds a mesh over its world, draws the whole train state of a
reduced config from the same seed and keeps its blocks
(``make_train_state(mesh=)``), and takes one f32 step of
``make_train_step(mesh=)`` with AdamW and the monitor on its rows of the
global batch, every layer's output and the gradient reaching it held equal
across the model group (``check_replicated``).  It keeps its metrics, the
gradient blocks the optimizer got, its parameter blocks after the step and
its monitor block, for the parent to assemble and hold against the port's
one-process step at the same ``Dims`` (:func:`train_case` with no mesh),
and against ``jax.value_and_grad`` of the JAX package's meshless loss.
The ranks also run the fault-tolerant driver on (data=1, model=2) and a
toy of the MoE router's backward.  This module imports no JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import torch_rank_cases as rank_cases

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-370m", "jamba-1.5-large-398b",
         "seamless-m4t-large-v2")
TP = 2                  # the model axis of every mesh here
ROWS = 4                # global batch rows
SEQ = rank_cases.TRAIN_SEQ
SRC = 8                 # encoder frames of the encoder-decoder
LR = 1e-3
# (mesh (data, model), configs, monitor shards, seq_parallel) of each world
CASES = {2: (((1, 2), ARCHS, 1, False), ((1, 2), ("qwen2.5-3b",), 1, True)),
         4: (((2, 2), ("qwen2.5-3b",), 1, False), ((2, 2), ("deepseek-moe-16b",), 2, False))}
DRIVER_STEPS = 5
DRIVER_FAILURE_AT = 3
DRIVER_CKPT_EVERY = 2


def train_batch(name: str, rows: int = ROWS) -> dict:
    """The global batch: tokens, labels, and frames for an encoder-decoder."""
    from repro_torch import configs
    cfg = configs.reduced(name)
    rng = np.random.default_rng(2801)
    toks = rng.integers(0, cfg.vocab_size, size=(rows, SEQ + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.is_encdec:
        out["enc_feats"] = rng.normal(size=(rows, SRC, cfg.d_model)).astype(np.float32)
    return out


def train_case(name: str, shards: int, mesh=None, seq_parallel: bool = False) -> dict:
    """One f32 step of reduced ``name`` at ``compute_dims(cfg, tp=TP)``, AdamW
    and a monitor of ``shards`` shards: on ``mesh`` this rank's part (its
    rows along the batch axes), else the one-process step on the whole
    batch.  Returns the state after the step, the metrics, the gradients
    the optimizer got (local blocks), and the replicated checks made."""
    from repro_torch import configs
    from repro_torch.launch import tensor_parallel, train
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models.config import compute_dims
    from repro_torch.optim import make_adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.sketchstream.monitor import SketchMonitorConfig

    cfg = configs.reduced(name)
    dims = compute_dims(cfg, tp=TP)
    mcfg = SketchMonitorConfig(**rank_cases.MONITOR, shards=shards)
    record: list = []
    opt = make_adamw(constant(LR))
    state, mparams = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims, opt,
                                            monitor_cfg=mcfg, device="cpu", mesh=mesh)
    step = train.make_train_step(cfg, dims, rank_cases.capture_optimizer(opt, record), mesh,
                                 monitor_cfg=mcfg, monitor_params=mparams, remat="full",
                                 ssm_chunk=8, compute_dtype=torch.float32,
                                 seq_parallel=seq_parallel, check_replicated=mesh is not None)
    batch = train_batch(name)
    if mesh is not None:
        groups = mesh_groups(mesh)
        mine = ROWS // mesh.shape[0]
        rows = slice(groups.batch_index * mine, (groups.batch_index + 1) * mine)
        batch = {k: v[rows] for k, v in batch.items()}
    before = tensor_parallel.checks
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"state": state, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": record[0], "checks": tensor_parallel.checks - before}


def _blocks(state) -> dict:
    from repro_torch.optim.adamw import local
    from repro_torch.tree import tree_leaves
    return {"params": [local(p).clone() for p in tree_leaves(state.params)],
            "monitor": (local(state.monitor.counters).clone(), local(state.monitor.n).clone())}


def tp_rank(rank: int, world: int, ckpt_dir: str) -> dict:
    """Every case of ``CASES[world]`` on this rank; on two ranks also the
    driver and the router toy."""
    from repro_torch.launch.mesh import make_debug_mesh

    out = {}
    for shape, archs, shards, seq in CASES[world]:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        for name in archs:
            res = train_case(name, shards, mesh, seq)
            out[shape, name, seq] = {"metrics": res["metrics"], "grads": res["grads"],
                                     "checks": res["checks"], **_blocks(res["state"])}
    if world == 2:
        out["driver"] = driver_case(rank, ckpt_dir)
        out["router"] = router_toy()
    return out


# -- the driver on (data=1, model=2) -----------------------------------------

class RecordingClient:
    """A stand-in for ``service.MonitorServiceClient``: what the driver
    hands it."""

    def __init__(self):
        self.seen: list = []

    def _take(self, kind, monitor):
        self.seen.append((kind, [(type(x).__name__, tuple(x.shape)) for x in monitor]))

    def publish(self, monitor):
        self._take("publish", monitor)

    def resync(self, monitor):
        self._take("resync", monitor)

    def log_entry(self, step: int) -> dict:
        return {"step": step}


def driver_batch(step: int) -> dict:
    rng = np.random.default_rng(2810 + step)
    toks = rng.integers(0, 256, size=(2, SEQ + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def driver_case(rank: int, ckpt_root: str) -> dict:
    """Reduced qwen2.5-3b through ``TrainDriver`` on (1, 2): a run with a
    failure at step DRIVER_FAILURE_AT, restored through ``shardings=``,
    and an uninterrupted run; their end states bit for bit, and the last
    checkpoint's arrays against the end state's full tensors."""
    from repro_torch import configs
    from repro_torch.checkpoint import chunked
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import compute_dims
    from repro_torch.optim import make_adamw
    from repro_torch.optim.adamw import local
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime.driver import DriverConfig, SimulatedFailure, TrainDriver
    from repro_torch.sketchstream.monitor import SketchMonitorConfig
    from repro_torch.tree import tree_leaves

    cfg = configs.reduced("qwen2.5-3b")
    dims = compute_dims(cfg, tp=TP)
    mesh = make_debug_mesh(1, TP, device_type="cpu")
    mcfg = SketchMonitorConfig(**rank_cases.MONITOR)
    runs = {}
    for name in ("failing", "whole"):
        opt = make_adamw(constant(LR))
        state, mparams = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims,
                                                opt, monitor_cfg=mcfg, device="cpu", mesh=mesh)
        shardings = train.state_shardings(mesh, state, M.param_axes(state.params))
        step = train.make_train_step(cfg, dims, opt, mesh, monitor_cfg=mcfg,
                                     monitor_params=mparams, remat="full",
                                     compute_dtype=torch.float32)
        ckpt = os.path.join(ckpt_root, name)
        client = RecordingClient()
        driver = TrainDriver(step, state, driver_batch,
                             DriverConfig(ckpt_dir=ckpt, ckpt_every=DRIVER_CKPT_EVERY,
                                          log_every=1, sketch_log_every=2),
                             monitor_cfg=mcfg, shardings=shardings, service_client=client)
        if name == "failing":
            driver.inject_failure_at = {DRIVER_FAILURE_AT: SimulatedFailure("injected")}
        log = driver.run(DRIVER_STEPS)
        saved, man = chunked.restore_checkpoint(ckpt, driver.template)
        whole = [x.full_tensor() if hasattr(x, "full_tensor") else x
                 for x in tree_leaves(driver.state)]
        runs[name] = {
            "leaves": [local(x).clone() for x in tree_leaves(driver.state)],
            "placements": [tuple(x.placements) for x in tree_leaves(driver.state.params)],
            "losses": [m["loss"] for m in log],
            "events": [e["kind"] for e in driver.events],
            "saved_step": man.step,
            "saved_equal": len(whole) == len(tree_leaves(saved)) and all(
                torch.equal(a, b) for a, b in zip(whole, tree_leaves(saved))),
            "client": client.seen}
    return runs


# -- the MoE router's backward on a toy ---------------------------------------

TOY = dict(d=8, experts=4, top_k=2, tokens=16)


def router_toy_inputs():
    rng = np.random.default_rng(2820)
    d, e = TOY["d"], TOY["experts"]
    params = {"router": rng.normal(size=(d, e)), "w_gate": rng.normal(size=(e, d, 6)),
              "w_up": rng.normal(size=(e, d, 6)), "w_down": rng.normal(size=(e, 6, d))}
    params = {k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()}
    x = torch.from_numpy(rng.normal(size=(1, TOY["tokens"], d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(1, TOY["tokens"], d)).astype(np.float32))
    return params, x, w


def router_toy_grads(tp=None) -> dict:
    """The gradients of ``sum(moe_ffn(x) * w) + lb + z`` (f32) with respect
    to x and the (rank's block of the) router and experts."""
    from repro_torch.models import moe

    params, x, w = router_toy_inputs()
    if tp is not None:
        first, count = tp.block(TOY["experts"])
        params = {"router": params["router"][:, first:first + count],
                  **{k: params[k][first:first + count] for k in ("w_gate", "w_up", "w_down")}}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = x.clone().requires_grad_(True)
    out, aux = moe.moe_ffn(leaves, x, num_experts=TOY["experts"], top_k=TOY["top_k"],
                           capacity_factor=float(TOY["experts"]), tp=tp)
    total = (out * w).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]
    grads = torch.autograd.grad(total, [x] + [leaves[k] for k in sorted(leaves)])
    return dict(zip(["x"] + sorted(leaves), grads))


def router_toy() -> dict:
    """The toy on the rank's experts, with ``sum_grads`` as it is and
    with it made the identity (the backward without the fix)."""
    from repro_torch.launch.tensor_parallel import TensorParallel

    tp = TensorParallel()
    fixed = router_toy_grads(tp)
    real = TensorParallel.sum_grads
    TensorParallel.sum_grads = lambda self, x: x
    try:
        unfixed = router_toy_grads(tp)
    finally:
        TensorParallel.sum_grads = real
    return {"fixed": fixed, "unfixed": unfixed}
