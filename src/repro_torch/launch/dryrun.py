"""Multi-pod dry run: rank 0's step of every (arch x shape) cell on the
production mesh, traced on ``meta`` tensors and counted, with no card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on
512 host devices and reads XLA's memory and cost analysis.  Here the
process joins a *fake* default process group of ``prod(mesh.shape)``
ranks as rank 0 -- 256 for (data=16, model=16), 512 for (pod=2, data=16,
model=16) -- builds the mesh over it, and runs rank 0's own step (its
parameter blocks, its rows, every collective it issues) on ``meta``
tensors under ``roofline.count_cost``, which counts its FLOPs by dtype,
HBM bytes, collectives and live memory.  A sharding mismatch, a shape
error or an unsupported collective fails the cell, as a failed compile
fails the reference's.

The fake group is ``torch.testing._internal.distributed.fake_pg`` (its
``FakeStore`` and the ``"fake"`` backend), internal to torch: it wraps
``torch._C._distributed_c10d.FakeProcessGroup``, whose collectives return
at once and move nothing.  The dry run refuses to start when a default
group already exists, so it never reuses a real one; a fake group it made
itself is reused by later cells of the same mesh, and replaced for the
other mesh.

What the step reads on the host stays on the host: the optimizer's step
counter (the learning-rate schedule and the bias corrections read it) is
a CPU scalar; everything else lives on ``meta``, and the kernel ops run
their shape functions (``kernels.work.SHAPES``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --multi-pod --out <dir>
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs
from ..models import model as M
from ..models.config import compute_dims
from ..optim.adamw import make_adamw
from ..optim.q8sharded import make_q8adam_sharded
from ..optim.schedules import warmup_cosine
from ..sketchstream.monitor import SketchMonitorConfig
from ..tree import tree_flatten, tree_map
from . import roofline as RL
from . import serve as SV
from . import shardings as SH
from . import train as T
from .mesh import axis_size, data_shards, make_production_mesh

# optimizer HBM decides AdamW vs Q8Adam: fp32 Adam needs 16 B/param.
Q8_THRESHOLD_BYTES = 10e9     # per rank

_FAKE_WORLD: list = []        # the world size of the fake group this module made


def init_fake_world(world: int) -> None:
    """Join a fake default process group of ``world`` ranks as rank 0.
    Refuses when a default group exists that this module did not make; a
    fake group of another size made here is replaced."""
    if dist.is_initialized():
        if not _FAKE_WORLD:
            raise RuntimeError("a default process group exists already: the dry run runs "
                               "only in a process of its own, on a fake group it makes")
        if _FAKE_WORLD[0] == world:
            return
        dist.destroy_process_group()
        _FAKE_WORLD.clear()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _FAKE_WORLD.append(world)


def _src_len(seq: int) -> int:
    return max(seq // 4, 16)


def _rows(mesh, batch: int) -> int:
    shards = data_shards(mesh)
    if batch % shards:
        raise ValueError(f"a batch of {batch} does not split over {shards} data shards")
    return batch // shards


def pick_optimizer(cfg, mesh, param_pspecs):
    n = cfg.param_count()
    chips = math.prod(mesh.shape)
    lr = warmup_cosine(3e-4, 2000, 100_000)
    if n * 16 / chips > Q8_THRESHOLD_BYTES:
        return make_q8adam_sharded(mesh, lr, param_pspecs), "q8adam"
    return make_adamw(lr), "adamw"


def _count(fn, *args):
    """Run ``fn(*args)`` under the count; its arguments are rank 0's."""
    with RL.count_cost(memory_device="meta") as counter:
        counter.arguments(args)
        out = fn(*args)
        counter.outputs(out)
    return counter.cost


def _serving_params(cfg, dims, mesh):
    """Rank 0's bf16 parameter blocks (the JAX package casts the f32
    leaves to bf16 for serving)."""
    params = M.init_params(torch.Generator(), cfg, dims, device="meta")
    params = tree_map(lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x,
                      params)
    return SH.local_blocks(params, SH.param_shardings(mesh, M.param_axes(params)), 0)


def _enc_feats(cfg, batch: int, seq: int):
    if not cfg.is_encdec:
        return None
    return torch.empty((batch, _src_len(seq), cfg.d_model), dtype=torch.bfloat16,
                       device="meta")


def meta_train_state(cfg, dims, optimizer, *, monitor_cfg=None, mesh=None):
    """(state, monitor_params) of ``train.make_train_state`` on ``meta``
    (rank 0's blocks under a ``mesh``), its optimizer's step counter a CPU
    scalar: the schedule and the bias corrections read it on the host."""
    state, mparams = T.make_train_state(torch.Generator(), cfg, dims, optimizer,
                                        monitor_cfg=monitor_cfg, device="meta", mesh=mesh)
    step = torch.zeros((), dtype=torch.int32)
    return state._replace(opt=state.opt._replace(step=step)), mparams


def lower_train_cell(cfg, mesh, shape: configs.ShapeSpec, *, monitor="deferred",
                     remat: str = "full", attn_chunk: int = 2048, ssm_chunk: int = 128,
                     seq_parallel: bool = False, probs_bf16: bool = False):
    """Rank 0's train step, counted: (``roofline.Cost``, report fields)."""
    dims = compute_dims(cfg, tp=axis_size(mesh, "model"))
    abstract = M.init_params(torch.Generator(), cfg, dims, device="meta")
    optimizer, opt_name = pick_optimizer(cfg, mesh,
                                         SH.param_pspecs(mesh, M.param_axes(abstract)))
    mcfg = None
    if monitor:
        # "step": one replicated shard, merged every step; "deferred": a
        # shard per batch rank, merged at query time
        mcfg = SketchMonitorConfig(shards=data_shards(mesh) if monitor != "step" else 1)
    state, mparams = meta_train_state(cfg, dims, optimizer, monitor_cfg=mcfg, mesh=mesh)
    rows = _rows(mesh, shape.batch)
    batch = {"tokens": torch.empty((rows, shape.seq), dtype=torch.int32, device="meta"),
             "labels": torch.empty((rows, shape.seq), dtype=torch.int32, device="meta")}
    ef = _enc_feats(cfg, rows, shape.seq)
    if ef is not None:
        batch["enc_feats"] = ef
    step_fn = T.make_train_step(cfg, dims, optimizer, mesh, monitor_cfg=mcfg,
                                monitor_params=mparams, remat=remat, attn_chunk=attn_chunk,
                                ssm_chunk=ssm_chunk, seq_parallel=seq_parallel,
                                probs_dtype=torch.bfloat16 if probs_bf16 else torch.float32)
    cost = _count(step_fn, state, batch)
    return cost, {"optimizer": opt_name, "params": cfg.param_count(),
                  "active_params": cfg.active_param_count()}


def lower_prefill_cell(cfg, mesh, shape: configs.ShapeSpec, *, attn_chunk: int = 2048,
                       ssm_chunk: int = 128):
    """Rank 0's prefill of its rows of the batch, counted."""
    dims = compute_dims(cfg, tp=axis_size(mesh, "model"))
    params = _serving_params(cfg, dims, mesh)
    tokens = torch.empty((shape.batch, shape.seq), dtype=torch.int32, device="meta")
    fn = SV.make_prefill(cfg, dims, mesh, attn_chunk=attn_chunk, ssm_chunk=ssm_chunk)
    ef = _enc_feats(cfg, shape.batch, shape.seq)
    cost = _count(fn, params, tokens) if ef is None else _count(fn, params, tokens, ef)
    return cost, {"params": cfg.param_count()}


def lower_decode_cell(cfg, mesh, shape: configs.ShapeSpec, *, cache_layout: str = "auto"):
    """Rank 0's decode step over its block of a ``shape.seq`` cache,
    counted.  The port's decode step takes its cache regime from the
    batch (``serve.seq_sharded_mode``); ``cache_layout`` may only name
    that regime."""
    dims = compute_dims(cfg, tp=axis_size(mesh, "model"))
    seq_mode = SV.seq_sharded_mode(mesh, shape.batch)
    if cache_layout != "auto" and (cache_layout == "seq") != seq_mode:
        raise ValueError(f"a batch of {shape.batch} on this mesh decodes with the "
                         f"{'seq' if seq_mode else 'batch'} cache layout")
    params = _serving_params(cfg, dims, mesh)
    src = _src_len(shape.seq) if cfg.is_encdec else 0
    cache = SV.init_cache(cfg, dims, shape.batch, shape.seq, src, mesh, device="meta")
    token = torch.empty((shape.batch, 1), dtype=torch.int32, device="meta")
    fn = SV.make_decode_step(cfg, dims, mesh)
    cost = _count(fn, params, token, cache)
    return cost, {"params": cfg.param_count(), "cache_layout": "seq" if seq_mode else "batch"}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, monitor="deferred",
             remat: str = "full", attn_chunk: int = 2048, ssm_chunk: int = 128,
             cache_layout: str = "auto", seq_parallel: bool = False,
             probs_bf16: bool = False) -> dict:
    """One cell's report: the reference's keys where they have a
    counterpart (no ``compile_s``, ``generated_code_bytes`` or ``loops``:
    eager code has none), ``memory`` as rank 0's live storages."""
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = math.prod(mesh.shape)
    t0 = time.time()
    if shape.kind == "train":
        cost, meta = lower_train_cell(cfg, mesh, shape, monitor=monitor, remat=remat,
                                      attn_chunk=attn_chunk, ssm_chunk=ssm_chunk,
                                      seq_parallel=seq_parallel, probs_bf16=probs_bf16)
    elif shape.kind == "prefill":
        cost, meta = lower_prefill_cell(cfg, mesh, shape, attn_chunk=attn_chunk,
                                        ssm_chunk=ssm_chunk)
    else:
        cost, meta = lower_decode_cell(cfg, mesh, shape, cache_layout=cache_layout)
    t_lower = time.time() - t0
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    mf = RL.model_flops(cfg, tokens, train=(shape.kind == "train")) / chips
    rl = RL.analyze_cost(cost, model_flops_per_device=mf)
    return {"arch": arch, "shape": shape_name,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chips": chips,
            "kind": shape.kind, "lower_s": round(t_lower, 1),
            "monitor": monitor if shape.kind == "train" else None,
            "remat": remat if shape.kind == "train" else None, **meta,
            "memory": cost.memory(), "roofline": rl.as_dict(),
            "collectives": RL.parse_collectives(cost), "kernel_ops": cost.kernel_ops}


def _blocks_bytes(tree, shardings, rank: int = 0) -> int:
    """The bytes of ``rank``'s ``shardings.local_block`` of every leaf of
    ``tree`` (full tensors, on ``meta``)."""
    leaves, treedef = tree_flatten(tree)
    return sum(SH.local_block(x, s, rank).nbytes
               for x, s in zip(leaves, treedef.flatten_up_to(shardings)))


def expected_argument_bytes(arch: str, shape_name: str, *, multi_pod: bool = False,
                            monitor="deferred") -> int:
    """Rank 0's argument bytes of a cell by another route than the step:
    the ``local_block`` sizes of the full state under
    ``train.state_shardings`` (or of the serving parameters and the cache
    under ``cache_shardings``), and its rows of the batch.  Needs no
    process group (an ``AbstractMesh``)."""
    from .mesh import AbstractMesh
    cfg, shape = configs.get(arch), configs.SHAPES[shape_name]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    dims = compute_dims(cfg, tp=axis_size(mesh, "model"))
    params = M.init_params(torch.Generator(), cfg, dims, device="meta")
    axes = M.param_axes(params)
    if shape.kind == "train":
        optimizer, opt_name = pick_optimizer(cfg, mesh, SH.param_pspecs(mesh, axes))
        mcfg = (SketchMonitorConfig(shards=data_shards(mesh) if monitor != "step" else 1)
                if monitor else None)
        state, _ = T.make_train_state(torch.Generator(), cfg, dims, optimizer,
                                      monitor_cfg=mcfg, device="meta")
        if opt_name != "adamw":
            raise ValueError("the hand count covers AdamW's state")
        shard = T.state_shardings(mesh, state, axes)
        # the optimizer's step is a host scalar, not counted
        state, shard = (state._replace(opt=state.opt._replace(step=None)),
                        shard._replace(opt=shard.opt._replace(step=None)))
        rows = _rows(mesh, shape.batch)
        batch = 2 * rows * shape.seq * 4
        if cfg.is_encdec:
            batch += rows * _src_len(shape.seq) * cfg.d_model * 2
        return _blocks_bytes(tuple(state), tuple(shard)) + batch
    params = tree_map(lambda x: x.to(torch.bfloat16), params)
    total = _blocks_bytes(params, SH.param_shardings(mesh, axes))
    if shape.kind == "prefill":
        total += shape.batch * shape.seq * 4
        if cfg.is_encdec:
            total += shape.batch * _src_len(shape.seq) * cfg.d_model * 2
        return total
    src = _src_len(shape.seq) if cfg.is_encdec else 0
    cache, shard = SV.cache_shardings(mesh, cfg, dims, shape.batch, shape.seq, src)
    return total + _blocks_bytes(cache, shard) + shape.batch * 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-monitor", action="store_true")
    ap.add_argument("--monitor-mode", default="deferred", choices=["deferred", "step"])
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn-chunk", type=int, default=2048)
    ap.add_argument("--cache-layout", default="auto", choices=["auto", "batch", "seq"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--probs-bf16", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=128)
    ap.add_argument("--tag", default=None, help="suffix for output JSON names")
    ap.add_argument("--out", default=None, help="directory for JSON reports")
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    ok, failed = 0, []
    pod = "2pod" if args.multi_pod else "1pod"
    t_all = time.time()
    for arch in archs:
        shapes = [args.shape] if args.shape != "all" else list(configs.SHAPES)
        shapes = [s for s in shapes if configs.applicable(configs.get(arch), s)]
        if not shapes:
            print(f"[SKIP] {arch}/{args.shape}: inapplicable "
                  "(full attention, no sub-quadratic path)")
            continue
        for shape in shapes:
            tag = f"{arch}/{shape}/{pod}"
            try:
                rep = run_cell(arch, shape, multi_pod=args.multi_pod,
                               monitor=(False if args.no_monitor else args.monitor_mode),
                               remat=args.remat, attn_chunk=args.attn_chunk,
                               ssm_chunk=args.ssm_chunk, cache_layout=args.cache_layout,
                               seq_parallel=args.seq_parallel, probs_bf16=args.probs_bf16)
                ok += 1
                rl, mem = rep["roofline"], rep["memory"]
                print(f"[OK] {tag} lower={rep['lower_s']}s flops={rl['flops']:.4g} "
                      f"hbm={rl['hbm_bytes']:.4g} wire={rl['wire_bytes']:.4g} "
                      f"compute={rl['compute_s']:.4g}s memory={rl['memory_s']:.4g}s "
                      f"collective={rl['collective_s']:.4g}s dominant={rl['dominant']} "
                      f"peak={mem['peak_bytes'] / 1e9:.2f}GB", flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{arch}__{shape}__{pod}.json"
                    if args.tag:
                        fn = fn.replace(".json", f"__{args.tag}.json")
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(rep, f, indent=1)
            except Exception:
                failed.append(tag)
                print(f"[FAIL] {tag}")
                traceback.print_exc()
    print(f"\n{ok} cells OK, {len(failed)} failed in {time.time() - t_all:.1f} s")
    if failed:
        for t in failed:
            print("  FAIL:", t)
        sys.exit(1)


if __name__ == "__main__":
    main()
