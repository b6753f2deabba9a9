"""The multi-rank halves of ``tests/test_torch_sharded.py`` and
``tests/test_torch_mesh.py``: functions that each rank of a gloo process
group runs on the CPU, and the inputs they share with the parent test.

``start`` launches ``WORLD`` ranks (or ``world=``) on one ``FileStore``
and ``join`` waits for them (a test file starts them first, so that they run beside its
one-process tests); each rank writes what it computed to
``<out>/rank<r>.pt`` for the parent to hold against the JAX package and
the port's one-process paths.  This module imports no
JAX (the ranks need none); ``jax_q8_two_devices`` imports it inside, in a
subprocess of its own with two host devices.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
SPAWN_TIMEOUT_S = 240

# -- inputs -----------------------------------------------------------------

SHARDED_CFG = dict(d=5, s=3, ratio=0.5, width=512, depth=3, seed=11)
MONITOR = dict(d=4, s=4, width=256, depth=2)
# (config, monitor shards, MoE group, global rows): the merged monitor's
# batch has as many rows as a deferred shard's, so JAX compiles its
# monitor update once for both
TRAIN_CASES = (("qwen2.5-3b", 1, None, 2), ("deepseek-moe-16b", WORLD, None, 4),
               ("deepseek-moe-16b", 1, 16, 4))
TRAIN_SEQ = 32
Q8_STEPS = 3


def sharded_inputs() -> dict:
    rng = np.random.default_rng(2601)
    cfg = SHARDED_CFG
    levels = cfg["d"] - cfg["s"] + 1
    return {
        "counters": rng.integers(-2**20, 2**20, size=(WORLD, levels, cfg["depth"], cfg["width"]),
                                 dtype=np.int32),
        "n": rng.integers(0, 1000, size=(WORLD,)).astype(np.float32),
        "step": np.int32(7),
        "x": rng.normal(size=(WORLD, 700)).astype(np.float32),
        "batches": [rng.integers(0, 9, size=(33, cfg["d"])).astype(np.uint32)
                    for _ in range(3)],
    }


def train_batch(name: str, rows: int) -> dict:
    from repro_torch import configs
    vocab = configs.reduced(name).vocab_size
    rng = np.random.default_rng(2602)
    toks = rng.integers(0, vocab, size=(rows, TRAIN_SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def q8_case() -> tuple[dict, np.ndarray]:
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(64, 32)).astype(np.float32),
              "b": rng.normal(size=(32,)).astype(np.float32)}
    return params, np.ones((64, 32), np.float32)


def q8_grads(p, target):
    """The gradient of ``|w - target|^2 + |b|^2 / 2`` (numpy, torch or jax)."""
    return {"w": 2 * (p["w"] - target), "b": p["b"] * 1}


def restore_tree() -> dict:
    rng = np.random.default_rng(2603)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}


# -- process plumbing -------------------------------------------------------

def _init(rank: int, store: str, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


def _entry(rank: int, fn, store: str, out: str, world: int, *args) -> None:
    _init(rank, store, world)
    try:
        torch.save(fn(rank, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(fn, out: Path, *args, world: int = WORLD):
    """Start ``fn(rank, *args)`` on ``world`` gloo ranks; ``join`` waits."""
    ctx = mp.start_processes(_entry, args=(fn, str(out / "store"), str(out), world) + args,
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out, time.monotonic() + SPAWN_TIMEOUT_S


def stop(started) -> None:
    """End any rank still running (a file whose rank tests were not run)."""
    for p in started[0].processes:
        if p.is_alive():
            p.kill()
        p.join(timeout=30)


def join(started) -> list[dict]:
    """The results of the ranks ``start`` started, once they have ended."""
    ctx, out, deadline = started
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {SPAWN_TIMEOUT_S} s")
    # the ranks' own files, pickled trees of tensors
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


# -- the sharded file's ranks -----------------------------------------------

def sharded_rank(rank: int, inputs: dict) -> dict:
    from repro_torch.core import sjpc
    from repro_torch.optim import compression

    state = sjpc.SJPCState(torch.from_numpy(inputs["counters"][rank]),
                           torch.tensor(inputs["n"][rank]),
                           torch.tensor(inputs["step"], dtype=torch.int32))
    reduced = sjpc.all_reduce(state)
    mean = compression.compressed_mean(torch.from_numpy(inputs["x"][rank]))
    cfg = sjpc.SJPCConfig(**SHARDED_CFG)
    params, _ = sjpc.init(cfg, device="cpu")
    sh = sjpc.ShardedIngest(cfg, params, group=dist.group.WORLD, device="cpu")
    for batch in inputs["batches"]:
        sh.ingest(batch)
    merged = sh.merged()
    return {"all_reduce": reduced, "input_unchanged": bool(torch.equal(
                state.counters, torch.from_numpy(inputs["counters"][rank]))),
            "compressed_mean": mean, "merged": merged, "mapped": sh.mapped,
            "delta": sh.deltas, "num_shards": sh.num_shards}


# -- the mesh file's ranks --------------------------------------------------

def capture_optimizer(opt, record: list):
    """``opt`` with each update's gradients copied into ``record`` first
    (the update clips them in place)."""
    from repro_torch.optim.adamw import Optimizer, local
    from repro_torch.tree import tree_leaves

    def update(grads, state, params):
        record.append([local(g).clone() for g in tree_leaves(grads)])
        return opt.update(grads, state, params)
    return Optimizer(opt.init, update)


def train_case(name: str, shards: int, group, rows: int, mesh=None, rank: int = 0,
               world: int = 1):
    """One step of a reduced config with AdamW, f32 compute and the
    monitor: (state after it, metrics, the gradients the optimizer got).
    With a ``mesh``, rank ``rank`` of ``world`` on its own rows."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.config import compute_dims
    from repro_torch.optim import make_adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.sketchstream.monitor import SketchMonitorConfig

    saved = moe.GROUP
    moe.GROUP = group or saved
    try:
        cfg = configs.reduced(name)
        dims = compute_dims(cfg, tp=1)
        mcfg = SketchMonitorConfig(**MONITOR, shards=shards)
        record: list = []
        opt = make_adamw(constant(1e-3))
        state, mparams = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims,
                                                opt, monitor_cfg=mcfg, device="cpu",
                                                mesh=mesh)
        step = train.make_train_step(cfg, dims, capture_optimizer(opt, record), mesh,
                                     monitor_cfg=mcfg, monitor_params=mparams, remat="full",
                                     ssm_chunk=8, compute_dtype=torch.float32)
        mine = rows // world
        batch = {k: torch.from_numpy(v[rank * mine:(rank + 1) * mine])
                 for k, v in train_batch(name, rows).items()}
        state, metrics = step(state, batch)
    finally:
        moe.GROUP = saved
    return state, {k: float(v) for k, v in metrics.items()}, record[0]


def mesh_rank(rank: int, ckpt_dir: str) -> dict:
    from repro_torch.checkpoint import chunked
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.adamw import local
    from repro_torch.optim.q8sharded import make_q8adam_sharded
    from repro_torch.optim.schedules import constant
    from repro_torch import configs
    from repro_torch.models.config import compute_dims
    from repro_torch.optim import make_adamw

    out: dict = {}
    mesh = make_debug_mesh(WORLD, 1, device_type="cpu")
    for case in TRAIN_CASES:
        state, metrics, grads = train_case(*case, mesh, rank, WORLD)
        out[case] = {
            "metrics": metrics, "grads": grads,
            "monitor": (local(state.monitor.counters), local(state.monitor.n))}

    cfg = configs.reduced("qwen2.5-3b")
    tp_mesh = make_debug_mesh(1, WORLD, device_type="cpu")
    try:
        train.make_train_step(cfg, compute_dims(cfg, tp=1), make_adamw(constant(1e-3)),
                              tp_mesh)
    except ValueError as err:
        out["dims_refused"] = str(err)

    for key, where, specs, dim in (
            ("q8", mesh, {"w": SH.PartitionSpec("data", None), "b": SH.PartitionSpec(None)}, 0),
            ("q8_tp", tp_mesh, {"w": SH.PartitionSpec(None, "model"),
                                "b": SH.PartitionSpec(None)}, 1)):
        # fresh arrays each run: a replicated leaf's DTensor holds the very
        # tensor it was given, which the update changes in place
        p0, target = q8_case()
        shard = SH.to_shardings(where, specs)
        params = {k: SH.distribute(torch.from_numpy(v), shard[k]) for k, v in p0.items()}
        tlocal = torch.from_numpy(target).chunk(WORLD, dim=dim)[rank]
        opt = make_q8adam_sharded(where, constant(0.05), specs, weight_decay=0.0)
        state = opt.init(params)
        for _ in range(Q8_STEPS):
            grads = q8_grads({k: local(v) for k, v in params.items()}, tlocal)
            params, state, _ = opt.update(grads, state, params)
        out[key] = {"params": {k: local(v) for k, v in params.items()},
                    "m": {k: tuple(local(x) for x in q) for k, q in state.m.items()},
                    "v": {k: tuple(local(x) for x in q) for k, q in state.v.items()},
                    "placements": {k: tuple(v.placements) for k, v in params.items()}}

    tree = restore_tree()
    rshard = {"w": SH.NamedSharding(mesh, SH.PartitionSpec("data", None)),
              "b": SH.NamedSharding(mesh, SH.PartitionSpec())}
    template = {k: torch.from_numpy(v) for k, v in tree.items()}
    restored, man = chunked.restore_checkpoint(ckpt_dir, template, shardings=rshard)
    out["restore"] = {"step": man.step,
                      "local": {k: v.to_local() for k, v in restored.items()},
                      "placements": {k: (tuple(v.placements), rshard[k].placements)
                                     for k, v in restored.items()},
                      "full": {k: v.full_tensor() for k, v in restored.items()}}
    return out


# -- JAX's sharded Q8Adam on two host devices (its own subprocess) ----------

def jax_q8_two_devices(path: str) -> None:
    """JAX's ``make_q8adam_sharded`` on two host devices, Q8_STEPS jitted
    steps on ``q8_case``: on a (data=2, model=1) mesh (keys as they are)
    and on (data=1, model=2), w's columns over model (keys prefixed
    ``tp_``); writes each run's params, codes and scales to ``path``
    (npz)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.launch.mesh import make_debug_mesh
    from repro.optim.q8sharded import make_q8adam_sharded
    from repro.optim.schedules import constant

    out = {}
    for prefix, shape, specs in (("", (2, 1), {"w": P("data", None), "b": P(None)}),
                                 ("tp_", (1, 2), {"w": P(None, "model"), "b": P(None)})):
        mesh = make_debug_mesh(*shape)
        p0, target = q8_case()
        params = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
                  for k, v in p0.items()}
        opt = make_q8adam_sharded(mesh, constant(0.05), specs, weight_decay=0.0)
        with compat.set_mesh(mesh):
            state = jax.jit(opt.init)(params)
            update = jax.jit(opt.update)
            for _ in range(Q8_STEPS):
                params, state, _ = update(q8_grads(params, jnp.asarray(target)), state, params)
        for k in params:
            out[f"{prefix}p_{k}"] = np.asarray(params[k])
            for moment in ("m", "v"):
                q = getattr(state, moment)[k]
                out[f"{prefix}{moment}_{k}_codes"] = np.asarray(q.codes)
                out[f"{prefix}{moment}_{k}_scales"] = np.asarray(q.scales)
    np.savez(path, **out)


def start_jax_q8_two_devices(path: Path) -> subprocess.Popen:
    """``jax_q8_two_devices(path)`` in a subprocess with two host devices
    (``XLA_FLAGS``, read when JAX starts); wait on it, then read ``path``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2").strip())
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join([str(here.parent / "src"), str(here),
                                         env.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, "-c",
                             "import sys, torch_rank_cases as c; "
                             "c.jax_q8_two_devices(sys.argv[1])", str(path)], env=env)
