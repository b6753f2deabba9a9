"""The multi-rank half of ``tests/test_torch_tp_serve.py``: tensor-parallel
serving on gloo ranks on the CPU, and the inputs the ranks share with the
parent test.

Each rank builds a mesh over its world, cuts its blocks of a reduced
config's parameters from the full tree (``launch.shardings.local_blocks``
of ``param_shardings``), and runs ``make_prefill(mesh=)`` on the whole
batch's prompt, re-bases the prefill's cache into its block of the
decode cache (``serve.init_cache``, ``serve._rebase_cache``) and
greedy-decodes ``STEPS`` tokens with ``make_decode_step(mesh=)``, every
layer's output held equal across the model group (``check_replicated``).
It keeps the logits, tokens and its cache blocks for the parent to
assemble and hold against the JAX package's meshless ``prefill`` and
``decode_step``.  The parameters come from the parent (the JAX package's
``init_params`` as numpy, in ``params.pt``), which it writes once the
ranks have started; the ranks wait for the file.  This module imports no
JAX.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-370m", "jamba-1.5-large-398b",
         "seamless-m4t-large-v2")
B, PROMPT, SRC, STEPS, MAX_LEN = 4, 8, 8, 4, 16
PARAMS_WAIT_S = 180
# (mesh (data, model), configs, batch) of each world's ranks
CASES = {2: (((1, 2), ARCHS, B), ((2, 1), ("qwen2.5-3b",), 1)),
         4: (((2, 2), ("qwen2.5-3b", "deepseek-moe-16b"), B),)}
ONE_RANK = ARCHS


def prompts(batch: int, vocab: int = 256) -> np.ndarray:
    rng = np.random.default_rng(2701)
    return rng.integers(0, vocab, size=(B, PROMPT), dtype=np.int32)[:batch]


def frames(cfg, batch: int):
    """Frontend frames (batch, SRC, d) for an encoder-decoder, else None."""
    if not cfg.is_encdec:
        return None
    rng = np.random.default_rng(2702)
    return rng.normal(size=(B, SRC, cfg.d_model)).astype(np.float32)[:batch]


def tp_of(mesh_shape) -> int:
    return mesh_shape[1]


NAMES = ("data", "model")


def assemble(blocks, spec, shape):
    """The whole tensor from every rank's block under ``spec`` on a
    (data, model) mesh of ``shape``; blocks that hold the same region
    (replicas) must be equal bit for bit."""
    from repro_torch.launch.mesh import AbstractMesh, coordinate
    from repro_torch.launch.tensor_parallel import same_on_every_rank

    mesh = AbstractMesh(shape, NAMES)
    sizes = dict(zip(NAMES, shape))
    axes = [() if e is None else (e if isinstance(e, tuple) else (e,)) for e in spec]
    full_shape = [n * math.prod(sizes[a] for a in ax) for n, ax in zip(blocks[0].shape, axes)]
    full = torch.empty(full_shape, dtype=blocks[0].dtype)
    seen = {}
    for rank, block in enumerate(blocks):
        where = coordinate(mesh, rank)
        region = []
        for n, ax in zip(block.shape, axes):
            index = 0
            for a in ax:
                index = index * sizes[a] + where[a]
            region.append(slice(index * n, (index + 1) * n))
        key = tuple((s.start, s.stop) for s in region)
        if key in seen:
            assert same_on_every_rank([seen[key], block]), (spec, rank)
        seen[key] = block
        full[tuple(region)] = block
    assert len(seen) == math.prod(math.prod(sizes[a] for a in ax) for ax in axes)
    return full


def wait_for(path: Path):
    deadline = time.monotonic() + PARAMS_WAIT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def serve_case(cfg, dims, params, mesh, batch: int):
    """Prefill, re-base and ``STEPS`` greedy decode steps on ``mesh``:
    {"logits": per step (B, 1, V), "tokens": (B, STEPS), "rebased" and
    "final": the rank's cache blocks}."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_map

    tokens = torch.from_numpy(prompts(batch))
    feats = frames(cfg, batch)
    feats = None if feats is None else torch.from_numpy(feats)
    prefill = serve.make_prefill(cfg, dims, mesh, compute_dtype=torch.float32,
                                 check_replicated=True)
    decode = serve.make_decode_step(cfg, dims, mesh, compute_dtype=torch.float32,
                                    check_replicated=True)
    logits, pcache = prefill(params, tokens, feats)
    src = 0 if feats is None else SRC
    empty = serve.init_cache(cfg, dims, batch, MAX_LEN, src, mesh, dtype=torch.float32,
                             device="cpu")
    cache = serve._rebase_cache(empty, pcache, PROMPT,
                                seq_block=None if mesh is None else serve.seq_block(mesh, batch))
    out = {"logits": [logits], "rebased": tree_map(torch.clone, cache.groups)}
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    toks = [tok]
    for _ in range(STEPS):
        logits, cache = decode(params, tok, cache)
        out["logits"].append(logits)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        toks.append(tok)
    out["tokens"] = torch.cat(toks, dim=1)
    out["final"] = cache.groups
    out["lens"] = cache.lens
    return out


def tp_rank(rank: int, params_file: str, world: int) -> dict:
    """Every case of ``CASES[world]`` on this rank."""
    from repro_torch import configs, convert
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import tensor_parallel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import compute_dims

    carried = wait_for(Path(params_file))
    out = {}
    for shape, archs, batch in CASES[world]:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        for name in archs:
            cfg = configs.reduced(name)
            dims = compute_dims(cfg, tp=tp_of(shape))
            full = convert.model_params_from_numpy(carried[name, tp_of(shape)], device="cpu")
            blocks = SH.local_blocks(full, SH.param_shardings(mesh, M.param_axes(full)), rank)
            before = tensor_parallel.checks
            res = serve_case(cfg, dims, blocks, mesh, batch)
            res["checks"] = tensor_parallel.checks - before
            out[shape, name] = res
        if batch < shape[0]:
            try:
                from repro_torch.launch import serve
                serve.init_cache(cfg, dims, batch, MAX_LEN - 1, 0, mesh, device="cpu")
            except ValueError as err:
                out[shape, "max_len"] = str(err)
    return out


def one_rank(rank: int) -> dict:
    """At a (1, 1) mesh every config's serving equals the port's meshless
    serving bit for bit (the port's own random parameters)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import compute_dims
    from repro_torch.tree import tree_leaves

    mesh = make_debug_mesh(1, 1, device_type="cpu")
    out = {}
    for name in ONE_RANK:
        cfg = configs.reduced(name)
        dims = compute_dims(cfg, tp=1)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, dims, device="cpu")
        got = serve_case(cfg, dims, params, mesh, B)
        want = serve_case(cfg, dims, params, None, B)
        leaves = lambda r: ([r["tokens"], r["lens"]] + r["logits"]  # noqa: E731
                            + tree_leaves(r["rebased"]) + tree_leaves(r["final"]))
        a, b = leaves(got), leaves(want)
        out[name] = {"leaves": len(a), "equal": len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))}
    return out
