"""Serving steps: prefill and single-token decode, one process or one
rank of a mesh, the greedy generation loop, and the sharded cache
layouts.

The JAX package's ``launch/serve.py``.  Two cache sharding regimes
(``cache_shardings``, from ``launch.shardings.cache_pspecs``):
  - ``decode_32k`` (batch >= data shards): batch over the data axes, KV
    heads over model.
  - ``long_500k`` (batch < data shards): *sequence* over the data axes;
    decode all-gathers the score vector over them (tiny beside the cache
    it avoids replicating), and only P . V is a partial summed over them.

Under a ``mesh`` (``launch/mesh.py``, shaped (data, model) or (pod, data,
model)) ``make_prefill`` and ``make_decode_step`` compute, on every rank,
the rank's part of the function the JAX package's meshless
``prefill``/``decode_step`` compute at the same ``Dims``
(``compute_dims(cfg, tp=<model axis size>)``), as GSPMD splits it:
  - ``params`` are the rank's blocks (plain tensors or DTensors) in the
    layout of ``shardings.param_shardings(mesh, param_axes(params))``, the
    train state's, so a checkpoint restored with
    ``restore_checkpoint(shardings=)`` serves as it is: "embed" and
    "embed_out" over the batch axes (FSDP, gathered one layer at a time),
    heads, kv, mlp, vocab, experts and ssm_heads over ``model``
    (``launch/tensor_parallel.py``);
  - the cache is the rank's block of ``cache_shardings``'s layout, from
    :func:`init_cache` and :func:`_rebase_cache`;
  - tokens and logits are the whole batch's, the same on every rank (as a
    JAX global array is): each rank runs its rows (every row under
    ``long_500k``) and the logits' rows are all-gathered over the batch
    axes.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ArchConfig, Dims
from ..optim.adamw import local
from ..tree import tree_map
from . import shardings as SH
from .data_parallel import DataParallel, gather_forward
from .mesh import data_shards, mesh_groups
from .tensor_parallel import TensorParallel


def seq_sharded_mode(mesh, batch: int) -> bool:
    return mesh is not None and batch < data_shards(mesh)


def _parallel(mesh, batch: int, split_dims=None, check: bool = False):
    """This rank's (TensorParallel, DataParallel, rows) for a batch of
    ``batch`` rows on ``mesh``: its slice of the batch's rows (all of them
    when the cache is sequence-sharded)."""
    groups = mesh_groups(mesh)
    seq = seq_sharded_mode(mesh, batch)
    tp = TensorParallel(groups.model, check=check)
    dp = DataParallel(split_dims, groups.batch, seq_sharded=seq)
    if seq:
        return tp, dp, slice(None)
    if batch % dp.world:
        raise ValueError(f"a batch of {batch} does not split over {dp.world} data shards")
    rows = batch // dp.world
    return tp, dp, slice(dp.rank * rows, (dp.rank + 1) * rows)


def _placed(mesh, params, batch: int, check: bool):
    """The rank's parameter blocks as plain tensors, and :func:`_parallel`
    with the FSDP dim of every leaf."""
    params = tree_map(local, params)
    specs = SH.param_pspecs(mesh, M.param_axes(params))
    split = tree_map(lambda spec: SH.batch_dim(mesh, spec), specs, is_leaf=SH.is_pspec)
    return (params,) + _parallel(mesh, batch, split, check)


def _all_rows(logits, dp: DataParallel):
    return logits if dp.seq_sharded else gather_forward(logits, 0, dp.group)


def make_prefill(cfg: ArchConfig, dims: Dims, mesh=None, *, ssm_chunk: int = 128,
                 attn_chunk: int = 2048, compute_dtype=torch.bfloat16, impl: str | None = None,
                 check_replicated: bool = False):
    """``prefill_fn(params, tokens, enc_feats=None) -> (logits, cache)``.
    Under a ``mesh`` see the module docstring: the returned cache is the
    rank's heads and rows at the prompt's length (every row under
    ``long_500k``), which :func:`_rebase_cache` places into the rank's
    block of the decode cache.  ``check_replicated`` holds every layer's
    output equal, bit for bit, across the model group."""
    def prefill_fn(params, tokens, enc_feats=None):
        if mesh is None:
            return M.prefill(params, cfg, dims, tokens, enc_feats=enc_feats,
                             compute_dtype=compute_dtype, ssm_chunk=ssm_chunk,
                             attn_chunk=attn_chunk, impl=impl)
        params, tp, dp, rows = _placed(mesh, params, tokens.shape[0], check_replicated)
        logits, cache = M.prefill(params, cfg, dims, tokens[rows],
                                  enc_feats=None if enc_feats is None else enc_feats[rows],
                                  compute_dtype=compute_dtype, ssm_chunk=ssm_chunk,
                                  attn_chunk=attn_chunk, impl=impl, tp=tp, dp=dp)
        return _all_rows(logits, dp), cache
    return prefill_fn


def make_decode_step(cfg: ArchConfig, dims: Dims, mesh=None, *, compute_dtype=torch.bfloat16,
                     check_replicated: bool = False):
    """``decode_fn(params, token, cache) -> (logits, cache)``; under a
    ``mesh`` ``token`` (B, 1) and the logits are the whole batch's and
    ``cache`` the rank's block (module docstring)."""
    def decode_fn(params, token, cache):
        if mesh is None:
            return M.decode_step(params, cfg, dims, token, cache, compute_dtype=compute_dtype)
        params, tp, dp, rows = _placed(mesh, params, token.shape[0], check_replicated)
        token = token[rows]
        if cache.lens.shape[0] != token.shape[0]:
            raise ValueError(f"a cache block of {cache.lens.shape[0]} rows for this rank's "
                             f"{token.shape[0]}")
        logits, cache = M.decode_step(params, cfg, dims, token, cache,
                                      compute_dtype=compute_dtype, tp=tp, dp=dp)
        return _all_rows(logits, dp), cache
    return decode_fn


def init_cache(cfg: ArchConfig, dims: Dims, batch: int, max_len: int, src_len: int = 0,
               mesh=None, *, dtype=torch.bfloat16, device=None) -> M.Cache:
    """The zero decode cache of ``batch`` rows and ``max_len`` positions,
    or under a ``mesh`` this rank's block of it (``cache_shardings``'s
    layout)."""
    if mesh is None:
        return M.init_cache(cfg, dims, batch, max_len, src_len, dtype=dtype, device=device)
    tp, dp, _ = _parallel(mesh, batch)
    return M.init_cache(cfg, dims, batch, max_len, src_len, dtype=dtype, device=device,
                        tp=tp, dp=dp)


def seq_block(mesh, batch: int) -> int | None:
    """The rank's index along the batch axes when a batch of ``batch``
    rows has a sequence-sharded cache on ``mesh``, else None (the
    ``seq_block`` of :func:`_rebase_cache`)."""
    return mesh_groups(mesh).batch_index if seq_sharded_mode(mesh, batch) else None


def greedy_generate(params, cfg: ArchConfig, dims: Dims, prompt, steps: int, *,
                    max_len: int | None = None, compute_dtype=torch.float32,
                    ssm_chunk: int = 8, enc_feats=None, impl: str | None = None, mesh=None):
    """Prefill the prompt (B, S) into a padded cache, then greedy-decode
    ``steps`` tokens.  Returns (B, steps) int32 tokens.  ``enc_feats``
    (B, S_src, d) feed an encoder-decoder's encoder; ``impl`` names the
    prefill's flash-attention implementation (None: by device); under a
    ``mesh`` every rank passes the whole prompt and its parameter blocks
    and gets the whole batch's tokens."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    src_len = enc_feats.shape[1] if enc_feats is not None else 0
    prefill = make_prefill(cfg, dims, mesh, ssm_chunk=ssm_chunk, compute_dtype=compute_dtype,
                           impl=impl)
    decode = make_decode_step(cfg, dims, mesh, compute_dtype=compute_dtype)
    logits, pcache = prefill(params, prompt, enc_feats)
    cache = _rebase_cache(init_cache(cfg, dims, b, max_len, src_len, mesh, dtype=compute_dtype,
                                     device=device), pcache, s,
                          seq_block=None if mesh is None else seq_block(mesh, b))
    del pcache
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def _rebase_cache(empty: M.Cache, pcache: M.Cache, prompt_len: int, *,
                  seq_block: int | None = None) -> M.Cache:
    """Copy the prefill's K/V (length S) into the front of the max_len
    decode cache, in place; carry the mamba states and the cross memories
    through, cast to the empty cache's dtype where the shapes match (a
    leaf of another shape is taken as the prefill made it).

    ``seq_block`` (a rank of a sequence-sharded cache, :func:`seq_block`):
    ``empty`` holds that block of the positions, [seq_block * S_block,
    (seq_block + 1) * S_block), and of the memory's source positions;
    the block's part of the prompt goes to its front."""
    def merge(e, p, name=None):
        if isinstance(e, dict):
            return {key: merge(e[key], p[key], key) for key in e}
        if isinstance(e, (list, tuple)):
            return type(e)(merge(a, b, name) for a, b in zip(e, p))
        if name in ("k", "v") and seq_block is None:      # (layers, B, S, KV, hd)
            e[:, :, :prompt_len] = p.to(e.dtype)
            return e
        if name in ("k", "v"):
            start = seq_block * e.shape[2]
            n = max(0, min(prompt_len - start, e.shape[2]))
            e[:, :, :n] = p[:, :, start:start + n].to(e.dtype)
            return e
        if name in ("mk", "mv") and seq_block is not None:
            start = seq_block * e.shape[2]
            return e.copy_(p[:, :, start:start + e.shape[2]])
        if e.shape == p.shape:
            return e.copy_(p)
        return p

    return M.Cache(groups=merge(empty.groups, pcache.groups), lens=pcache.lens)


def cache_shardings(mesh, cfg: ArchConfig, dims: Dims, batch: int, max_len: int,
                    src_len: int = 0, dtype=torch.bfloat16, layout: str = "auto"):
    """(abstract cache on the ``meta`` device, ``NamedSharding`` tree).

    layout: "auto" picks seq-sharding when batch < data shards;
    "batch"/"seq" force a regime."""
    abstract = M.init_cache(cfg, dims, batch, max_len, src_len, dtype=dtype, device="meta")
    seq = seq_sharded_mode(mesh, batch) if layout == "auto" else layout == "seq"
    return abstract, SH.to_shardings(mesh, SH.cache_pspecs(mesh, abstract, seq_sharded=seq))
