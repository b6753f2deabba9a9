"""Serving steps on one card: prefill and single-token decode, the
greedy generation loop, and the sharded cache layouts.

The JAX package's ``launch/serve.py``.  Two cache sharding regimes:
  - ``decode_32k`` (batch >= data shards): batch over data axes, KV heads
    over model.
  - ``long_500k`` (batch < data shards): *sequence* over data axes.
``seq_sharded_mode`` and ``cache_shardings`` give the layouts;
``make_prefill`` and ``make_decode_step`` under a mesh, and
sequence-sharded decode, wait for tensor parallelism (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ArchConfig, Dims
from . import shardings as SH
from .mesh import data_shards


def seq_sharded_mode(mesh, batch: int) -> bool:
    return mesh is not None and batch < data_shards(mesh)


def make_prefill(cfg: ArchConfig, dims: Dims, *, ssm_chunk: int = 128, attn_chunk: int = 2048,
                 compute_dtype=torch.bfloat16, impl: str | None = None):
    def prefill_fn(params, tokens, enc_feats=None):
        return M.prefill(params, cfg, dims, tokens, enc_feats=enc_feats,
                         compute_dtype=compute_dtype, ssm_chunk=ssm_chunk,
                         attn_chunk=attn_chunk, impl=impl)
    return prefill_fn


def make_decode_step(cfg: ArchConfig, dims: Dims, *, compute_dtype=torch.bfloat16):
    def decode_fn(params, token, cache):
        return M.decode_step(params, cfg, dims, token, cache, compute_dtype=compute_dtype)
    return decode_fn


def greedy_generate(params, cfg: ArchConfig, dims: Dims, prompt, steps: int, *,
                    max_len: int | None = None, compute_dtype=torch.float32,
                    ssm_chunk: int = 8, enc_feats=None, impl: str | None = None):
    """Prefill the prompt (B, S) into a padded cache, then greedy-decode
    ``steps`` tokens.  Returns (B, steps) int32 tokens.  ``enc_feats``
    (B, S_src, d) feed an encoder-decoder's encoder; ``impl`` names the
    prefill's flash-attention implementation (None: by device)."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    src_len = enc_feats.shape[1] if enc_feats is not None else 0
    logits, pcache = M.prefill(params, cfg, dims, prompt, enc_feats=enc_feats,
                               compute_dtype=compute_dtype, ssm_chunk=ssm_chunk, impl=impl)
    cache = _rebase_cache(M.init_cache(cfg, dims, b, max_len, src_len, dtype=compute_dtype,
                                       device=device), pcache, s)
    del pcache
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = M.decode_step(params, cfg, dims, tok, cache,
                                      compute_dtype=compute_dtype)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def _rebase_cache(empty: M.Cache, pcache: M.Cache, prompt_len: int) -> M.Cache:
    """Copy the prefill's K/V (length S) into the front of the max_len
    decode cache, in place; carry the mamba states and the cross memories
    through, cast to the empty cache's dtype where the shapes match (a
    leaf of another shape is taken as the prefill made it)."""
    def merge(e, p, name=None):
        if isinstance(e, dict):
            return {key: merge(e[key], p[key], key) for key in e}
        if isinstance(e, (list, tuple)):
            return type(e)(merge(a, b, name) for a, b in zip(e, p))
        if name in ("k", "v"):                          # (layers, B, S, KV, hd)
            e[:, :, :prompt_len] = p.to(e.dtype)
            return e
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
