"""Serving steps on one card: prefill and single-token decode, and the
greedy generation loop.

The JAX package's ``launch/serve.py`` without a mesh: the sharded cache
layouts (``seq_sharded_mode``, ``cache_shardings``) come with a
multi-card slice (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ArchConfig, Dims


def make_prefill(cfg: ArchConfig, dims: Dims, *, attn_chunk: int = 2048,
                 compute_dtype=torch.bfloat16, impl: str | None = None):
    def prefill_fn(params, tokens):
        return M.prefill(params, cfg, dims, tokens, compute_dtype=compute_dtype,
                         attn_chunk=attn_chunk, impl=impl)
    return prefill_fn


def make_decode_step(cfg: ArchConfig, dims: Dims, *, compute_dtype=torch.bfloat16):
    def decode_fn(params, token, cache):
        return M.decode_step(params, cfg, dims, token, cache, compute_dtype=compute_dtype)
    return decode_fn


def greedy_generate(params, cfg: ArchConfig, dims: Dims, prompt, steps: int, *,
                    max_len: int | None = None, compute_dtype=torch.float32,
                    impl: str | None = None):
    """Prefill the prompt (B, S) into a padded cache, then greedy-decode
    ``steps`` tokens.  Returns (B, steps) int32 tokens.  ``impl`` names the
    prefill's flash-attention implementation (None: by device)."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    logits, pcache = M.prefill(params, cfg, dims, prompt, compute_dtype=compute_dtype,
                               impl=impl)
    cache = _rebase_cache(M.init_cache(cfg, dims, b, max_len, dtype=compute_dtype,
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
    decode cache, in place."""
    for egroup, pgroup in zip(empty.groups, pcache.groups):
        for ecache, pc in zip(egroup, pgroup):
            for name in ("k", "v"):                   # (layers, B, S, KV, hd)
                ecache[name][:, :, :prompt_len] = pc[name].to(ecache[name].dtype)
    return M.Cache(groups=empty.groups, lens=pcache.lens)
