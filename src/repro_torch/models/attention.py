"""GQA attention: full, chunked online-softmax, and KV-cache decode.

The JAX package's ``models/attention.py`` in PyTorch, in its grouped query
layout (KV heads stay a separate dimension; they are never repeated).
Sequences longer than :data:`CHUNKED_THRESHOLD` go where the JAX package
runs :func:`chunked_attention`: to ``kernels.ops.flash_attention``, whose
plain version *is* :func:`chunked_attention` and whose CUDA kernel runs on
the card.  Shorter sequences and decode run :func:`full_attention` in
plain PyTorch, as the JAX package runs them outside any Pallas kernel.

Every dot product is taken in float32 (bf16 operands are widened first,
which is exact), as the JAX package asks with ``preferred_element_type``.
Cross-attention reads keys and values of an encoder memory
(``attention_block``'s ``kv_override``; :func:`decode_cross_attention_block`).

Under tensor parallelism (``tp=``, a ``launch.tensor_parallel
.TensorParallel``) a block runs on the rank's contiguous block of the
query heads and of the KV heads (``wq``/``wk``/``wv`` column-parallel),
its head counts read from the tensors, and ``wo`` is row-parallel: its
partial output is summed over the model group.  Under the
``long_500k`` cache regime (``dp=`` with ``seq_sharded``) each rank of the
batch axes holds its block of the cache's positions, and decode attention
all-gathers its scores (:func:`full_attention`'s ``seq``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .config import Dims
from .layers import apply_rope, dense_init, zeros_init

NEG_INF = -1e30


def init_attention(generator: torch.Generator, dims: Dims, *, cross: bool = False,
                   device) -> dict:
    """Projections of one attention block; a cross-attention block
    (``cross``) has no biases."""
    cfg = dims.cfg
    d, h, kv, hd = cfg.d_model, dims.heads, dims.kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, h, hd), device=device),
        "wk": dense_init(generator, (d, kv, hd), device=device),
        "wv": dense_init(generator, (d, kv, hd), device=device),
        "wo": dense_init(generator, (h, hd, d), scale=1.0 / np.sqrt(h * hd), device=device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = zeros_init((h, hd), device=device)
        p["bk"] = zeros_init((kv, hd), device=device)
        p["bv"] = zeros_init((kv, hd), device=device)
    return p


def _project_q(params, x, positions, theta, *, rope=True):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    return apply_rope(q, positions, theta) if rope else q


def _project_kv(params, x, positions, theta, *, rope=True):
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return (apply_rope(k, positions, theta) if rope else k), v


def _grouped(q, kv_heads):
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def _check_heads(q, k, dims: Dims) -> None:
    """Heads group as (kv, g) with kv outer (:func:`_grouped`), so a
    contiguous block of the query heads and of the KV heads keeps every
    group whole on its rank exactly when the block keeps the model's
    ratio of query heads to KV heads."""
    if q.shape[2] * dims.kv_heads != k.shape[2] * dims.heads:
        raise ValueError(f"{q.shape[2]} query heads and {k.shape[2]} KV heads split the "
                         f"model's groups of {dims.heads} over {dims.kv_heads}")


def full_attention(q, k, v, *, causal: bool, q_offset=0, kv_valid=None,
                   probs_dtype=torch.float32, seq=None):
    """Dense attention.  q (B,Sq,H,hd); k,v (B,Skv,KV,hd).

    kv_valid: optional (B, Skv) bool mask of valid cache slots.
    q_offset: absolute position of q[:, 0] (for causal masking vs a cache).
    probs_dtype: the type the probabilities are rounded to before the
    product with V; the softmax itself is float32.
    seq: the ``launch.data_parallel.DataParallel`` of a sequence-sharded
    cache (k, v are this rank's block of the positions, the ranks' blocks
    in rank order): the masked scores are all-gathered, so the softmax is
    the one-process softmax over every position, and only the product
    with this rank's V block is a partial, summed over the ranks.
    """
    kv_h = k.shape[2]
    qg = _grouped(q, kv_h)                                # (B,Sq,KV,G,hd)
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    sq, skv = scores.shape[-2], scores.shape[-1]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, None, :], scores, NEG_INF)
    if seq is None:
        probs = torch.softmax(scores, dim=-1).to(probs_dtype)
    else:
        probs = torch.softmax(seq.gather_scores(scores), dim=-1).to(probs_dtype)
        probs = probs[..., seq.rank * skv:(seq.rank + 1) * skv]
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(torch.float32),
                       v.to(probs_dtype).to(torch.float32))
    if seq is not None:
        out = seq.sum(out)
    b, sq_, kvh, g, hd = out.shape
    return out.reshape(b, sq_, kvh * g, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 2048,
                      kv_chunk: int = 2048, probs_dtype=torch.float32):
    """Flash-style online-softmax attention, O(S * chunk) memory: the
    plain version of the ``flash_attention`` kernel.  Loops over
    (q-chunk, kv-chunk) tiles where the JAX package scans; like it, it
    computes every tile, the causally masked ones included."""
    return chunked_attention_lse(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                 probs_dtype=probs_dtype)[0]


def chunked_attention_lse(q, k, v, *, causal: bool, q_chunk: int = 2048,
                          kv_chunk: int = 2048, probs_dtype=torch.float32):
    """:func:`chunked_attention` and the log-sum-exp of each query row's
    scaled scores, ``m + log(l)``, float32 (B, H, Sq); ``inf`` for a row
    that sees no key, so that ``exp(s - lse)`` is 0 there."""
    b, sq, h, hd = q.shape
    skv, kv_h = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if q_chunk <= 0 or kv_chunk <= 0 or sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not tile ({sq}, {skv})")
    nq, nk = sq // q_chunk, skv // kv_chunk
    g = h // kv_h
    scale = 1.0 / np.sqrt(hd)
    dev = q.device

    qg = _grouped(q, kv_h).reshape(b, nq, q_chunk, kv_h, g, hd).to(torch.float32)
    kc = k.reshape(b, nk, kv_chunk, kv_h, hd).to(torch.float32)
    vc = v.reshape(b, nk, kv_chunk, kv_h, hd).to(probs_dtype).to(torch.float32)

    outs, lses = [], []
    for qi in range(nq):
        qblock = qg[:, qi]                                # (B, Cq, KV, G, hd)
        m = torch.full((b, kv_h, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kv_h, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv_h, g, q_chunk, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bqkgh,bskh->bkgqs", qblock, kc[:, ki]) * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
                s = torch.where(qpos >= kpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (m_new stays at NEG_INF)
            p = torch.exp(s - m_new[..., None])
            p = torch.where((m_new > 0.5 * NEG_INF)[..., None], p, 0.0)
            alpha = torch.where(m > 0.5 * NEG_INF, torch.exp(m - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(probs_dtype).to(torch.float32), vc[:, ki])
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])   # (B,KV,G,Cq,hd)
        lses.append(torch.where(m > 0.5 * NEG_INF, m + torch.log(l), torch.inf))
    # (nq, B, KV, G, Cq, hd) -> (B, nq, Cq, KV, G, hd) -> (B, S, H, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd).to(q.dtype)
    # (nq, B, KV, G, Cq) -> (B, KV, G, nq, Cq) -> (B, H, Sq)
    return out, torch.stack(lses).permute(1, 2, 3, 0, 4).reshape(b, h, sq)


CHUNKED_THRESHOLD = 8192


def attention_block(params, x, dims: Dims, positions, *, causal=True, kv_override=None,
                    rope=True, chunk: int = 2048, probs_dtype=torch.float32,
                    impl: str | None = None, tp=None):
    """Full train/prefill attention over x (B, S, d).  Returns (out, (k, v)).

    ``kv_override`` (B, S_src, d) is the memory the keys and values are
    projected from (cross-attention), at positions 0..S_src-1.  When
    either length exceeds :data:`CHUNKED_THRESHOLD` it runs
    ``ops.flash_attention`` with ``chunk`` as its q/kv tiles (``impl``
    names its implementation; None goes by the device); otherwise
    :func:`full_attention`.  Both take ``probs_dtype``, and both are
    differentiable: the flash op's backward is its own kernel op,
    ``flash_attention_bwd``.  ``tp``: the rank's heads (module docstring).
    """
    cfg = dims.cfg
    if tp is not None:
        x = tp.copy(x)
        kv_override = None if kv_override is None else tp.copy(kv_override)
    q = _project_q(params, x, positions, cfg.rope_theta, rope=rope)
    src = x if kv_override is None else kv_override
    kv_pos = positions if kv_override is None else torch.arange(
        src.shape[1], dtype=torch.int32, device=src.device)[None].expand(src.shape[:2])
    k, v = _project_kv(params, src, kv_pos, cfg.rope_theta, rope=rope)
    _check_heads(q, k, dims)
    if x.shape[1] > CHUNKED_THRESHOLD or src.shape[1] > CHUNKED_THRESHOLD:
        out = ops.flash_attention(q, k, v, causal=causal, block_q=chunk, block_k=chunk,
                                  probs_dtype=probs_dtype, impl=impl)
    else:
        out = full_attention(q, k, v, causal=causal, probs_dtype=probs_dtype)
    return _out_proj(params, out, tp), (k, v)


def _out_proj(params, out, tp):
    """``wo``: row-parallel under ``tp`` (the partial summed)."""
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out if tp is None else tp.reduce(out)


def _seq(dp):
    """``dp`` when it marks a sequence-sharded cache, else None."""
    return dp if dp is not None and dp.seq_sharded else None


def decode_attention_block(params, x, dims: Dims, cache_k, cache_v, lens, *, tp=None,
                           dp=None):
    """One-token decode against a cache.

    x: (B, 1, d); cache_k/v: (B, S_max, KV, hd); lens: (B,) current lengths.
    Writes the new token's K/V into the caches **in place** (the JAX
    package returns updated copies) and returns (out (B,1,d), cache_k,
    cache_v).  ``tp``: the rank's heads.  ``dp`` with ``seq_sharded``:
    cache_k/v are this rank's contiguous block of the positions, rank r of
    the batch group holding positions [r * S_block, (r + 1) * S_block).
    """
    cfg = dims.cfg
    b, smax = cache_k.shape[0], cache_k.shape[1]
    if tp is not None:
        x = tp.copy(x)
    positions = lens[:, None]                                     # (B, 1)
    q = _project_q(params, x, positions, cfg.rope_theta)
    k_new, v_new = _project_kv(params, x, positions, cfg.rope_theta)
    _check_heads(q, cache_k, dims)
    batch_idx = torch.arange(b, device=x.device)
    seq = _seq(dp)
    if seq is None:
        cache_k[batch_idx, lens] = k_new[:, 0].to(cache_k.dtype)
        cache_v[batch_idx, lens] = v_new[:, 0].to(cache_v.dtype)
        valid = torch.arange(smax, device=x.device)[None, :] <= lens[:, None]
    else:
        # only the owner of position lens[b] writes the new row; validity
        # is by global position
        start = seq.rank * smax
        slot = lens - start
        own = ((slot >= 0) & (slot < smax))[:, None, None]
        slot = slot.clamp(0, smax - 1)
        cache_k[batch_idx, slot] = torch.where(own, k_new[:, 0].to(cache_k.dtype),
                                               cache_k[batch_idx, slot])
        cache_v[batch_idx, slot] = torch.where(own, v_new[:, 0].to(cache_v.dtype),
                                               cache_v[batch_idx, slot])
        valid = start + torch.arange(smax, device=x.device)[None, :] <= lens[:, None]
    out = full_attention(q, cache_k, cache_v, causal=False, kv_valid=valid, seq=seq)
    return _out_proj(params, out, tp), cache_k, cache_v


def decode_cross_attention_block(params, x, dims: Dims, mem_k, mem_v, *, tp=None, dp=None):
    """Cross-attention during decode: the static encoder memory's K/V
    (B, S_src, KV, hd), no cache write, the query not rotated.  ``tp``
    and ``dp`` as for :func:`decode_attention_block` (a sequence-sharded
    memory holds this rank's block of the source positions)."""
    if tp is not None:
        x = tp.copy(x)
    q = _project_q(params, x, None, dims.cfg.rope_theta, rope=False)
    _check_heads(q, mem_k, dims)
    out = full_attention(q, mem_k, mem_v, causal=False, seq=_seq(dp))
    return _out_proj(params, out, tp)
