"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, on any device: the
``torch_ref`` tier of its op in the kernel registry and the oracle of the
op's ``cuda_sm90`` tier.  Dispatch resolves CPU tensors to them; the tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against them on the card.  On the card they run only when a caller names
``impl="torch_ref"``.
"""
from __future__ import annotations

import math

import torch

from ..core import prng
from ..core.fingerprint import subvalue_fingerprints
from ..core.projections import padded_level_weights
from ..core.sketch import SketchParams, sketch_update


def fingerprint_ref(values, combo_masks, combo_ids, bases):
    """(B, d) records x (M, d) combination masks -> two (B, M) int64
    fingerprints."""
    return subvalue_fingerprints(values, combo_masks, combo_ids, bases)


def sketch_update_ref(counters, fp1, fp2, bucket_coeffs, sign_coeffs, weights):
    """Scatter-add Fast-AGMS update of one (t, w) int32 sketch from flat
    (fp1, fp2, weight) keys."""
    return sketch_update(counters, fp1, fp2, SketchParams(bucket_coeffs, sign_coeffs),
                         weights)


def fused_ingest_ref(counters, values, masks, ids, bases,
                     bucket_coeffs, sign_coeffs, weights):
    """The unfused fingerprint -> per-level scatter chain on the padded
    lattice tables.

    counters (L, t, w) int32; values (B, d) int64; masks (L, m_max, d);
    ids (L, m_max); bases (2,); bucket/sign_coeffs (L, t, 2, 4); weights
    (B, L, m_max) int32 (0 in padded slots and masked-out rows).
    """
    outs = []
    for lvl in range(counters.shape[0]):
        fp1, fp2 = subvalue_fingerprints(values, masks[lvl], ids[lvl], bases)
        outs.append(sketch_update_ref(counters[lvl], fp1, fp2, bucket_coeffs[lvl],
                                      sign_coeffs[lvl], weights[:, lvl, :]))
    return torch.stack(outs)


def sample_weights_ref(key, step, row_mask, batch, d, s, ratio):
    """(B, L, m_max) int32 sampling weights of every level s..d: the JAX
    package's ``sjpc._sample_level_weights`` padded as ``update_fused``
    pads them.  ``key`` is (2,) int64 key data; with ``step`` (an int32
    scalar tensor) the draws use ``fold_in(key, step)``; ``row_mask``
    ((B,) int32 or None) scales each row."""
    if step is not None:
        key = prng.fold_in(key, step)
    return padded_level_weights(key, batch, d, s, ratio, row_mask, key.device)


def sketch_moments_ref(counters_a, counters_b):
    """Row moments sum_j A*B of (..., t, w) int32 counters -> (..., t)
    float32, summed exactly in int64 and cast once.  Equal to the JAX f32
    reduction while partial sums stay below 2^24; closer to the int64
    oracle ``np_estimate_inner_exact`` above that."""
    prod = counters_a.to(torch.int64) * counters_b.to(torch.int64)
    return prod.sum(dim=-1).to(torch.float32)


def fused_query_ref(counters_a, counters_b):
    """Row moments of (N, L, t, w) int32 stacks -> (N, L, t) float32:
    :func:`sketch_moments_ref` over the leading dims, one implementation
    and one exactness contract."""
    return sketch_moments_ref(counters_a, counters_b)


# Pairs of one chunk of fused_pairs_ref: its (chunk, R, R) match tensor
# stays a few hundred MB (21 samples at R = 1,755).
PAIRS_CHUNK = 1 << 26


def fused_pairs_ref(items, valid):
    """All-pairs similarity histograms of stacked samples.

    items (N, R, d) integer words; valid (N, R) -> (N, d+1) int32:
    out[i, k] = the ordered pairs (a != b, both slots valid) of sample i
    whose records agree on exactly k columns.  Builds the (n, R, R) match
    count per chunk of samples, column by column, then bins it per level.
    """
    N, R, d = items.shape
    device = items.device
    out = torch.zeros((N, d + 1), dtype=torch.int32, device=device)
    if N * R == 0:
        return out
    live = valid != 0
    off_diagonal = ~torch.eye(R, dtype=torch.bool, device=device)
    step = max(1, PAIRS_CHUNK // (R * R))
    for lo in range(0, N, step):
        chunk = items[lo:lo + step]
        match = torch.zeros((chunk.shape[0], R, R), dtype=torch.int16, device=device)
        for c in range(d):
            match += chunk[:, :, None, c] == chunk[:, None, :, c]
        ok = live[lo:lo + step, :, None] & live[lo:lo + step, None, :] & off_diagonal
        match = torch.where(ok, match, -1)                    # -1 = masked out
        out[lo:lo + step] = torch.stack([(match == k).sum(dim=(1, 2)) for k in range(d + 1)],
                                        dim=1).to(torch.int32)
    return out


def flash_attention_ref(q, k, v, *, causal=True, block_q=512, block_k=512,
                        probs_dtype=torch.float32, return_lse=False):
    """Online-softmax chunked attention, model layout: q (B, Sq, H, hd),
    k/v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's dtype; with
    ``return_lse``, :func:`flash_attention_lse_ref`'s ``(out, lse)``.

    ``models.attention.chunked_attention`` is the semantic ground truth of
    the flash kernel, as in the JAX package (<= 1e-6 against it in f32).
    ``probs_dtype`` rounds P and V before ``P V``.  Imported lazily so
    that importing the kernels package never pulls in the models tree."""
    if return_lse:
        return flash_attention_lse_ref(q, k, v, causal=causal, block_q=block_q,
                                       block_k=block_k, probs_dtype=probs_dtype)
    from ..models.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, q_chunk=block_q, kv_chunk=block_k,
                             probs_dtype=probs_dtype)


def flash_attention_lse_ref(q, k, v, *, causal=True, block_q=512, block_k=512,
                            probs_dtype=torch.float32):
    """``(out, lse)``: :func:`flash_attention_ref`'s output, bit for bit,
    and the float32 (B, H, Sq) log-sum-exp ``m + log(l)`` of each query
    row's scaled scores (``inf`` for a row that sees no key), which the
    backward reads."""
    from ..models.attention import chunked_attention_lse
    return chunked_attention_lse(q, k, v, causal=causal, q_chunk=block_q, kv_chunk=block_k,
                                 probs_dtype=probs_dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, block_q=512,
                            block_k=512, probs_dtype=torch.float32):
    """The flash-attention backward: ``(dq, dk, dv)`` in the inputs' dtypes
    from the forward's ``out`` and ``lse`` and the cotangent ``dout``,
    recomputed tile by tile in float32 as the kernel does:

        D = rowsum(dO * O);  P = exp(S * scale - lse), 0 where masked;
        dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D);
        dQ = dS K * scale;  dK = dS^T Q * scale,

    dK and dV summed over the query heads of each KV group.  With
    ``probs_dtype`` bfloat16 the forward rounded P and V before ``P V``;
    here, as torch autograd does through ``chunked_attention``'s
    ``.to(probs_dtype).to(float32)``, V is rounded, P is rounded where dV
    reads it, dP is rounded, and so is dV once summed.  Tiles wholly above
    a causal diagonal are skipped (they add nothing)."""
    f32 = torch.float32
    b, sq, h, hd = q.shape
    skv, kv_h = k.shape[1], k.shape[2]
    g = h // kv_h
    scale = 1.0 / math.sqrt(hd)
    rounded = probs_dtype != f32

    def rnd(x):
        return x.to(probs_dtype).to(f32) if rounded else x

    qg = q.reshape(b, sq, kv_h, g, hd).to(f32)
    dog = dout.reshape(b, sq, kv_h, g, hd).to(f32)
    big_d = (dout.to(f32) * out.to(f32)).sum(-1).reshape(b, sq, kv_h, g).permute(0, 2, 3, 1)
    lse_g = lse.reshape(b, kv_h, g, sq)
    kf, vf = k.to(f32), rnd(v.to(f32))
    dq = torch.zeros_like(qg)
    dk = torch.zeros(kf.shape, dtype=f32, device=q.device)
    dv = torch.zeros(kf.shape, dtype=f32, device=q.device)
    block_q, block_k = max(1, min(block_q, sq)), max(1, min(block_k, skv))
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qb, dob = qg[:, q0:q1], dog[:, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        for k0 in range(0, skv, block_k):
            if causal and k0 >= q1:
                break
            k1 = min(k0 + block_k, skv)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kf[:, k0:k1]) * scale
            p = torch.exp(s - lse_g[..., q0:q1, None])
            if causal:
                p = torch.where(qpos >= torch.arange(k0, k1, device=q.device)[None, :], p, 0.0)
            dp = rnd(torch.einsum("bqkgh,bskh->bkgqs", dob, vf[:, k0:k1]))
            dv[:, k0:k1] += torch.einsum("bkgqs,bqkgh->bskh", rnd(p), dob)
            ds = p * (dp - big_d[..., q0:q1, None])
            dq[:, q0:q1] += torch.einsum("bkgqs,bskh->bqkgh", ds, kf[:, k0:k1])
            dk[:, k0:k1] += torch.einsum("bkgqs,bqkgh->bskh", ds, qb)
    return ((dq * scale).reshape(b, sq, h, hd).to(q.dtype), (dk * scale).to(k.dtype),
            rnd(dv).to(v.dtype))


def attention_grads_f64(q, k, v, dout, *, causal=True):
    """The exact gradients of softmax attention at the inputs, up to
    float64 rounding: ``(dq, dk, dv)`` float64 in the shapes of q, k and v,
    computed one (batch, query head) at a time (KV head ``h // (H / KV)``,
    its dk and dv summed over the group; causal masking top-left aligned).
    The backward kernel's accuracy is measured against it."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    f64 = torch.float64
    dq = torch.zeros(q.shape, dtype=f64, device=q.device)
    dk = torch.zeros(k.shape, dtype=f64, device=q.device)
    dv = torch.zeros(v.shape, dtype=f64, device=q.device)
    above = torch.ones(sq, skv, dtype=torch.bool, device=q.device).triu(1)
    for i in range(b):
        for head in range(h):
            j = head // g
            qh, doh = q[i, :, head].to(f64), dout[i, :, head].to(f64)
            kh, vh = k[i, :, j].to(f64), v[i, :, j].to(f64)
            s = qh @ kh.T * scale
            if causal:
                s = s.masked_fill(above, -math.inf)
            p = torch.softmax(s, -1)
            dv[i, :, j] += p.T @ doh
            dp = doh @ vh.T
            ds = p * (dp - (p * dp).sum(-1, keepdim=True))
            dq[i, :, head] = ds @ kh * scale
            dk[i, :, j] += ds.T @ qh * scale
    return dq, dk, dv
