"""Flash attention (forward; the backward is :mod:`.flash_attention_bwd`):
the CUDA kernels ``csrc/flash_attention_f32.cu`` (float32 at f32
precision on the tensor cores, from operands split into three bf16 parts)
and ``csrc/flash_attention_tc.cu`` (bfloat16, probabilities kept at f32
precision unless ``probs_dtype`` asks for bf16), both on wgmma and TMA,
and their wrapper.

Replaces the Pallas TPU kernel ``flash_attention_pallas`` (and its
model-layout wrapper ``flash_attention``) of the JAX package.  This is the
op's ``cuda_sm90`` tier in the kernel registry (``kernels/ops.py``); its
oracle is :func:`.ref.flash_attention_ref`.  It takes CUDA tensors only,
launches a kernel or raises; the input dtype picks the kernel.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0      # launches of the float32 kernel since the last reset
tc_launches = 0   # launches of the bfloat16 kernel since the last reset

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
Q_TILE = 128                # query rows per CTA of either kernel
MAX_Q_TILES = 65535         # the grid's y limit
PARTS = 3                   # bf16 parts of each f32 operand


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_q: int = 512, block_k: int = 512, probs_dtype=torch.float32,
                    return_lse: bool = False):
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd), float32 or bfloat16, H a
    multiple of KV -> (B, Sq, H, hd) in q's dtype.  Causal masking is
    top-left aligned (query i sees keys 0..i).

    ``block_q``/``block_k`` are the oracle's tiles, taken for the
    registry's common signature: the kernels tile by their own sizes
    whatever they are, and agree with the oracle within 2e-5 (f32; in bf16
    within one bf16 ulp more) at any of them.  Any Sq and any Skv > 0 are
    accepted (ragged tiles are masked).  float32 inputs take bf16 scratch
    for their three parts, 1.5 times their size.  ``probs_dtype``
    bfloat16 rounds P and V to bf16 before ``P V`` (float32 keeps P at
    f32 precision), P at its row's final max, as the oracle rounds it when
    ``block_k`` covers Skv (a first sweep over the keys finds the max; the
    oracle at a shorter ``block_k`` rounds at its chunks' running maxima).
    With ``return_lse`` the kernel also stores each
    query row's log-sum-exp, float32 (B, H, Sq), ``inf`` where a row sees
    no key, and the call returns ``(out, lse)``; without it, nothing more
    is stored."""
    global launches, tc_launches
    device = q.device
    _build.require_cuda("flash_attention", device)
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if probs_dtype not in DTYPES:
        raise TypeError(f"probs_dtype: expected float32 or bfloat16, got {probs_dtype}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if Skv == 0:
        raise ValueError("k and v hold no keys")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if -(-Sq // Q_TILE) > MAX_Q_TILES:
        raise ValueError(f"Sq = {Sq} exceeds {MAX_Q_TILES * Q_TILE}")
    _build.require("q", q, q.dtype, (B, Sq, H, hd), device)
    _build.require("k", k, q.dtype, (B, Skv, KV, hd), device)
    _build.require("v", v, q.dtype, (B, Skv, KV, hd), device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lse_ptr = lse.data_ptr() if return_lse else None
    probs_bf16 = int(probs_dtype == torch.bfloat16)
    if q.dtype == torch.bfloat16:
        _build.launch("flash_attention_tc", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse_ptr, B, H, KV, Sq, Skv, hd, int(bool(causal)),
                      probs_bf16)
        tc_launches += 1
    else:
        qs, ks, vs = (torch.empty((PARTS,) + x.shape, dtype=torch.bfloat16, device=device)
                      for x in (q, k, v))
        _build.launch("flash_attention_f32", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(), lse_ptr, B,
                      H, KV, Sq, Skv, hd, int(bool(causal)), probs_bf16)
        launches += 1
    return (out, lse) if return_lse else out
