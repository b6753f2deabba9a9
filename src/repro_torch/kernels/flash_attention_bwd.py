"""Flash attention (backward): the CUDA kernel ``csrc/flash_attention_bwd.cu``
(float32 on the CUDA cores, bfloat16 on the tensor cores with mma.sync)
and its wrapper.

Replaces XLA's gradient of the JAX package's ``chunked_attention``
(``models/attention.py``), which ``jax.value_and_grad`` differentiates
above ``CHUNKED_THRESHOLD``: there is no Pallas backward kernel.  This is
the ``cuda_sm90`` tier of the ``flash_attention_bwd`` op in the kernel
registry (``kernels/ops.py``), which the flash op's ``autograd.Function``
runs; its oracle is :func:`.ref.flash_attention_bwd_ref`.  It takes CUDA
tensors only, launches the kernel or raises; the input dtype picks the
instantiation (float32 or bfloat16).
"""
from __future__ import annotations

import torch

from . import _build

launches = 0      # calls (each three launches: D, dK/dV, dQ) since the last reset

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                   # query rows and keys per tile
MAX_TILES = 65535           # the grid's y limit


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, block_q=512, block_k=512,
                        probs_dtype=torch.float32):
    """q, out, dout (B, Sq, H, hd) and k, v (B, Skv, KV, hd), all float32
    or all bfloat16, lse float32 (B, H, Sq) from the forward ->
    ``(dq, dk, dv)`` in the inputs' dtype.  ``probs_dtype`` is the
    forward's (bfloat16: V, P where dV reads it, dP and dV are rounded to
    bf16, as autograd rounds through the plain version).
    ``block_q``/``block_k`` are the oracle's tiles, taken for the
    registry's common signature; the kernel tiles by its own.  No atomics:
    two calls on the same inputs give the same bits."""
    global launches
    device = q.device
    _build.require_cuda("flash_attention_bwd", device)
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
    if max(-(-Sq // TILE), -(-Skv // TILE)) > MAX_TILES:
        raise ValueError(f"Sq = {Sq} or Skv = {Skv} exceeds {MAX_TILES * TILE}")
    for name, t, shape in (("q", q, (B, Sq, H, hd)), ("k", k, (B, Skv, KV, hd)),
                           ("v", v, (B, Skv, KV, hd)), ("out", out, (B, Sq, H, hd)),
                           ("dout", dout, (B, Sq, H, hd))):
        _build.require(name, t, q.dtype, shape, device)
    _build.require("lse", lse, torch.float32, (B, H, Sq), device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dq, dk, dv
    rows_d = torch.empty((B, H, Sq), dtype=torch.float32, device=device)
    # per-query-head partial sums of dK and dV, which the kernel adds over
    # each KV group in a fixed order
    part = (torch.empty((2, B, Skv, H, hd), dtype=torch.float32, device=device)
            if H > KV and Sq > 0 else None)
    _build.launch("flash_attention_bwd", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows_d.data_ptr(),
                  None if part is None else part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), B, H, KV, Sq, Skv, hd,
                  int(bool(causal)), int(probs_dtype == torch.bfloat16),
                  int(q.dtype == torch.bfloat16))
    launches += 1
    return dq, dk, dv
