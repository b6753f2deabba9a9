"""Flash attention (backward): the CUDA kernel ``csrc/flash_attention_bwd.cu``
(wgmma on TMA-fed rings: bfloat16 directly, float32 on operands split into
three bf16 parts) and its wrapper.

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

launches = 0      # calls (each lse/D rows, dK/dV, dQ; f32 the split first) since the last reset

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 128                  # keys of a dK/dV CTA and query rows of a dQ CTA
F32_TILE_HD128 = 64         # the same in float32 at hd 128 (three parts fill shared memory)
MAX_TILES = 65535           # the grid's y limit
ROW_PAD = 128               # the kernel's lse and D rows are padded to a multiple of this
PARTS = 3                   # bf16 parts of each float32 operand
# The kernel's accuracy, which chip_smoke.py and the card tests hold it to:
# each gradient's max distance from ref.attention_grads_f64 within
# GRAD_MULT of the plain path's, plus GRAD_FLOOR of the case's largest
# gradient.  f32: the kernel sums six bf16 partial products a product
# (three parts an operand) in the tensor cores' accumulator, flushed to
# f32 running sums, in another order than cuBLAS; bf16: both round the
# same f32 values to bf16.
GRAD_MULT = {torch.float32: 4.0, torch.bfloat16: 1.25}
GRAD_FLOOR = 2e-6


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
    tile = F32_TILE_HD128 if q.dtype == torch.float32 and hd == 128 else TILE
    if max(-(-Sq // tile), -(-Skv // tile)) > MAX_TILES:
        raise ValueError(f"Sq = {Sq} or Skv = {Skv} exceeds {MAX_TILES * tile}")
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
    # lse and D = rowsum(dout * out) of every (batch, head), padded rows
    rows = torch.empty((2, B * H, -(-Sq // ROW_PAD) * ROW_PAD), dtype=torch.float32,
                       device=device)
    # float32: the bf16 parts of q, k, v and dout
    splits = ([None] * 4 if q.dtype == torch.bfloat16 else
              [torch.empty((PARTS,) + x.shape, dtype=torch.bfloat16, device=device)
               for x in (q, k, v, dout)])
    # per-query-head partial sums of dK and dV, which the kernel adds over
    # each KV group in a fixed order
    part = (torch.empty((2, B, Skv, H, hd), dtype=torch.float32, device=device)
            if H > KV and Sq > 0 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("flash_attention_bwd", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                  *map(ptr, splits), ptr(part), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  B, H, KV, Sq, Skv, hd, int(bool(causal)), int(probs_dtype == torch.bfloat16),
                  int(q.dtype == torch.bfloat16))
    launches += 1
    return dq, dk, dv
