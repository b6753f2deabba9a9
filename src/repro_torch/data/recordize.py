"""Token sequences -> d-column super-shingle records (the paper's
DBLPtitles construction applied to the LM data stream).

Each sequence is split into ``d`` equal spans; every span is reduced to
one column value with a polynomial fingerprint over the token ids (mod
2^31-1, the field of the sketch hashing).  Two sequences that share >= s
spans verbatim are s-similar records -- the near-duplicate signal the SJPC
stream monitor estimates.

The JAX package's ``data/recordize.py``; field values are carried as int64
(uint32 values in [0, 2^32), as everywhere in the port).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hashing import P31, mulmod_p31, reduce_p31

SHINGLE_BASE = 1_000_003
_MASK32 = 0xFFFFFFFF


def _powers(n: int, device) -> torch.Tensor:
    """SHINGLE_BASE ** (n-1-j) mod p for j in 0..n-1 (int64)."""
    pows, x = [], 1
    for _ in range(n):
        pows.append(x)
        x = x * SHINGLE_BASE % P31
    return torch.tensor(pows[::-1], dtype=torch.int64, device=device)


def records_from_tokens(tokens, d: int) -> torch.Tensor:
    """tokens (B, S) integers -> records (B, d) int64 field values, on the
    tokens' device.  S need not divide by d; the tail tokens fold into the
    last span.  Token ids wrap to uint32 first, as the JAX package's
    ``astype(uint32)`` does.

    The JAX package folds each span by Horner's rule, one token at a time.
    Here a span is one weighted sum, sum_j v_j * base^(n-1-j) mod p, the
    same field element: each product is reduced below p < 2^31 before the
    sum, so the sum of up to 2^32 terms stays exact in int64."""
    tokens = torch.as_tensor(tokens)
    b, s = tokens.shape
    span = s // d
    vals = reduce_p31(torch.bitwise_and(
        torch.bitwise_and(tokens.to(torch.int64), _MASK32) + 1, _MASK32))
    cols = []
    for i in range(d):
        lo = i * span
        hi = (i + 1) * span if i < d - 1 else s
        terms = mulmod_p31(vals[:, lo:hi], _powers(hi - lo, tokens.device))
        cols.append(reduce_p31(terms.sum(dim=1)))
    return torch.stack(cols, dim=1)


def np_records_from_tokens(tokens: np.ndarray, d: int) -> np.ndarray:
    """NumPy oracle (tests)."""
    p = np.uint64(int(P31))
    b, s = tokens.shape
    span = s // d
    vals = (tokens.astype(np.uint64) + 1) % p
    out = np.zeros((b, d), dtype=np.uint32)
    for i in range(d):
        lo, hi = i * span, ((i + 1) * span if i < d - 1 else s)
        h = np.zeros((b,), np.uint64)
        for j in range(lo, hi):
            h = (h * np.uint64(int(SHINGLE_BASE)) + vals[:, j]) % p
        out[:, i] = h.astype(np.uint32)
    return out
