"""Rabin-style polynomial fingerprints of projected sub-values.

A level-k sub-value of a record is (combination id, v_c1, ..., v_ck).  Its
fingerprint is the masked Horner polynomial

    fp(base) = Horner(base, [id + 1, v_c1 + 1, ..., v_ck + 1])  mod 2^31-1

taken over all d columns with the excluded ones skipped.  Two independent
random bases give two 31-bit fingerprints; the pair is the sketch key.  The
combination id (the column bitmask) seeds the Horner state, so equal values
under different projections never collide by construction.

:func:`subvalue_fingerprints` is the plain PyTorch version; on CUDA tensors
``kernels.ops.fingerprint`` runs the hand-written kernel instead.
:func:`np_subvalue_fingerprints` is the numpy uint64 oracle of both, a copy
of the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import P31, addmod_p31, mulmod_p31, random_field_elements, reduce_p31


def make_fingerprint_bases(rng: np.random.Generator) -> np.ndarray:
    """Two independent random bases in [2, p) -- shape (2,) uint32."""
    return (random_field_elements(rng, (2,)) % np.uint32(P31 - 2)) + np.uint32(2)


def subvalue_fingerprints(values: torch.Tensor, combo_masks: torch.Tensor,
                          combo_ids: torch.Tensor, bases: torch.Tensor):
    """Fingerprint every (record, combination) sub-value.

    values (B, d) int64 in [0, 2^32); combo_masks (M, d) {0,1}; combo_ids
    (M,); bases (2,).  Returns (fp1, fp2), each (B, M) int64 in [0, p).
    """
    values = reduce_p31(values)
    B, d = values.shape
    seed = addmod_p31(reduce_p31(combo_ids.to(torch.int64)), 1)
    include = combo_masks != 0
    outs = []
    for which in (0, 1):
        base = bases[which]
        fp = seed[None, :].expand(B, seed.shape[0])
        for col in range(d):
            v = addmod_p31(values[:, col:col + 1], 1)
            nxt = addmod_p31(mulmod_p31(fp, base), v)
            fp = torch.where(include[None, :, col], nxt, fp)
        outs.append(fp)
    return outs[0], outs[1]



def np_subvalue_fingerprints(values, combo_masks, combo_ids, bases):
    """NumPy uint64 oracle for the kernel tests: (fp1, fp2), each (B, M)
    uint32, from uint32 ``values`` (B, d), ``combo_masks`` (M, d),
    ``combo_ids`` (M,) and ``bases`` (2,)."""
    p = np.uint64(P31)
    values = values.astype(np.uint64) % p
    B, d = values.shape
    M = combo_ids.shape[0]
    outs = []
    for base in bases.astype(np.uint64):
        fp = np.broadcast_to((combo_ids.astype(np.uint64) % p + 1) % p, (B, M)).copy()
        for col in range(d):
            v = (values[:, col:col + 1] + 1) % p
            nxt = (fp * base + v) % p
            fp = np.where(combo_masks[None, :, col] != 0, nxt, fp)
        outs.append(fp.astype(np.uint32))
    return outs[0], outs[1]
