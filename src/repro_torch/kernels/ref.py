"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, on any device.  The kernel
wrappers run them for CPU tensors; the tests hold them against the JAX
package, and ``chip_smoke.py`` holds each kernel against them on the card.
Nothing on the main path calls them for CUDA tensors.
"""
from __future__ import annotations

import torch

from ..core.fingerprint import subvalue_fingerprints
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


def fused_query_ref(counters_a, counters_b):
    """Row moments sum_j A*B of (N, L, t, w) int32 stacks -> (N, L, t)
    float32, summed exactly in int64 and cast once.  Equal to the JAX f32
    reduction while partial sums stay below 2^24; closer to the int64
    oracle ``np_estimate_inner_exact`` above that."""
    prod = counters_a.to(torch.int64) * counters_b.to(torch.int64)
    return prod.sum(dim=-1).to(torch.float32)
