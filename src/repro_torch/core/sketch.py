"""Fast-AGMS (Count-Sketch) self-join / join size sketches.

One sketch = (depth t, width w) int32 counters plus two 4-universal hash
families (bucket + sign), each keyed by the *pair* of fingerprint
components.  Linear: sketches of disjoint sub-streams merge by counter
addition.

F2 (self-join size) estimate  = median over rows of  sum_j C[i,j]^2.
Inner product (join size)     = median over rows of  sum_j A[i,j]*B[i,j].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import platform
from .hashing import cw_hash_pair, hash_bucket, hash_sign, random_field_elements


class SketchParams(NamedTuple):
    """Hash coefficients for a stack of sketches.

    bucket_coeffs / sign_coeffs: (..., t, 2, 4) int64 field elements.  A
    leading dimension stacks independent sketches (one per lattice level).
    """
    bucket_coeffs: torch.Tensor
    sign_coeffs: torch.Tensor

    @property
    def depth(self) -> int:
        return self.bucket_coeffs.shape[-3]


def make_sketch_params(rng: np.random.Generator, depth: int, *, stack: tuple = (),
                       device=None) -> SketchParams:
    """The JAX package's draws: bucket coefficients, then sign coefficients,
    on ``device`` (None: the CUDA card, :func:`platform.resolve`)."""
    device = platform.resolve(device)
    shape = tuple(stack) + (depth, 2, 4)
    bucket = random_field_elements(rng, shape).astype(np.int64)
    sign = random_field_elements(rng, shape).astype(np.int64)
    return SketchParams(torch.from_numpy(bucket).to(device),
                        torch.from_numpy(sign).to(device))


def empty_counters(depth: int, width: int, *, stack: tuple = (), device=None) -> torch.Tensor:
    """Zero (..., t, w) int32 counters on ``device`` (None: the CUDA card,
    :func:`platform.resolve`)."""
    device = platform.resolve(device)
    assert width & (width - 1) == 0, "sketch width must be a power of two"
    return torch.zeros(tuple(stack) + (depth, width), dtype=torch.int32, device=device)


def sketch_update(counters: torch.Tensor, fp1: torch.Tensor, fp2: torch.Tensor,
                  params: SketchParams, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Insert a batch of keys into one (t, w) sketch: the reference scatter.

    fp1/fp2: any shape (flattened); weights: int32 of the same size, 0
    masks a key out.  Returns new counters; int32 adds wrap as XLA's do.
    """
    t, w = counters.shape
    fp1 = fp1.reshape(-1)
    fp2 = fp2.reshape(-1)
    out = counters.clone()
    for i in range(t):
        bucket = hash_bucket(cw_hash_pair(fp1, fp2, params.bucket_coeffs[i]), w)
        sign = hash_sign(cw_hash_pair(fp1, fp2, params.sign_coeffs[i]))
        if weights is not None:
            sign = sign * weights.reshape(-1).to(torch.int32)
        out[i].index_add_(0, bucket, sign)
    return out


def median_depth(moments: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as ``jnp.median`` takes it: the mean of
    the two middle values, (lo + hi) * 0.5, for an even count."""
    t = moments.shape[-1]
    ordered = torch.sort(moments, dim=-1).values
    lo = ordered[..., (t - 1) // 2]
    hi = ordered[..., t // 2]
    return (lo + hi) * 0.5


def np_median_depth(moments: np.ndarray) -> np.ndarray:
    """:func:`median_depth` on the host: the same float32 operations on a
    float32 numpy array."""
    t = moments.shape[-1]
    ordered = np.sort(moments, axis=-1)
    return (ordered[..., (t - 1) // 2] + ordered[..., t // 2]) * np.float32(0.5)


def estimate_f2(counters: torch.Tensor) -> torch.Tensor:
    """Median-of-rows second-moment estimate in float32 (the median as
    :func:`median_depth` takes it).  counters: (..., t, w)."""
    return median_depth(torch.sum(counters.to(torch.float32) ** 2, dim=-1))


def estimate_inner(counters_a: torch.Tensor, counters_b: torch.Tensor) -> torch.Tensor:
    """Median-of-rows inner-product (join size) estimate in float32."""
    return median_depth(torch.sum(counters_a.to(torch.float32) * counters_b.to(torch.float32),
                                  dim=-1))


def merge(counters_a: torch.Tensor, counters_b: torch.Tensor) -> torch.Tensor:
    """Sketch linearity: the union of sub-streams is counter addition."""
    return counters_a + counters_b


def np_estimate_f2_exact(counters: np.ndarray) -> np.ndarray:
    """int64-exact F2: median over rows of the row sums of squares."""
    sq = (counters.astype(np.int64) ** 2).sum(axis=-1)
    return np.median(sq, axis=-1)


def np_estimate_inner_exact(counters_a: np.ndarray, counters_b: np.ndarray) -> np.ndarray:
    """int64-exact inner-product (join size) estimate.  counters: (..., t, w)."""
    prod = (counters_a.astype(np.int64) * counters_b.astype(np.int64)).sum(axis=-1)
    return np.median(prod, axis=-1)
