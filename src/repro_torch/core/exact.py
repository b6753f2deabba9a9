"""Exact similarity self-join sizes (oracles), copied from the JAX package.

``exact_pair_counts`` -- O(2^d n) group-by per lattice combination:
y_k = sum over level-k combinations of sum_v m_v^2, then the *exact*
Lemma 3 inversion x_k = y_k - C(d,k) n - sum_{j>k} C(j,k) x_j.  This is the
paper's "offline case" with r = 1 and no sketching.
"""
from __future__ import annotations

import itertools
import math

import numpy as np


def _row_group_counts(proj: np.ndarray) -> np.ndarray:
    """Multiplicities of distinct rows of a 2-D int array (exact)."""
    arr = np.ascontiguousarray(proj)
    void = arr.view([('', arr.dtype)] * arr.shape[1]).ravel()
    _, counts = np.unique(void, return_counts=True)
    return counts


def exact_level_join_sizes(values: np.ndarray, s: int = 1) -> np.ndarray:
    """y[k] for k = 0..d (y[k] = 0 for k < s): level-k self-join sizes.

    y_k counts ordered pairs (including self-pairs) of level-k sub-values
    that agree -- exactly the paper's y_k with sampling ratio r = 1.
    """
    values = np.asarray(values)
    n, d = values.shape
    y = np.zeros(d + 1, dtype=np.float64)
    for k in range(max(s, 1), d + 1):
        total = 0
        for cols in itertools.combinations(range(d), k):
            counts = _row_group_counts(values[:, list(cols)])
            total += int((counts.astype(np.int64) ** 2).sum())
        y[k] = total
    return y


def exact_pair_counts(values: np.ndarray) -> np.ndarray:
    """x[k] for k = 0..d: exact #ordered pairs (i != j) exactly k-similar.

    Lemma 3 inversion of the exact level join sizes.
    """
    values = np.asarray(values)
    n, d = values.shape
    y = exact_level_join_sizes(values, s=1)
    x = np.zeros(d + 1, dtype=np.float64)
    for k in range(d, 0, -1):
        acc = y[k] - math.comb(d, k) * n
        for j in range(k + 1, d + 1):
            acc -= math.comb(j, k) * x[j]
        x[k] = acc
    # level 0: the empty projection joins everything (y_0 = n^2)
    x[0] = float(n) * n - n - x[1:].sum()
    return x
