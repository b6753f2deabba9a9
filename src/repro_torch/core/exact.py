"""Exact similarity self-join and join sizes (oracles), copied from the
JAX package.

``exact_pair_counts`` -- O(2^d n) group-by per lattice combination:
y_k = sum over level-k combinations of sum_v m_v^2, then the *exact*
Lemma 3 inversion x_k = y_k - C(d,k) n - sum_{j>k} C(j,k) x_j.  This is the
paper's "offline case" with r = 1 and no sketching.
``brute_force_pair_counts`` / ``brute_force_join_counts`` -- O(n^2)
comparison, for small inputs.
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


def brute_force_pair_counts(values: np.ndarray) -> np.ndarray:
    """x[k] by O(n^2) comparison (ordered pairs, i != j).  Tiny inputs only."""
    values = np.asarray(values)
    n, d = values.shape
    x = np.zeros(d + 1, dtype=np.float64)
    for i in range(n):
        sim = (values[i] == values).sum(axis=1)
        cnt = np.bincount(sim, minlength=d + 1).astype(np.float64)
        cnt[(values[i] == values[i]).sum()] -= 1          # drop the self-pair
        x += cnt
    return x


def exact_g(values: np.ndarray, s: int) -> float:
    """The paper's g_s (Eq. 2): sum_{k>=s} x_k + n."""
    x = exact_pair_counts(values)
    return float(x[s:].sum() + values.shape[0])


def brute_force_join_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x[k]: #pairs (i in A, j in B) exactly k-similar (unordered across
    relations -- each cross pair counted once, matching §6)."""
    a = np.asarray(a)
    b = np.asarray(b)
    d = a.shape[1]
    assert b.shape[1] == d
    x = np.zeros(d + 1, dtype=np.float64)
    for i in range(a.shape[0]):
        sim = (a[i] == b).sum(axis=1)
        x += np.bincount(sim, minlength=d + 1).astype(np.float64)
    return x


def exact_join_g(a: np.ndarray, b: np.ndarray, s: int) -> float:
    return float(brute_force_join_counts(a, b)[s:].sum())
