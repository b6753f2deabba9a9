"""The paper's baselines (§2): random sampling and LSH-SS bucketing, a
numpy copy of the JAX package's ``core/baselines.py``.  Given the same
``np.random.Generator`` state, every function returns what the JAX
package's does.

* Random sampling (§2.1): R records uniformly without replacement, the
  all-pairs similarity histogram of the sample, scaled by
  n(n-1)/(R(R-1)).  The one-pass competitor of the online comparison
  (Fig. 8), at *equal space*.
* LSH-SS (§2.3, Lee et al. [17]): records are bucketed by a Hamming LSH
  (values of a random column subset); same-bucket and cross-bucket pairs
  are sampled as two strata, the similar fraction of each is measured,
  and the stratum totals are scaled.  Multi-pass; the offline comparison
  (Figs. 4-6).
* Signature-pattern counting (§2.2) is not implemented: the published
  estimator can go negative, and the paper excludes it.
"""
from __future__ import annotations

import numpy as np

from .exact import brute_force_pair_counts


def random_sampling_pair_counts(values: np.ndarray, sample_size: int,
                                rng: np.random.Generator) -> np.ndarray:
    """x[k] estimates (ordered pairs) from a uniform record sample.

    A sample of fewer than two records carries no pair information, so the
    zero histogram is returned (and g_s degenerates to n) -- in particular
    for the empty stream, where ``rng.choice(0, ...)`` would raise."""
    values = np.asarray(values)
    n = values.shape[0]
    R = min(sample_size, n)
    if R < 2:
        return np.zeros(values.shape[1] + 1)
    idx = rng.choice(n, size=R, replace=False)
    x_sample = brute_force_pair_counts(values[idx])
    scale = (n * (n - 1)) / (R * (R - 1))
    return x_sample * scale


def random_sampling_g(values: np.ndarray, s: int, sample_size: int,
                      rng: np.random.Generator) -> float:
    x = random_sampling_pair_counts(values, sample_size, rng)
    return float(x[s:].sum() + values.shape[0])


def sample_size_for_bytes(space_bytes: int, record_bytes: int) -> int:
    """Records storable in the space budget (the Fig. 8 equal-space rule).

    Honest accounting: a budget that holds fewer than two records yields
    that many (0 or 1) -- no silent floor to 2, which would quietly grant
    the sampling competitor more space than the sketch it is compared
    against.  ``random_sampling_pair_counts`` handles R < 2 by returning
    the zero histogram."""
    return space_bytes // max(record_bytes, 1)


def _bucket_keys(values: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Group records by their values on `cols` -> integer bucket ids."""
    proj = np.ascontiguousarray(values[:, cols])
    void = proj.view([('', proj.dtype)] * proj.shape[1]).ravel()
    _, inv = np.unique(void, return_inverse=True)
    return inv


def lsh_ss_g(values: np.ndarray, s: int, rng: np.random.Generator,
             m_h: int | None = None, m_l: int | None = None,
             num_hash_cols: int = 1) -> float:
    """LSH-SS stratified estimate of g_s (ordered pairs + self-pairs).

    m_h / m_l: pair-sample sizes for the same-bucket (high similarity) and
    cross-bucket (low) strata; the authors suggest m_h = m_l = n.

    ``num_hash_cols`` is the size c of the random column subset the LSH
    buckets hash (the paper's LSH-SS uses a subset, not a single column);
    validated to 1 <= c <= d.  At c = d buckets are exact records, so the
    same stratum is exactly the duplicate pairs.
    """
    values = np.asarray(values)
    n, d = values.shape
    if not 1 <= num_hash_cols <= d:
        raise ValueError(
            f"num_hash_cols={num_hash_cols} outside [1, d={d}]"
            " (the LSH bucket key is a random column subset)")
    if n < 2:
        return float(n)                 # no pairs; g_s is the self-pairs
    m_h = n if m_h is None else m_h
    m_l = n if m_l is None else m_l

    cols = rng.choice(d, size=num_hash_cols, replace=False)
    bucket = _bucket_keys(values, cols)
    order = np.argsort(bucket, kind="stable")
    sorted_b = bucket[order]
    # bucket boundaries
    starts = np.flatnonzero(np.r_[True, sorted_b[1:] != sorted_b[:-1]])
    ends = np.r_[starts[1:], n]
    sizes = (ends - starts).astype(np.float64)

    same_pairs = float((sizes * (sizes - 1)).sum())          # ordered
    total_pairs = float(n) * (n - 1)
    cross_pairs = total_pairs - same_pairs

    sim_count = lambda i, j: int((values[i] == values[j]).sum())

    # stratum 1: same-bucket pairs, sampled bucket-proportionally
    p1 = 0.0
    if same_pairs > 0 and m_h > 0:
        probs = (sizes * (sizes - 1)) / same_pairs
        picks = rng.choice(len(sizes), size=m_h, p=probs)
        hits = 0
        for b in picks:
            lo, hi = starts[b], ends[b]
            i, j = rng.choice(np.arange(lo, hi), size=2, replace=False)
            hits += sim_count(order[i], order[j]) >= s
        p1 = hits / m_h

    # stratum 2: cross-bucket pairs, rejection-sampled
    p2 = 0.0
    if cross_pairs > 0 and m_l > 0:
        hits = 0
        got = 0
        attempts = 0
        while got < m_l and attempts < 50 * m_l:
            attempts += 1
            i, j = rng.integers(0, n, size=2)
            if i == j or bucket[i] == bucket[j]:
                continue
            got += 1
            hits += sim_count(i, j) >= s
        p2 = hits / max(got, 1)

    return p1 * same_pairs + p2 * cross_pairs + n
