"""Seeded synthetic generators shaped like the paper's evaluation
datasets, a numpy copy of the JAX package's ``data/synthetic.py``: the same
seed gives the same arrays, bit for bit.

DBLP and YFCC are not redistributable; these generators reproduce the
statistics the estimator sees: column cardinalities, duplicate and
similarity structure, and skew.  Records are (n, d) uint32 matrices of
column-value ids.

- ``planted_cluster_records``: uniform noise with planted near-duplicate
  clusters (the g_s >> n regime of Figs. 4/8).
- ``dblp_like``: columns of very different cardinalities plus planted
  near-duplicate pairs -- the DBLP5/DBLP6 analogue.
- ``shingle_records``: documents as d super-shingle fingerprints with a
  configurable duplication profile -- the DBLPtitles analogue.
- ``near_uniform_40_60`` / ``skewed``: the §7.5 running-time datasets
  (40% unique / 60% in 4-similar pairs; 20-80 and 10-90 skew).
- ``yfcc_like``: 5 columns shaped like (userid, date, device, lat, lon).
- ``zipf_tokens``: LM token batches with a zipfian unigram.
"""
from __future__ import annotations

import numpy as np


def _rng(seed):
    return np.random.default_rng(seed)


def planted_cluster_records(n: int, d: int, rng: np.random.Generator,
                            clusters) -> np.ndarray:
    """Uniform noise + planted near-duplicate clusters.

    ``clusters`` is a list of (k, size, count): plant ``count`` clusters of
    ``size`` records agreeing on ``k`` columns -- the quadratic
    duplicate-group structure of the paper's DBLP data (g_s >> n, the
    regime where small samples fail; Figs. 4/8).
    """
    recs = rng.integers(0, 1 << 30, size=(n, d), dtype=np.uint32)
    pos = n - 1
    for k, size, count in clusters:
        for _ in range(count):
            src = rng.integers(0, n // 4)
            cols = rng.choice(d, size=k, replace=False)
            for _ in range(size - 1):
                recs[pos, cols] = recs[src, cols]
                pos -= 1
    return recs


def dblp_like(n: int, *, d: int = 5, seed: int = 0,
              cardinalities=None, dup_fraction: float = 0.1,
              dup_columns: int | None = None):
    """Records with per-column cardinalities + planted near-duplicates.

    ``dup_fraction`` of records are near-copies of earlier records agreeing
    on ``dup_columns`` (default d-1) columns.
    """
    rng = _rng(seed)
    if cardinalities is None:
        # title-like, author-like, then increasingly low-cardinality fields
        cardinalities = [max(2, int(n * f)) for f in
                         (0.99, 0.8, 0.002, 0.006, 0.0025, 0.013)][:d]
        while len(cardinalities) < d:
            cardinalities.append(max(2, n // 100))
    recs = np.stack([rng.integers(0, c, size=n, dtype=np.uint32)
                     for c in cardinalities], axis=1)
    n_dup = int(n * dup_fraction)
    if n_dup:
        dup_cols = dup_columns if dup_columns is not None else d - 1
        src = rng.integers(0, n - n_dup, size=n_dup)
        dst = np.arange(n - n_dup, n)
        recs[dst] = recs[src]
        # perturb (d - dup_cols) random columns so pairs are dup_cols-similar
        for row, s in zip(dst, src):
            cols = rng.choice(d, size=d - dup_cols, replace=False)
            for c in cols:
                recs[row, c] = rng.integers(0, cardinalities[c], dtype=np.uint32)
    return recs


def shingle_records(n_docs: int, *, d: int = 6, seed: int = 1,
                    dup_profile=((2, 0.02), (4, 0.01), (6, 0.005)),
                    group: int = 4):
    """Documents as d super-shingles; dup_profile plants (k_similar, frac).

    Near-duplicates come in GROUPS of ``group`` rows sharing k columns (a
    group of g rows contributes g*(g-1) ordered k-similar pairs) -- matching
    the quadratic duplicate-cluster structure of the paper's DBLP data,
    where g_s >> n.  ``frac`` is the fraction of rows consumed by groups at
    that level.
    """
    rng = _rng(seed)
    recs = rng.integers(0, 1 << 30, size=(n_docs, d), dtype=np.uint32)
    pos = n_docs - 1
    for k, frac in dup_profile:
        rows = int(n_docs * frac)
        n_groups = max(rows // max(group - 1, 1), 1)
        for _ in range(n_groups):
            src = rng.integers(0, n_docs // 2)
            cols = rng.choice(d, size=k, replace=False)
            for _ in range(group - 1):
                if pos <= n_docs // 2:
                    break
                recs[pos, cols] = recs[src, cols]
                pos -= 1
    return recs


def near_uniform_40_60(n: int, *, d: int = 5, seed: int = 2):
    """40% unique records; 60% form 4-similar pairs (§7.5)."""
    rng = _rng(seed)
    recs = rng.integers(0, 1 << 30, size=(n, d), dtype=np.uint32)
    n_pair = int(n * 0.6) // 2
    for i in range(n_pair):
        a, b = 2 * i, 2 * i + 1
        recs[b] = recs[a]
        c = rng.integers(0, d)
        recs[b, c] = rng.integers(0, 1 << 30, dtype=np.uint32)
    perm = rng.permutation(n)
    return recs[perm]


def skewed(n: int, *, d: int = 5, frac_unique: float = 0.2,
           group: int = 16, seed: int = 3):
    """frac_unique records unique; rest in groups of ``group`` 4-similar
    records (20-80: frac_unique=0.2; 10-90: 0.1)."""
    rng = _rng(seed)
    recs = rng.integers(0, 1 << 30, size=(n, d), dtype=np.uint32)
    n_grouped = int(n * (1 - frac_unique))
    n_groups = n_grouped // group
    pos = int(n * frac_unique)
    for _ in range(n_groups):
        base = recs[rng.integers(0, max(pos, 1))]
        c = rng.integers(0, d)      # one varying column per group ->
        for j in range(group):      # members are pairwise (d-1)-similar
            if pos >= n:
                break
            recs[pos] = base
            recs[pos, c] = rng.integers(0, 1 << 30, dtype=np.uint32)
            pos += 1
    perm = rng.permutation(n)
    return recs[perm]


def yfcc_like(n: int, *, seed: int = 4):
    """5 columns: userid, date, device, lat, lon (YFCC-shaped skew)."""
    rng = _rng(seed)
    users = (rng.zipf(1.5, size=n) % max(n // 50, 2)).astype(np.uint32)
    dates = rng.integers(0, 4000, size=n, dtype=np.uint32)
    devices = (rng.zipf(1.3, size=n) % 5000).astype(np.uint32)
    lat = rng.integers(0, 180_000, size=n, dtype=np.uint32)
    lon = rng.integers(0, 360_000, size=n, dtype=np.uint32)
    return np.stack([users, dates, devices, lat, lon], axis=1)


def zipf_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                *, a: float = 1.2, dup_fraction: float = 0.05):
    """LM token batches with a zipfian unigram + near-duplicate sequences."""
    toks = (rng.zipf(a, size=(batch, seq)) % vocab).astype(np.int32)
    n_dup = int(batch * dup_fraction)
    if n_dup and batch > 1:
        src = rng.integers(0, batch, size=n_dup)
        dst = rng.integers(0, batch, size=n_dup)
        toks[dst] = toks[src]
        # small perturbation: a few token flips
        for r in dst:
            idx = rng.integers(0, seq, size=max(seq // 100, 1))
            toks[r, idx] = (rng.zipf(a, size=idx.shape[0]) % vocab).astype(np.int32)
    return toks
