"""Seeded synthetic records (numpy), copied from the JAX package.

``shingle_records``: documents as d super-shingle fingerprints with a
configurable duplication profile -- the paper's DBLPtitles analogue.  The
records are an (n, d) uint32 matrix of column-value ids.
"""
from __future__ import annotations

import numpy as np


def _rng(seed):
    return np.random.default_rng(seed)


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
