"""The torch generators' duplicate and Zipf statistics, and their
determinism in the seed."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import exact
from sjbench import datagen

PROFILE = [[3, 0.15], [4, 0.08], [5, 0.05], [6, 0.03]]


def test_sjbench_shingles_plant_the_duplicate_groups():
    n, d, group = 1 << 14, 6, 6
    recs = datagen.shingles(n, d, PROFILE, group, datagen.generator(2**31 + 5, "cpu"), "cpu")
    again = datagen.shingles(n, d, PROFILE, group, datagen.generator(2**31 + 5, "cpu"), "cpu")
    assert recs.dtype == torch.int32 and torch.equal(recs, again)
    counts = exact.exact_pair_counts(recs.numpy().astype(np.uint32))
    # a group of 6 gives 30 ordered pairs agreeing on at least its k columns
    # (random 30-bit columns almost never agree by chance)
    for k, _ in PROFILE:
        assert counts[k:].sum() >= 30 * sum(int(n * f) // (group - 1)
                                            for kk, f in PROFILE if kk >= k)
    assert counts[d] >= 30 * (int(n * 0.03) // (group - 1))


def test_sjbench_zipf_follows_its_law():
    x = datagen.zipf(1.5, 200_000, datagen.generator(11, "cpu"), "cpu")
    zeta = sum(k ** -1.5 for k in range(1, 200_000)) + 2 * 200_000 ** -0.5
    for k in (1, 2, 3):
        share = float((x == k).double().mean())
        assert math.isclose(share, k ** -1.5 / zeta, rel_tol=0.03)
    assert int(x.min()) >= 1


def test_sjbench_yfcc_columns():
    n = 1 << 15
    recs = datagen.yfcc(n, datagen.generator(3, "cpu"), "cpu")
    assert recs.shape == (n, 5)
    maxima = recs.max(dim=0).values.tolist()
    assert maxima[0] < n // 50 and maxima[1] < 4000 and maxima[2] < 5000
    assert maxima[3] < 180_000 and maxima[4] < 360_000
    # the most frequent user and device hold about 1/zeta(1.5) and 1/zeta(1.3)
    assert 0.33 < float((recs[:, 0] == 1).double().mean()) < 0.43
    assert 0.20 < float((recs[:, 2] == 1).double().mean()) < 0.30
