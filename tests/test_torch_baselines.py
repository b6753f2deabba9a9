"""The port's baselines (``core/baselines.py``), synthetic generators
(``data/synthetic.py``) and Fast-AGMS estimates (``core/sketch.py``) on the
CPU: the checks of ``tests/test_baselines.py``, ``tests/test_data_synthetic.py``
and ``tests/test_sketch.py`` run through the port, and equality with the
JAX package -- the same generator state gives the same arrays and
estimates, and the float32 median-of-rows estimates equal ``jnp``'s
(``jnp.median``'s mean of the two middle rows at an even depth).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import baselines, exact  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.hashing import P31  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.synthetic import (dblp_like, near_uniform_40_60,  # noqa: E402
                                        shingle_records, skewed, yfcc_like)


def _dups_dataset(rng, n=400, d=5, dup_frac=0.5):
    base = rng.integers(0, 50, size=(n, d)).astype(np.uint32)
    n_dup = int(n * dup_frac) // 2
    for i in range(n_dup):
        base[n - 1 - i] = base[i]
        base[n - 1 - i, rng.integers(0, d)] += 1000   # 4-similar partner
    return base


# ---------------------------------------------------------------------------
# baselines: the checks of tests/test_baselines.py
# ---------------------------------------------------------------------------

class TestRandomSampling:
    def test_full_sample_is_exact(self):
        rng = np.random.default_rng(0)
        vals = _dups_dataset(rng)
        x_est = baselines.random_sampling_pair_counts(vals, len(vals), rng)
        np.testing.assert_allclose(x_est, exact.brute_force_pair_counts(vals))

    def test_unbiased_at_half_sample(self):
        vals = _dups_dataset(np.random.default_rng(1))
        true_g = exact.exact_g(vals, 4)
        ests = [baselines.random_sampling_g(vals, 4, 200, np.random.default_rng(s))
                for s in range(40)]
        assert abs(np.mean(ests) - true_g) / true_g < 0.2

    def test_small_sample_misses_similar_pairs(self):
        """Lemma 1: o(sqrt(n)) samples typically see no similar pair and
        estimate g_s ~= n."""
        n = 2000
        vals = np.random.default_rng(2).integers(0, 2**30, size=(n, 5)).astype(np.uint32)
        vals[1] = vals[0]
        misses = sum(baselines.random_sampling_g(vals, 5, 8, np.random.default_rng(s)) == n
                     for s in range(20))
        assert misses >= 18


class TestDegenerateStreams:
    def test_random_sampling_empty_stream(self):
        rng = np.random.default_rng(0)
        empty = np.zeros((0, 5), np.uint32)
        np.testing.assert_array_equal(baselines.random_sampling_pair_counts(empty, 100, rng),
                                      np.zeros(6))
        assert baselines.random_sampling_g(empty, 3, 100, rng) == 0.0

    def test_random_sampling_single_record(self):
        rng = np.random.default_rng(1)
        one = np.ones((1, 5), np.uint32)
        np.testing.assert_array_equal(baselines.random_sampling_pair_counts(one, 100, rng),
                                      np.zeros(6))
        assert baselines.random_sampling_g(one, 3, 100, rng) == 1.0

    def test_lsh_ss_empty_and_single(self):
        rng = np.random.default_rng(2)
        assert baselines.lsh_ss_g(np.zeros((0, 5), np.uint32), 3, rng) == 0.0
        assert baselines.lsh_ss_g(np.ones((1, 5), np.uint32), 3, rng) == 1.0

    def test_zero_sample_budget_returns_zero_histogram(self):
        rng = np.random.default_rng(3)
        vals = rng.integers(0, 9, size=(50, 5)).astype(np.uint32)
        for budget in (0, 1):
            np.testing.assert_array_equal(
                baselines.random_sampling_pair_counts(vals, budget, rng), np.zeros(6))
            assert baselines.random_sampling_g(vals, 3, budget, rng) == 50.0


class TestLSHSS:
    def test_reasonable_estimate_on_dups(self):
        vals = _dups_dataset(np.random.default_rng(3), n=300)
        true_g = exact.exact_g(vals, 4)
        ests = [baselines.lsh_ss_g(vals, 4, np.random.default_rng(100 + s)) for s in range(10)]
        assert abs(np.median(ests) - true_g) / true_g < 1.0

    def test_no_duplicates_estimates_near_n(self):
        rng = np.random.default_rng(4)
        vals = rng.integers(0, 2**30, size=(500, 5)).astype(np.uint32)
        assert abs(baselines.lsh_ss_g(vals, 4, rng) - 500) / 500 < 0.5

    def test_num_hash_cols_validated(self):
        rng = np.random.default_rng(5)
        vals = rng.integers(0, 9, size=(40, 5)).astype(np.uint32)
        for bad in (0, -1, 6):
            with pytest.raises(ValueError, match="num_hash_cols"):
                baselines.lsh_ss_g(vals, 3, rng, num_hash_cols=bad)

    @pytest.mark.parametrize("num_hash_cols", [2, 5])
    def test_column_subset_used(self, num_hash_cols):
        vals = _dups_dataset(np.random.default_rng(6), n=300)
        true_g = exact.exact_g(vals, 4)
        ests = [baselines.lsh_ss_g(vals, 4, np.random.default_rng(200 + s),
                                   num_hash_cols=num_hash_cols) for s in range(10)]
        assert all(np.isfinite(e) and e >= 300 for e in ests)
        assert abs(np.median(ests) - true_g) / true_g < 1.0

    def test_d_column_edge_case_buckets_are_exact_records(self):
        """c = d: buckets are whole records, so the s = d estimate is the
        true ordered duplicate-pair count plus n."""
        n, d = 200, 5
        vals = np.random.default_rng(7).integers(0, 2**30, size=(n, d)).astype(np.uint32)
        vals[n - 10:] = vals[:10]
        true_g = exact.exact_g(vals, d)
        assert true_g == n + 20
        for seed in range(3):
            assert baselines.lsh_ss_g(vals, d, np.random.default_rng(seed),
                                      num_hash_cols=d) == true_g


class TestSpaceAccounting:
    def test_sample_size_for_bytes(self):
        assert baselines.sample_size_for_bytes(48_000, 48) == 1000

    def test_no_silent_floor(self):
        assert baselines.sample_size_for_bytes(0, 48) == 0
        assert baselines.sample_size_for_bytes(47, 48) == 0
        assert baselines.sample_size_for_bytes(95, 48) == 1
        assert baselines.sample_size_for_bytes(96, 48) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baselines_equal_jax_on_the_same_generator_state(seed):
    vals = _dups_dataset(np.random.default_rng(seed), n=300)
    for size in (0, 1, 40, 300, 500):
        np.testing.assert_array_equal(
            baselines.random_sampling_pair_counts(vals, size, np.random.default_rng(seed)),
            jbase.random_sampling_pair_counts(vals, size, np.random.default_rng(seed)))
    for s in (3, 4, 5):
        assert baselines.random_sampling_g(vals, s, 64, np.random.default_rng(seed + s)) \
            == jbase.random_sampling_g(vals, s, 64, np.random.default_rng(seed + s))
        for c in (1, 2, 5):
            kw = dict(m_h=200, m_l=150, num_hash_cols=c)
            assert baselines.lsh_ss_g(vals, s, np.random.default_rng(seed), **kw) \
                == jbase.lsh_ss_g(vals, s, np.random.default_rng(seed), **kw)
    cols = np.array([0, 3])
    np.testing.assert_array_equal(baselines._bucket_keys(vals, cols),
                                  jbase._bucket_keys(vals, cols))
    for budget, rec in ((73_728, 24), (47, 48), (10**6, 7)):
        assert baselines.sample_size_for_bytes(budget, rec) \
            == jbase.sample_size_for_bytes(budget, rec)


# ---------------------------------------------------------------------------
# synthetic generators: the checks of tests/test_data_synthetic.py
# ---------------------------------------------------------------------------

def test_dblp_like_has_planted_near_dups():
    x = exact.exact_pair_counts(dblp_like(400, d=5, seed=1, dup_fraction=0.1))
    assert x[4] + x[5] >= 60, x


def test_shingle_groups_quadratic():
    recs = shingle_records(600, d=6, seed=2, group=5, dup_profile=((6, 0.1),))
    assert exact.exact_pair_counts(recs)[6] >= 250


def test_near_uniform_structure():
    x = exact.exact_pair_counts(near_uniform_40_60(500, seed=3))
    assert 120 <= x[4] / 2 <= 160, x


def test_skewed_structure():
    assert exact.exact_g(skewed(512, frac_unique=0.2, group=16, seed=4), 4) - 512 > 3000


def test_yfcc_like_shape_and_skew():
    recs = yfcc_like(2000, seed=5)
    assert recs.shape == (2000, 5)
    _, counts = np.unique(recs[:, 0], return_counts=True)
    assert counts.max() > 20


@pytest.mark.parametrize("name,args,kwargs", [
    ("dblp_like", (500,), dict(d=6, seed=3, dup_fraction=0.2)),
    ("dblp_like", (300,), dict(d=5, seed=1, dup_columns=3, cardinalities=[7, 5, 3, 9, 11])),
    ("shingle_records", (700,), dict(d=6, seed=2, group=5)),
    ("near_uniform_40_60", (500,), dict(d=5, seed=3)),
    ("skewed", (512,), dict(frac_unique=0.1, group=16, seed=4)),
    ("yfcc_like", (2000,), dict(seed=5)),
])
def test_generators_equal_jax(name, args, kwargs):
    got = getattr(synthetic, name)(*args, **kwargs)
    want = getattr(jsyn, name)(*args, **kwargs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_seeded_generators_equal_jax():
    clusters = [(4, 64, 3), (5, 32, 2), (6, 16, 1)]
    got = synthetic.planted_cluster_records(4096, 6, np.random.default_rng(17), clusters)
    want = jsyn.planted_cluster_records(4096, 6, np.random.default_rng(17), clusters)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    for a in (1.2, 1.5):
        got = synthetic.zipf_tokens(np.random.default_rng(9), 40, 300, 1000, a=a)
        want = jsyn.zipf_tokens(np.random.default_rng(9), 40, 300, 1000, a=a)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Fast-AGMS sketch: the checks of tests/test_sketch.py
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _insert(counters, params, keys1, keys2, weights=None):
    if weights is not None:
        weights = torch.from_numpy(np.asarray(weights, np.int32))
    return sk.sketch_update(counters, _t(keys1), _t(keys2), params, weights)


def _random_stream(rng, n_distinct, zipf=1.2, total=20_000):
    freqs = rng.zipf(zipf, size=n_distinct).clip(max=total // 20).astype(np.int64)
    if freqs.sum() > total:
        freqs = np.maximum(1, freqs * total // freqs.sum())
    k1 = rng.integers(0, P31, size=n_distinct, dtype=np.uint32)
    k2 = rng.integers(0, P31, size=n_distinct, dtype=np.uint32)
    return np.repeat(k1, freqs), np.repeat(k2, freqs), float((freqs ** 2).sum())


def _params(seed, depth):
    return sk.make_sketch_params(np.random.default_rng(seed), depth, device="cpu")


def _empty(depth, width):
    return sk.empty_counters(depth, width, device="cpu")


class TestF2:
    @pytest.mark.parametrize("width,depth", [(1024, 5), (4096, 3)])
    def test_f2_relative_error(self, width, depth):
        keys1, keys2, f2 = _random_stream(np.random.default_rng(10), 3000)
        errs = []
        for seed in range(8):
            counters = _insert(_empty(depth, width), _params(seed, depth), keys1, keys2)
            est = float(sk.np_estimate_f2_exact(counters.numpy()))
            errs.append(abs(est - f2) / f2)
        assert np.median(errs) < 3 * np.sqrt(2 / width), (np.median(errs), errs)

    def test_weights_mask_elements(self):
        rng = np.random.default_rng(11)
        params = sk.make_sketch_params(rng, 3, device="cpu")
        k1 = rng.integers(0, P31, size=100, dtype=np.uint32)
        k2 = rng.integers(0, P31, size=100, dtype=np.uint32)
        w = (np.arange(100) % 2).astype(np.int32)
        c_half = _insert(_empty(3, 256), params, k1, k2, w)
        c_sub = _insert(_empty(3, 256), params, k1[1::2], k2[1::2])
        assert torch.equal(c_half, c_sub)

    def test_empty_sketch_estimates_zero(self):
        assert float(sk.estimate_f2(_empty(3, 256))) == 0.0


class TestLinearity:
    @given(st.integers(0, 2**31 - 2), st.integers(1, 50), st.integers(1, 50))
    @settings(max_examples=25, deadline=None)
    def test_merge_equals_concat(self, seed, na, nb):
        rng = np.random.default_rng(seed)
        params = sk.make_sketch_params(rng, 2, device="cpu")
        ka1, ka2 = (rng.integers(0, P31, size=na, dtype=np.uint32) for _ in range(2))
        kb1, kb2 = (rng.integers(0, P31, size=nb, dtype=np.uint32) for _ in range(2))
        ca = _insert(_empty(2, 128), params, ka1, ka2)
        cb = _insert(_empty(2, 128), params, kb1, kb2)
        c_all = _insert(_empty(2, 128), params, np.concatenate([ka1, kb1]),
                        np.concatenate([ka2, kb2]))
        assert torch.equal(sk.merge(ca, cb), c_all)

    def test_update_order_invariant(self):
        rng = np.random.default_rng(12)
        params = sk.make_sketch_params(rng, 3, device="cpu")
        k1 = rng.integers(0, P31, size=500, dtype=np.uint32)
        k2 = rng.integers(0, P31, size=500, dtype=np.uint32)
        perm = rng.permutation(500)
        assert torch.equal(_insert(_empty(3, 512), params, k1, k2),
                           _insert(_empty(3, 512), params, k1[perm], k2[perm]))


class TestInnerProduct:
    def test_join_size_estimate(self):
        """|A join B| via the sketch inner product (paper §6 mechanics)."""
        rng = np.random.default_rng(13)
        shared = rng.integers(0, P31, size=(300, 2), dtype=np.uint32)
        only_a = rng.integers(0, P31, size=(500, 2), dtype=np.uint32)
        only_b = rng.integers(0, P31, size=(400, 2), dtype=np.uint32)
        a1 = np.concatenate([shared[:, 0], shared[:, 0], only_a[:, 0]])
        a2 = np.concatenate([shared[:, 1], shared[:, 1], only_a[:, 1]])
        b1 = np.concatenate([shared[:, 0], only_b[:, 0]])
        b2 = np.concatenate([shared[:, 1], only_b[:, 1]])
        ests = []
        for seed in range(8):
            params = _params(100 + seed, 5)
            ca = _insert(_empty(5, 2048), params, a1, a2)
            cb = _insert(_empty(5, 2048), params, b1, b2)
            ests.append(float(sk.estimate_inner(ca, cb)))
        assert abs(np.median(ests) - 600) / 600 < 0.25, ests


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_estimates_equal_jax_median(depth):
    """float32 median-of-rows estimates equal ``jnp``'s: exactly where the
    float32 row sums are exact; beyond, within the float32 bound of a sum
    of w terms in another order, w * eps * sum |terms|; at an even depth
    the median is the mean of the two middle rows, not the lower one."""
    rng = np.random.default_rng(depth)
    for lo, hi, exact_sums in ((-40, 41, True), (-2**20, 2**20, False)):
        a = rng.integers(lo, hi, size=(3, 4, depth, 256)).astype(np.int32)
        b = rng.integers(lo, hi, size=(3, 4, depth, 256)).astype(np.int32)
        got = (sk.estimate_f2(torch.from_numpy(a)).numpy(),
               sk.estimate_inner(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
               sk.merge(torch.from_numpy(a), torch.from_numpy(b)).numpy())
        want = (np.asarray(jsk.estimate_f2(jnp.asarray(a))),
                np.asarray(jsk.estimate_inner(jnp.asarray(a), jnp.asarray(b))),
                np.asarray(jsk.merge(jnp.asarray(a), jnp.asarray(b))))
        terms = np.abs(a.astype(np.float64)) * np.maximum(np.abs(a), np.abs(b))
        bound = a.shape[-1] * np.finfo(np.float32).eps * terms.sum(-1).max()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if exact_sums or g.dtype == np.int32:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=bound)
    if depth % 2 == 0:
        rows = np.zeros((1, depth, 4), np.int32)
        rows[0, :, 0] = np.arange(1, depth + 1)           # row sums of squares 1, 4, 9, ...
        mid = ((depth // 2) ** 2 + (depth // 2 + 1) ** 2) / 2
        assert float(sk.estimate_f2(torch.from_numpy(rows))[0]) == mid
        assert float(jsk.estimate_f2(jnp.asarray(rows))[0]) == mid
