"""The paper's accuracy claims through the port on the CPU: the checks of
``tests/test_paper_accuracy.py``, ``tests/test_error_bounds.py`` and
``tests/test_sjpc_estimator.py`` run through ``repro_torch``, plus the
port's SJPC g tables against the JAX package's on the same hash seeds and
sampling keys, within 1e-6.

* Paper accuracy (Figs. 4/8): on a seeded planted-cluster workload in the
  g_s >> n regime, SJPC's median relative error beats equal-space random
  sampling, and the served SJPC stream beats the served equal-space
  reservoir, at every mid-band threshold.
* Error bounds (Theorems 1/2) and the estimator's invariants: exactness
  of the inversion, unbiasedness, batch-split invariance, joins.

Everything is seeded.  The slow lane (``-m slow``) adds trials, the
LSH-SS column and the Chebyshev checks of Theorem 2, as the reference's
slow lane does.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax  # noqa: E402

from repro.core import sjpc as jsjpc  # noqa: E402
from repro_torch.core import baselines, exact, prng, sjpc  # noqa: E402
from repro_torch.core.projections import lattice, sample_combo_weights  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.service import EstimationService, ServiceConfig  # noqa: E402

D = 6
N = 32768
S_SKETCH = 4               # sketch threshold (levels 4..6)
MID_BAND = (4, 5)          # thresholds the win is asserted on
WIDTH, DEPTH, RATIO = 2048, 3, 1.0
BASE_SEED = 900
CLUSTERS = [(4, 384, 3), (5, 256, 2), (6, 128, 1)]


@pytest.fixture(scope="module")
def workload():
    vals = synthetic.planted_cluster_records(N, D, np.random.default_rng(17), CLUSTERS)
    x_exact = exact.exact_pair_counts(vals)
    g_true = {s: float(x_exact[s:].sum() + N) for s in MID_BAND}
    assert all(g > 3 * N for g in g_true.values())      # the g_s >> n regime
    return vals, g_true


def _cfg(seed, **kw):
    kw = {"d": D, "s": S_SKETCH, "ratio": RATIO, "width": WIDTH, "depth": DEPTH, **kw}
    return SJPCConfig(seed=seed, **kw)


def _sjpc_g_row(vals, trial, **kw):
    """One fresh-hash-draw SJPC run through the fused path -> g at every
    threshold s..d."""
    cfg = _cfg(BASE_SEED + trial, **kw)
    params, state = sjpc.init(cfg, device="cpu")
    state = sjpc.update_fused(cfg, params, state, vals, key=prng.PRNGKey(40 + trial))
    be = sjpc.estimate_batch(cfg, state.counters[None], np.array([float(state.n)], np.float32))
    return be.g[0]


def _jax_g_row(vals, trial, **kw):
    cfg = jsjpc.SJPCConfig(**{"d": D, "s": S_SKETCH, "ratio": RATIO, "width": WIDTH,
                              "depth": DEPTH, **kw}, seed=BASE_SEED + trial)
    params, state = jsjpc.init(cfg)
    state = jsjpc.update_fused(cfg, params, state, vals, key=jax.random.PRNGKey(40 + trial),
                               use_pallas=False)
    be = jsjpc.estimate_batch(cfg, state.counters[None],
                              np.array([float(state.n)], np.float32))
    return np.asarray(be.g[0])


def _sjpc_g_table(vals, trial):
    g = _sjpc_g_row(vals, trial)
    return {s: float(g[s - S_SKETCH]) for s in MID_BAND}


def _equal_space_sample() -> int:
    return baselines.sample_size_for_bytes(_cfg(0).counters_bytes, D * 4)


def _run_comparison(vals, g_true, trials):
    sample = _equal_space_sample()
    assert sample < N // 8
    errs = {"sjpc": {s: [] for s in MID_BAND}, "rs": {s: [] for s in MID_BAND}}
    ests = []
    for t in range(trials):
        g_sj = _sjpc_g_table(vals, t)
        rng = np.random.default_rng(1000 + t)
        for s in MID_BAND:
            g_rs = baselines.random_sampling_g(vals, s, sample, rng)
            ests += [g_sj[s], g_rs]
            errs["sjpc"][s].append(abs(g_sj[s] - g_true[s]) / g_true[s])
            errs["rs"][s].append(abs(g_rs - g_true[s]) / g_true[s])
    return errs, ests


# ---------------------------------------------------------------------------
# the checks of tests/test_paper_accuracy.py
# ---------------------------------------------------------------------------

def test_sjpc_beats_equal_space_random_sampling(workload):
    vals, g_true = workload
    errs, ests = _run_comparison(vals, g_true, trials=5)
    for s in MID_BAND:
        sj = float(np.median(errs["sjpc"][s]))
        rs = float(np.median(errs["rs"][s]))
        assert sj < rs, (s, sj, rs)
        assert sj < 0.15, (s, sj)
    assert all(np.isfinite(e) and e >= 0 for e in ests)


def test_estimates_finite_and_nonnegative_small(workload):
    vals, _ = workload
    sub = vals[:2048]
    g_sj = _sjpc_g_table(sub, 0)
    rng = np.random.default_rng(3)
    for s in MID_BAND:
        assert np.isfinite(g_sj[s]) and g_sj[s] >= 0
        g_rs = baselines.random_sampling_g(sub, s, 256, rng)
        g_lsh = baselines.lsh_ss_g(sub, s, rng, m_h=128, m_l=128)
        assert np.isfinite(g_rs) and g_rs >= sub.shape[0]
        assert np.isfinite(g_lsh) and g_lsh >= sub.shape[0]


def test_served_sjpc_beats_served_reservoir_equal_space(workload):
    """The headline comparison through the port's service: SJPC and the
    streaming reservoir in one hash group at derived equal-space budgets,
    on the same stream."""
    vals, g_true = workload
    errs = {"sjpc": {s: [] for s in MID_BAND}, "res": {s: [] for s in MID_BAND}}
    for t in range(5):
        cfg = _cfg(BASE_SEED + 50 + t)
        svc = EstimationService(ServiceConfig(batch_rows=2048, window_epochs=None,
                                              device="cpu"))
        svc.create_group("g", cfg)
        svc.create_stream("sjpc", "g")
        svc.create_stream("res", "g", estimator="reservoir")
        res_est = svc.registry.stream("res").estimator
        assert res_est.memory_bytes() <= cfg.counters_bytes
        assert res_est.cfg.capacity < N // 8
        for nm in ("sjpc", "res"):
            svc.ingest(nm, vals)
        snap = svc.snapshot()
        for nm in ("sjpc", "res"):
            for s in MID_BAND:
                g = snap.self_join(nm, s).estimate
                assert np.isfinite(g) and g >= 0
                errs[nm][s].append(abs(g - g_true[s]) / g_true[s])
    for s in MID_BAND:
        sj = float(np.median(errs["sjpc"][s]))
        rs = float(np.median(errs["res"][s]))
        assert sj < rs, (s, sj, rs)
        assert sj < 0.15, (s, sj)


@pytest.mark.slow
def test_sjpc_beats_random_sampling_more_trials_and_lsh_finite(workload):
    vals, g_true = workload
    errs, _ = _run_comparison(vals, g_true, trials=9)
    for s in MID_BAND:
        assert float(np.median(errs["sjpc"][s])) < float(np.median(errs["rs"][s]))
    for t in range(3):
        rng = np.random.default_rng(4000 + t)
        for s in MID_BAND:
            g_lsh = baselines.lsh_ss_g(vals, s, rng, m_h=1024, m_l=1024)
            assert np.isfinite(g_lsh) and g_lsh >= N


@pytest.mark.parametrize("trial,ratio", [(0, 1.0), (1, 1.0), (2, 0.5)])
def test_sjpc_g_tables_equal_jax(workload, trial, ratio):
    """The same hash seed and sampling key give the JAX package's g table
    (float32 epilogue: within 1e-6)."""
    vals, _ = workload
    got = _sjpc_g_row(vals, trial, ratio=ratio)
    want = _jax_g_row(vals, trial, ratio=ratio)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the checks of tests/test_error_bounds.py
# ---------------------------------------------------------------------------

POINTS = [(4, 2, 0.5, 1024, 3), (4, 2, 1.0, 512, 3), (5, 3, 0.5, 2048, 3),
          (4, 3, 0.5, 512, 5)]
N_RECORDS = 1500
TRIALS = 10
CONF_K = 3.0
MIN_FRACTION = 0.8


def _bound_data(d: int) -> np.ndarray:
    return np.random.default_rng(2026).integers(0, 6, size=(N_RECORDS, d)).astype(np.uint32)


def _trial_estimates(cfg: SJPCConfig, values: np.ndarray) -> list[float]:
    out = []
    for trial in range(TRIALS):
        tcfg = SJPCConfig(d=cfg.d, s=cfg.s, ratio=cfg.ratio, width=cfg.width,
                          depth=cfg.depth, seed=cfg.seed + trial)
        params, state = sjpc.init(tcfg, device="cpu")
        state = sjpc.update_fused(tcfg, params, state, values,
                                  key=prng.PRNGKey(9000 + trial))
        out.append(sjpc.estimate(tcfg, state).g_s)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("d,s,ratio,width,depth", POINTS)
def test_theorem2_bound_holds_at_stated_confidence(d, s, ratio, width, depth):
    cfg = SJPCConfig(d=d, s=s, ratio=ratio, width=width, depth=depth, seed=100)
    values = _bound_data(d)
    g = exact.exact_g(values, s)
    sigma = math.sqrt(sjpc.online_variance_bound(d, s, ratio, width, float(N_RECORDS), g))
    rel = np.array([(est - g) / g for est in _trial_estimates(cfg, values)])
    assert float(np.mean(np.abs(rel) <= CONF_K * sigma)) >= MIN_FRACTION, (sigma, rel)
    assert float(np.mean(np.abs(rel))) <= sigma


@pytest.mark.parametrize("d,s,ratio", [(4, 2, 0.5), (5, 3, 1.0)])
def test_offline_bound_dominated_by_online(d, s, ratio):
    g = exact.exact_g(_bound_data(d), s)
    off = sjpc.offline_variance_bound(d, s, ratio, g)
    bounds = [sjpc.online_variance_bound(d, s, ratio, w, float(N_RECORDS), g)
              for w in (256, 1024, 4096)]
    assert all(on > off for on in bounds)
    assert bounds[0] > bounds[1] > bounds[2]
    assert off == jsjpc.offline_variance_bound(d, s, ratio, g)
    assert bounds[1] == jsjpc.online_variance_bound(d, s, ratio, 1024, float(N_RECORDS), g)


@pytest.mark.slow
def test_estimator_concentrates_with_width():
    d, s, ratio = 4, 2, 1.0
    values = _bound_data(d)
    g = exact.exact_g(values, s)
    spreads = []
    for width in (256, 4096):
        cfg = SJPCConfig(d=d, s=s, ratio=ratio, width=width, depth=3, seed=300)
        rel = np.array([(e - g) / g for e in _trial_estimates(cfg, values)])
        spreads.append(float(np.sqrt(np.mean(rel ** 2))))
    assert spreads[1] < spreads[0]


def test_error_bound_trials_equal_jax():
    """Two trials of an error-bound point: the port's g_s equals the JAX
    package's on the same seeds and keys (float64 epilogue on int64-exact
    moments: equal)."""
    d, s, ratio, width, depth = POINTS[2]
    values = _bound_data(d)
    for trial in range(2):
        cfg = SJPCConfig(d=d, s=s, ratio=ratio, width=width, depth=depth, seed=100 + trial)
        params, state = sjpc.init(cfg, device="cpu")
        state = sjpc.update_fused(cfg, params, state, values, key=prng.PRNGKey(9000 + trial))
        jcfg = jsjpc.SJPCConfig(d=d, s=s, ratio=ratio, width=width, depth=depth,
                                seed=100 + trial)
        jparams, jstate = jsjpc.init(jcfg)
        jstate = jsjpc.update_fused(jcfg, jparams, jstate, values,
                                    key=jax.random.PRNGKey(9000 + trial), use_pallas=False)
        np.testing.assert_array_equal(state.counters.numpy(), np.asarray(jstate.counters))
        assert sjpc.estimate(cfg, state).g_s == jsjpc.estimate(jcfg, jstate).g_s


# ---------------------------------------------------------------------------
# the checks of tests/test_sjpc_estimator.py
# ---------------------------------------------------------------------------

def _run_sjpc(vals, cfg):
    params, state = sjpc.init(cfg, device="cpu")
    return sjpc.update(cfg, params, state, vals)


def test_table_1():
    """The running example: 4 rows, 3 columns, exactly 4 ordered 2-similar
    pairs and no 3-similar pair (paper Table 1 / §3)."""
    tbl = np.array([[1, 10, 100], [2, 20, 200], [1, 10, 300], [3, 20, 200]], dtype=np.uint32)
    x = exact.exact_pair_counts(tbl)
    assert x[3] == 0 and x[2] == 4 and x[1] == 0
    y = exact.exact_level_join_sizes(tbl)
    assert y[2] == 16 and y[3] == 4
    assert exact.exact_g(tbl, 2) == 8.0


@given(st.integers(0, 10_000), st.integers(2, 40), st.integers(2, 5), st.integers(2, 4))
@settings(max_examples=40, deadline=None)
def test_lattice_inversion_equals_brute_force(seed, n, d, card):
    vals = np.random.default_rng(seed).integers(0, card, size=(n, d)).astype(np.uint32)
    np.testing.assert_allclose(exact.exact_pair_counts(vals), exact.brute_force_pair_counts(vals))


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_r1_widesketch_close(seed):
    vals = np.random.default_rng(seed).integers(0, 4, size=(60, 4)).astype(np.uint32)
    cfg = SJPCConfig(d=4, s=2, ratio=1.0, width=8192, depth=5, seed=seed ^ 0xABC)
    est = sjpc.estimate(cfg, _run_sjpc(vals, cfg))
    true_g = exact.exact_g(vals, 2)
    assert abs(est.g_s - true_g) / true_g < 0.05


def test_inversion_is_exact_given_exact_y():
    vals = np.random.default_rng(123).integers(0, 5, size=(300, 5)).astype(np.uint32)
    y = exact.exact_level_join_sizes(vals)
    x_true = exact.exact_pair_counts(vals)
    for s in range(1, 6):
        x = sjpc.f2_to_pair_count(5, s, 300, 1.0, y[s:], clamp=False)
        np.testing.assert_allclose(x, x_true[s:], rtol=1e-12)


def test_sampled_estimator_unbiased():
    """Eq. 4 inversion with r < 1: the mean over seeds is within a few
    percent of the truth."""
    vals = np.random.default_rng(42).integers(0, 6, size=(400, 5)).astype(np.uint32)
    true_g = exact.exact_g(vals, 3)
    ests = [sjpc.estimate(cfg, _run_sjpc(vals, cfg)).g_s
            for cfg in (SJPCConfig(d=5, s=3, ratio=0.5, width=4096, depth=5, seed=seed)
                        for seed in range(12))]
    assert abs(np.mean(ests) - true_g) / true_g < 0.08, (np.mean(ests), true_g)


def test_error_within_theorem1_bound():
    vals = np.random.default_rng(7).integers(0, 6, size=(400, 5)).astype(np.uint32)
    true_g = exact.exact_g(vals, 3)
    bound_std = math.sqrt(sjpc.offline_variance_bound(5, 3, 0.5, true_g))
    ests = [sjpc.estimate(cfg, _run_sjpc(vals, cfg)).g_s
            for cfg in (SJPCConfig(d=5, s=3, ratio=0.5, width=8192, depth=5, seed=1000 + seed)
                        for seed in range(12))]
    assert np.std(ests) / true_g < bound_std


def test_batch_split_invariance():
    vals = np.random.default_rng(3).integers(0, 5, size=(128, 4)).astype(np.uint32)
    cfg = SJPCConfig(d=4, s=2, ratio=1.0, width=512, depth=3, seed=5)
    params, empty = sjpc.init(cfg, device="cpu")
    s_all = sjpc.update(cfg, params, empty, vals)
    merged = sjpc.merge(sjpc.update(cfg, params, empty, vals[:64]),
                        sjpc.update(cfg, params, empty, vals[64:]))
    assert torch.equal(s_all.counters, merged.counters)
    assert float(merged.n) == 128.0


def test_counts_records():
    cfg = SJPCConfig(d=3, s=2, ratio=1.0, width=256, depth=2)
    params, state = sjpc.init(cfg, device="cpu")
    state = sjpc.update(cfg, params, state, np.zeros((32, 3), np.uint32))
    state = sjpc.update(cfg, params, state, np.zeros((16, 3), np.uint32))
    assert float(state.n) == 48.0


@given(st.integers(0, 1000), st.floats(0.2, 1.0), st.integers(2, 30))
@settings(max_examples=30, deadline=None)
def test_sample_weights_row_counts(seed, ratio, m):
    w = sample_combo_weights(prng.PRNGKey(seed), 64, m, ratio).numpy()
    assert w.shape == (64, m)
    lo = math.floor(m * ratio + 1e-9)
    counts = w.sum(axis=1)
    assert ((counts == lo) | (counts == min(lo + 1, m))).all()


def test_inclusion_probability_uniform():
    w = sample_combo_weights(prng.PRNGKey(0), 20_000, 10, 0.35).numpy()
    np.testing.assert_allclose(w.mean(axis=0), 0.35, atol=0.02)


def test_lattice_levels():
    lv = lattice(5, 2)
    assert [level.k for level in lv] == [2, 3, 4, 5]
    assert [level.num for level in lv] == [10, 10, 5, 1]
    ids = np.concatenate([level.ids for level in lv])
    assert len(np.unique(ids)) == len(ids)


def test_join_size_two_streams():
    rng = np.random.default_rng(21)
    a = rng.integers(0, 5, size=(300, 4)).astype(np.uint32)
    b = rng.integers(0, 5, size=(250, 4)).astype(np.uint32)
    true_j = exact.exact_join_g(a, b, 3)
    ests = []
    for seed in range(8):
        cfg = SJPCConfig(d=4, s=3, ratio=1.0, width=4096, depth=5, seed=seed)
        params, empty = sjpc.init(cfg, device="cpu")
        sa = sjpc.update(cfg, params, empty, a)
        sb = sjpc.update(cfg, params, empty, b)
        ests.append(sjpc.estimate_join(cfg, sa, sb).g_s)
    assert abs(np.median(ests) - true_j) / max(true_j, 1) < 0.25


def test_counterexample_selfjoin_bound_does_not_hold():
    """Paper §6: |A sim-join B| can exceed (SJ(A) + SJ(B)) / 2."""
    a = np.array([[1, 2, 3, 4]], dtype=np.uint32)
    b = np.array([[1, 2, 30, 40], [10, 20, 3, 4]], dtype=np.uint32)
    join_size = exact.exact_join_g(a, b, 2)
    assert join_size == 2
    assert join_size > (exact.exact_g(a, 2) + exact.exact_g(b, 2)) / 2 - 1e-9


def test_variance_bounds():
    assert sjpc.offline_variance_bound(6, 3, 0.5, 1000) > sjpc.offline_variance_bound(
        6, 5, 0.5, 1000)
    assert sjpc.online_variance_bound(6, 4, 0.5, 1024, 500, 1000) > sjpc.offline_variance_bound(
        6, 4, 0.5, 1000)
