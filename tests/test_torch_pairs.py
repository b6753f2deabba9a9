"""The plain versions of the port's estimator-path kernels -- fused_pairs,
sketch_update, sketch_moments -- against the JAX package's kernels, run as
its own tests run them (the Pallas kernels in interpret mode, the jnp
oracles), the ``update_fn`` hook of ``sjpc.update``, and the copied exact
oracles.  Integer outputs are held bit-exact; sketch_moments above 2^24
against the int64 oracle to 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_cases import PAIRS_SHAPES, pairs_case, sketch_update_case
from repro.core import exact as jexact
from repro.core import sjpc as jsjpc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_pairs import fused_pairs_pallas
from repro.kernels.sketch_moments import sketch_moments_pallas
from repro.kernels.sketch_update import sketch_update_pallas
from repro_torch.core import exact as texact
from repro_torch.core import sjpc as tsjpc
from repro_torch.kernels import ops, ref
from repro_torch.obs.metrics import default_registry


def _t(a):
    """A JAX/numpy argument as the port takes it: int64 field data, int32
    counters, weights and flags."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.int64))


def _brute(items, valid):
    out = []
    for sample, live in zip(items, valid):
        sub = sample[live != 0]
        out.append(texact.brute_force_pair_counts(sub) if sub.shape[0]
                   else np.zeros(items.shape[-1] + 1))
    return np.stack(out).astype(np.int64)


# ---------------------------------------------------------------------------
# fused_pairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,R,d", PAIRS_SHAPES)
def test_fused_pairs_ref_matches_jax_kernel_and_oracles(N, R, d):
    rng = np.random.default_rng(N * 1000 + R * 10 + d)
    items, valid = pairs_case(rng, N, R, d)
    got = ref.fused_pairs_ref(_t(items), _t(valid))
    assert got.dtype == torch.int32 and got.shape == (N, d + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fused_pairs_pallas(items, valid,
                                                                             interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.fused_pairs_ref(items, valid)))
    np.testing.assert_array_equal(got.numpy(), _brute(items, valid))


@pytest.mark.parametrize("case", ["all-invalid", "single-valid", "duplicates", "distinct"])
def test_fused_pairs_edges(case):
    rng = np.random.default_rng(7)
    items, valid = pairs_case(rng, 2, 140, 6)
    if case == "all-invalid":
        valid[:] = 0
    elif case == "single-valid":
        valid[:] = 0
        valid[:, 77] = 1
    elif case == "duplicates":
        items[:] = 7
        valid[:] = 1
    else:
        items = rng.integers(0, 2**32, size=items.shape, dtype=np.uint64).astype(np.uint32)
    got = ref.fused_pairs_ref(_t(items), _t(valid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.fused_pairs_ref(items, valid)))
    np.testing.assert_array_equal(got, _brute(items, valid))
    if case == "duplicates":
        assert (got[:, 6] == 140 * 139).all() and got[:, :6].sum() == 0


def test_fused_pairs_chunking_is_invisible(monkeypatch):
    """The plain version bins its match tensor in chunks of samples; any
    chunk size gives the same histograms."""
    rng = np.random.default_rng(9)
    items, valid = pairs_case(rng, 7, 60, 4)
    want = ref.fused_pairs_ref(_t(items), _t(valid))
    monkeypatch.setattr(ref, "PAIRS_CHUNK", 60 * 60 * 2)
    assert torch.equal(ref.fused_pairs_ref(_t(items), _t(valid)), want)


def test_fused_pairs_entry_point_leading_dims_and_empty():
    rng = np.random.default_rng(11)
    items, valid = pairs_case(rng, 6, 33, 4)
    stacked_items, stacked_valid = items.reshape(2, 3, 33, 4), valid.reshape(2, 3, 33)
    got = ops.fused_pairs(_t(stacked_items), _t(stacked_valid))
    assert got.shape == (2, 3, 5)
    want = jops.fused_pairs(stacked_items, stacked_valid, impl="jnp_ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # R == 0: the zero histogram, and the call is still counted
    metrics = default_registry()
    before = metrics.counter("kernel_dispatch_total", kernel="fused_pairs", impl="torch_ref")
    empty = ops.fused_pairs(torch.zeros((3, 0, 4), dtype=torch.int64),
                            torch.zeros((3, 0), dtype=torch.int32))
    assert empty.shape == (3, 5) and int(empty.abs().sum()) == 0
    assert metrics.counter("kernel_dispatch_total", kernel="fused_pairs",
                           impl="torch_ref") == before + 1
    np.testing.assert_array_equal(
        empty.numpy(), np.asarray(jops.fused_pairs(np.zeros((3, 0, 4), np.uint32),
                                                   np.zeros((3, 0), np.int32))))


# ---------------------------------------------------------------------------
# sketch_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t,w", [(1, 3, 128), (257, 3, 256), (1024, 5, 512), (300, 1, 64)])
def test_sketch_update_ref_matches_jax_kernel(n, t, w):
    args = sketch_update_case(np.random.default_rng(n + t + w), n, t, w)
    got = ref.sketch_update_ref(*(_t(a) for a in args))
    assert got.dtype == torch.int32 and got.shape == (t, w)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(sketch_update_pallas(*args, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.sketch_update_ref(*args)))


def test_sketch_update_zero_weights_and_entry_point():
    rng = np.random.default_rng(5)
    args = sketch_update_case(rng, 64, 2, 128, all_zero_weights=True)
    targs = [_t(a) for a in args]
    assert torch.equal(ref.sketch_update_ref(*targs), targs[0])
    counters, fp1, fp2, bc, sc, _ = sketch_update_case(rng, 200, 3, 256)
    params = tsjpc.sk.SketchParams(_t(bc), _t(sc))
    got = ops.sketch_update(_t(counters), _t(fp1), _t(fp2), params)       # weights None: 1
    want = jops.sketch_update(counters, fp1, fp2, jsjpc.sk.SketchParams(bc, sc), None,
                              impl="jnp_ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# sketch_moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,w", [(1, 128), (3, 256), (5, 512), (3, 2048)])
def test_sketch_moments_ref_matches_jax_kernel_below_2_24(t, w):
    rng = np.random.default_rng(t * w)
    a, b = (rng.integers(-60, 60, size=(t, w)).astype(np.int32) for _ in range(2))
    for x, y in ((a, b), (a, a)):
        got = ref.sketch_moments_ref(_t(x), _t(y))
        assert got.dtype == torch.float32 and got.shape == (t,)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(sketch_moments_pallas(x, y, interpret=True)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jref.sketch_moments_ref(x, y)))
        np.testing.assert_array_equal(ops.sketch_moments(_t(x), _t(y)).numpy(), got.numpy())
    np.testing.assert_array_equal(ops.sketch_moments(_t(a)).numpy(),
                                  ref.sketch_moments_ref(_t(a), _t(a)).numpy())


def test_sketch_moments_above_2_24_against_int64_oracle():
    rng = np.random.default_rng(3)
    a = rng.integers(-(2**20), 2**20, size=(3, 1024)).astype(np.int32)
    b = rng.integers(-(2**20), 2**20, size=(3, 1024)).astype(np.int32)
    got = ref.sketch_moments_ref(_t(a), _t(b)).numpy().astype(np.float64)
    oracle = (a.astype(np.int64) * b.astype(np.int64)).sum(axis=-1).astype(np.float64)
    assert np.abs(oracle).max() > 2**24
    np.testing.assert_allclose(got, oracle, rtol=1e-6)
    np.testing.assert_array_equal(got, oracle.astype(np.float32))   # the int64 sum, cast once


# ---------------------------------------------------------------------------
# sjpc.update through the update_fn hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3])
def test_update_through_the_sketch_update_op_equals_update_fused(depth):
    kw = dict(d=5, s=3, ratio=1.0, width=128, depth=depth, seed=31)
    jcfg, tcfg = jsjpc.SJPCConfig(**kw), tsjpc.SJPCConfig(**kw)
    jparams, jstate = jsjpc.init(jcfg)
    tparams, hooked = tsjpc.init(tcfg, device="cpu")
    fused = hooked
    rng = np.random.default_rng(depth)
    for i in range(3):
        values = rng.integers(0, 4, size=(40, 5)).astype(np.uint32)
        mask = (rng.random(40) < 0.7).astype(np.int32) if i == 1 else None
        hooked = tsjpc.update(tcfg, tparams, hooked, values, row_mask=mask,
                              update_fn=ops.make_sjpc_update_fn())
        fused = tsjpc.update_fused(tcfg, tparams, fused, values, row_mask=mask)
        jstate = jsjpc.update(jcfg, jparams, jstate, values, row_mask=mask,
                              update_fn=jops.make_sjpc_update_fn(use_pallas=False))
    assert torch.equal(hooked.counters, fused.counters)
    np.testing.assert_array_equal(hooked.counters.numpy(), np.asarray(jstate.counters))
    assert float(hooked.n) == float(jstate.n) and int(hooked.step) == int(jstate.step)


# ---------------------------------------------------------------------------
# the exact oracles, copied
# ---------------------------------------------------------------------------

def test_exact_oracles_equal_the_jax_package():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 3, size=(60, 4)).astype(np.uint32)
    b = rng.integers(0, 3, size=(45, 4)).astype(np.uint32)
    np.testing.assert_array_equal(texact.brute_force_pair_counts(a),
                                  jexact.brute_force_pair_counts(a))
    np.testing.assert_array_equal(texact.brute_force_join_counts(a, b),
                                  jexact.brute_force_join_counts(a, b))
    for s in (1, 2, 4):
        assert texact.exact_g(a, s) == jexact.exact_g(a, s)
        assert texact.exact_join_g(a, b, s) == jexact.exact_join_g(a, b, s)
    # the brute force agrees with the group-by inversion
    np.testing.assert_array_equal(texact.brute_force_pair_counts(a)[1:],
                                  texact.exact_pair_counts(a)[1:])
