"""The PyTorch port's field arithmetic, hashes, fingerprints and lattice
tables, bit-exact against the JAX package and its numpy oracles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import fingerprint as jfp
from repro.core import hashing as jh
from repro.core import projections as jproj
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hashing as th
from repro_torch.core import projections as tproj

P = int(jh.P31)
EDGES = np.array([0, 1, 2, 3, P - 2, P - 1, 1 << 16, (1 << 16) - 1, (1 << 30) + 7,
                  123456789], dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _field_operands(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([EDGES, rng.integers(0, P, size=500, dtype=np.uint32)])
    b = np.concatenate([EDGES[::-1], rng.integers(0, P, size=500, dtype=np.uint32)])
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mulmod_addmod_match_limb_arithmetic(seed):
    a, b = _field_operands(seed)
    np.testing.assert_array_equal(th.mulmod_p31(_t(a), _t(b)).numpy(),
                                  np.asarray(jh.mulmod_p31(a, b)))
    np.testing.assert_array_equal(th.mulmod_p31(_t(a), _t(b)).numpy(),
                                  jh.np_mulmod_p31(a, b))
    np.testing.assert_array_equal(th.addmod_p31(_t(a), _t(b)).numpy(),
                                  np.asarray(jh.addmod_p31(a, b)))


def test_reduce_covers_the_whole_uint32_range():
    rng = np.random.default_rng(3)
    x = np.concatenate([np.array([0, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 1,
                                  0xFFFFFFFF, 0xFFFFFFFE], np.uint32),
                        rng.integers(0, 2**32, size=1000, dtype=np.uint32)])
    np.testing.assert_array_equal(th.reduce_p31(_t(x)).numpy(), np.asarray(jh.reduce_p31(x)))


@pytest.mark.parametrize("depth", [1, 3])
def test_cw_hash_pair_bucket_sign(depth):
    rng = np.random.default_rng(10 + depth)
    x = rng.integers(0, P, size=300, dtype=np.uint32)
    y = rng.integers(0, P, size=300, dtype=np.uint32)
    coeffs = jh.random_field_elements(rng, (depth, 1, 2, 4))
    want = np.asarray(jh.cw_hash_pair(x[None], y[None], coeffs))
    got = th.cw_hash_pair(_t(x)[None], _t(y)[None], _t(coeffs)).numpy()
    np.testing.assert_array_equal(got, want)
    single = th.cw_hash(_t(x), _t(coeffs[0, 0, 0])).numpy()
    np.testing.assert_array_equal(single, jh.np_cw_hash(x, coeffs[0, 0, 0]))
    for width in (64, 1024, 1 << 16):
        np.testing.assert_array_equal(th.hash_bucket(_t(want), width).numpy(),
                                      np.asarray(jh.hash_bucket(want, width)))
    sign = th.hash_sign(_t(want))
    assert sign.dtype == torch.int32
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jh.hash_sign(want)))


def test_same_numpy_draws():
    a = jh.random_field_elements(np.random.default_rng(5), (3, 2, 4))
    b = th.random_field_elements(np.random.default_rng(5), (3, 2, 4))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jfp.make_fingerprint_bases(np.random.default_rng(6)),
                                  tfp.make_fingerprint_bases(np.random.default_rng(6)))


def test_as_field_tensor_wraps_like_uint32():
    x = np.array([[-1, 0, 5], [2**31 - 1, -(2**31), 7]], np.int32)
    want = x.astype(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(th.as_field_tensor(x, "cpu").numpy(), want)
    np.testing.assert_array_equal(th.as_field_tensor(torch.from_numpy(x), "cpu").numpy(),
                                  want)


def test_as_field_tensor_takes_any_host_array():
    """Host data goes up as 4-byte words: reversed and read-only views, a
    0-d array, a list with a negative entry and uint64 data above 2^32
    all give their uint32 values."""
    x = np.arange(12, dtype=np.uint32).reshape(3, 4) * np.uint32(0x1555_5555)
    frozen = x.copy()
    frozen.flags.writeable = False
    for arr in (x[::-1, ::2], frozen, x.T):
        np.testing.assert_array_equal(th.as_field_tensor(arr, "cpu").numpy(),
                                      arr.astype(np.int64))
    assert th.as_field_tensor(np.uint32(7), "cpu").shape == ()
    assert th.as_field_tensor([-1, 3], "cpu").tolist() == [2**32 - 1, 3]
    assert th.as_field_tensor(np.array([2**40 + 9], np.uint64), "cpu").tolist() == [9]


@pytest.mark.parametrize("B,d,s", [(1, 4, 2), (37, 5, 3), (64, 6, 1)])
def test_fingerprints_match_jax_and_numpy(B, d, s):
    rng = np.random.default_rng(B * 100 + d)
    values = rng.integers(0, 2**32, size=(B, d), dtype=np.uint32)
    bases = jfp.make_fingerprint_bases(rng)
    for level in jproj.lattice(d, s):
        want = jfp.subvalue_fingerprints(jnp.asarray(values), jnp.asarray(level.masks),
                                         jnp.asarray(level.ids), jnp.asarray(bases))
        oracle = tfp.np_subvalue_fingerprints(values, level.masks, level.ids, bases)
        got = tfp.subvalue_fingerprints(_t(values), _t(level.masks), _t(level.ids), _t(bases))
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o)


@pytest.mark.parametrize("B,d,s", [(1, 4, 2), (37, 5, 3), (64, 6, 1)])
def test_np_subvalue_fingerprints_copy_equals_jax(B, d, s):
    """The port's numpy oracle is a copy of the JAX package's."""
    rng = np.random.default_rng(B * 7 + d)
    values = rng.integers(0, 2**32, size=(B, d), dtype=np.uint32)
    bases = jfp.make_fingerprint_bases(rng)
    for level in jproj.lattice(d, s):
        got = tfp.np_subvalue_fingerprints(values, level.masks, level.ids, bases)
        want = jfp.np_subvalue_fingerprints(values, level.masks, level.ids, bases)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("d,s", [(4, 2), (6, 3), (7, 1)])
def test_lattice_tables_equal(d, s):
    for a, b in zip(jproj.lattice(d, s), tproj.lattice(d, s)):
        assert a.k == b.k
        np.testing.assert_array_equal(a.masks, b.masks)
        np.testing.assert_array_equal(a.ids, b.ids)
    pa, pb = jproj.padded_lattice(d, s), tproj.padded_lattice(d, s)
    for field in ("masks", "ids", "valid"):
        np.testing.assert_array_equal(getattr(pa, field), getattr(pb, field))
    assert pa.nums == pb.nums
    ca, cb = jproj.concat_lattice(d, s), tproj.concat_lattice(d, s)
    for field in ("masks", "ids", "level_of"):
        np.testing.assert_array_equal(getattr(ca, field), getattr(cb, field))
    for m in range(1, 25):
        for r in (0.3, 0.5, 1.0):
            assert jproj.sample_size_parts(m, r) == tproj.sample_size_parts(m, r)
