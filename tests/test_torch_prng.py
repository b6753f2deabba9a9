"""The port's replay of ``jax.random`` (threefry2x32, partitionable) and the
projection sampling built on it, bit-exact against jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import projections as jproj
from repro_torch.core import prng
from repro_torch.core import projections as tproj

SEEDS = [0, 1, 0x5A5A ^ 0xC0FFEE, 2**31 - 1, -1, -12345, 2**32 + 9]
DATA = [0, 1, 2, 17, 2**31 - 1, 2**31, 2**32 - 1]


def _kd(key):
    """Raw uint32 key data of a legacy ``PRNGKey`` key."""
    return np.asarray(key)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tkey.numpy(), _kd(key))
    for data in DATA:
        np.testing.assert_array_equal(prng.fold_in(tkey, data).numpy(),
                                      _kd(jax.random.fold_in(key, data)))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _kd(jax.random.split(key, num)))


@pytest.mark.parametrize("seed", [0, 7, 0x5A5A ^ 0xC0FFEE])
@pytest.mark.parametrize("shape", [(1,), (3, 5), (64, 20), (2, 1)])
def test_uniform_draws(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tkey = prng.fold_in(prng.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(tkey, shape, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0.0 and want.max() < 1.0


@pytest.mark.parametrize("step", [0, 1, 5, 1000])
def test_default_key_chain(step):
    """The key ``update`` uses by default, then the per-level fold-in."""
    seed = 0x1234
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xC0FFEE), jnp.int32(step))
    tkey = prng.fold_in(prng.PRNGKey(seed ^ 0xC0FFEE), step)
    for idx in range(4):
        np.testing.assert_array_equal(prng.fold_in(tkey, idx).numpy(),
                                      _kd(jax.random.fold_in(key, idx)))


@pytest.mark.parametrize("m", [5, 64, 65, 90])
def test_descending_ranks_with_ties(m):
    """Hand-built ties on both sides of the M = 64 branch switch: ties go
    by index, as in a stable argsort."""
    rng = np.random.default_rng(m)
    scores = rng.integers(0, 4, size=(6, m)).astype(np.float32) / 4
    scores[0] = 0.5                        # all tied
    scores[1] = np.linspace(1, 0, m, endpoint=False)
    scores[2, ::2] = 0.0                   # zeros (negated to -0.0)
    want = np.asarray(jproj.descending_ranks(jnp.asarray(scores)))
    got = tproj.descending_ranks(torch.from_numpy(scores))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=1),
                                  np.broadcast_to(np.arange(m), (6, m)))


@pytest.mark.parametrize("ratio", [0.5, 1.0, 0.3])
@pytest.mark.parametrize("m", [20, 70])
def test_sample_combo_weights(ratio, m):
    for seed, batch in ((3, 1), (11, 33)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        tkey = prng.fold_in(prng.PRNGKey(seed), 2)
        want = np.asarray(jproj.sample_combo_weights(key, batch, m, ratio))
        got = tproj.sample_combo_weights(tkey, batch, m, ratio, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# randint, and stacked keys (vmap over keys in the JAX package)
# ---------------------------------------------------------------------------

def _tkey(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("minval,maxval", [
    (0, 1), (0, 7), (3, 10), (0, 1 << 16), (0, (1 << 16) + 1), (0, 1 << 20),
    (0, 2**31 - 1), (-5, 2**31 - 1), (-(2**31), 2**31 - 1), (-(2**31), 0), (-40, -3),
    (5, 5), (9, 2), (0, 1755), (0, 4096)])
def test_randint_scalar_bounds(minval, maxval):
    """Spans of 1, powers of two, just above 2^16 (where JAX's multiplier
    wraps), near 2^31 and 2^32, and maxval <= minval (always minval)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), minval & 0xFFFF)
    want = np.asarray(jax.random.randint(key, (6, 9), minval, maxval))
    got = prng.randint(_tkey(key), (6, 9), minval, maxval, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(40,), (5, 8)])
def test_randint_array_maxval(shape):
    """Per-element maxval, as the reservoir's arrival ranks use it
    (``randint(key, (B,), 0, max(gidx + 1, 1))``), including maxval <= 0."""
    rng = np.random.default_rng(sum(shape))
    maxval = rng.integers(-3, 2**31 - 1, size=shape).astype(np.int32)
    maxval.flat[:3] = (0, 1, 2**31 - 1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.randint(key, shape, 0, jnp.asarray(maxval)))
    got = prng.randint(_tkey(key), shape, 0, torch.from_numpy(maxval), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_batched_keys_and_bounds():
    """Stacked keys with per-key bounds equal ``vmap`` of randint."""
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    maxval = jnp.asarray([1, 2, 1000, 2**31 - 1, 0], jnp.int32)
    want = np.asarray(jax.vmap(lambda k, m: jax.random.randint(k, (3, 4), 0, m))(keys, maxval))
    got = prng.randint(_tkey(keys), (3, 4), 0, torch.from_numpy(np.array(maxval))[:, None, None],
                       device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        prng.randint(_tkey(keys[0]), (2,), 0, 2**31, device="cpu")


def test_stacked_keys_fold_in_split_bits():
    keys = jax.random.split(jax.random.PRNGKey(23), 4)
    tkeys = _tkey(keys)
    data = jnp.asarray([0, 1, 2**31 - 1, 7], jnp.int32)
    np.testing.assert_array_equal(
        prng.fold_in(tkeys, torch.from_numpy(np.array(data))).numpy(),
        np.asarray(jax.vmap(jax.random.fold_in)(keys, data)))
    np.testing.assert_array_equal(
        prng.fold_in(tkeys, 9).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(keys)))
    np.testing.assert_array_equal(prng.split(tkeys, 5).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(keys)))
    np.testing.assert_array_equal(
        prng.random_bits(tkeys, (2, 3), device="cpu").numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (2, 3)))(keys)))
    np.testing.assert_array_equal(
        prng.uniform(tkeys, (6,), device="cpu").numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (6,)))(keys)))
    # one key broadcast against a data grid, as the ingest key grid does
    grid = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(
        prng.fold_in(tkeys[0], torch.from_numpy(grid)).numpy(),
        np.asarray(jax.vmap(jax.vmap(lambda d: jax.random.fold_in(keys[0], d)))(grid)))
