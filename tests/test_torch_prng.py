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
    got = prng.uniform(tkey, shape)
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
        got = tproj.sample_combo_weights(tkey, batch, m, ratio)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
