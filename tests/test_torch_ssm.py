"""The port's Mamba2 / SSD mixer against the JAX package's on the CPU: the
chunked scan at chunks 2, 4, 8 and 16, the naive recurrence, continuation
from a carried state, the causal conv, ``mamba_block`` (with carried conv
and SSM states), ``mamba_decode_step``, and the deterministic leaves of
``init_mamba``.  Also the checks of ``tests/test_ssm.py`` through the
port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.models.layers import split_tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402

TOL = 1e-5


def _rand(seed, b=2, s=16, h=4, p=8, g=2, n=6):
    """Random SSD inputs as numpy float32: x, a, dt, bm, cm."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    a = (-rng.uniform(0.1, 2.0, size=(b, s, h)).astype(np.float32) * dt).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, a, dt, bm, cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _naive_ssd(x, a, dt, bm, cm):
    """Reference recurrence in float64: h_t = exp(a_t) h_{t-1} + dt_t B_t x_t."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = h // g
    hstate = np.zeros((b, h, n, p), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    x, a, dt, bm, cm = (np.asarray(v, np.float64) for v in (x, a, dt, bm, cm))
    for t in range(s):
        for hh in range(h):
            gg = hh // hg
            decay = np.exp(a[:, t, hh])[:, None, None]
            outer = bm[:, t, gg, :, None] * (dt[:, t, hh, None] * x[:, t, hh, :])[:, None, :]
            hstate[:, hh] = decay * hstate[:, hh] + outer
            ys[:, t, hh] = np.einsum("bn,bnp->bp", cm[:, t, gg], hstate[:, hh])
    return ys, hstate


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_equals_jax(chunk, g):
    x, a, dt, bm, cm = _rand(7 + g, g=g)
    jy, jh = jssm.ssd_chunked(*_j(x, a, dt, bm, cm), chunk=chunk)
    ty, th = tssm.ssd_chunked(*_t(x, a, dt, bm, cm), chunk=chunk)
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ssd_matches_naive_recurrence(seed):
    x, a, dt, bm, cm = _rand(seed)
    y, hf = tssm.ssd_chunked(*_t(x, a, dt, bm, cm), chunk=4)
    y_ref, h_ref = _naive_ssd(x, a, dt, bm, cm)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hf.numpy(), h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_chunk_size_invariance(chunk):
    x, a, dt, bm, cm = _t(*_rand(7))
    y_full, h_full = tssm.ssd_chunked(x, a, dt, bm, cm, chunk=16)
    y_c, h_c = tssm.ssd_chunked(x, a, dt, bm, cm, chunk=chunk)
    np.testing.assert_allclose(y_c.numpy(), y_full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_c.numpy(), h_full.numpy(), rtol=1e-4, atol=1e-4)


def test_initial_state_continuation_equals_jax():
    """SSD over the first half, then over the second from the carried
    state, equals SSD over the whole (prefill chaining), and JAX's."""
    x, a, dt, bm, cm = _rand(9, s=16)
    halves = [[v[:, :8] for v in (x, a, dt, bm, cm)], [v[:, 8:] for v in (x, a, dt, bm, cm)]]
    y1, h1 = tssm.ssd_chunked(*_t(*halves[0]), chunk=4)
    y2, h2 = tssm.ssd_chunked(*_t(*halves[1]), chunk=4, h0=h1)
    jy1, jh1 = jssm.ssd_chunked(*_j(*halves[0]), chunk=4)
    jy2, jh2 = jssm.ssd_chunked(*_j(*halves[1]), chunk=4, h0=jh1)
    _close(y2, jy2)
    _close(h2, jh2)
    y_full, h_full = tssm.ssd_chunked(*_t(x, a, dt, bm, cm), chunk=4)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-4, atol=1e-4)


def test_decay_bounds_state():
    """Strongly negative a: the state forgets, y depends on recent x only."""
    x, a, dt, bm, cm = _rand(11, s=12)
    a = np.full_like(a, -50.0)
    y, _ = tssm.ssd_chunked(*_t(x, a, dt, bm, cm), chunk=4)
    x2 = x.copy()
    x2[:, 0] *= 100
    y2, _ = tssm.ssd_chunked(*_t(x2, a, dt, bm, cm), chunk=4)
    np.testing.assert_allclose(y[:, 6:].numpy(), y2[:, 6:].numpy(), rtol=1e-5, atol=1e-5)


def test_chunk_must_tile_the_sequence():
    with pytest.raises(ValueError, match="tile"):
        tssm.ssd_chunked(*_t(*_rand(0, s=12)), chunk=8)


# ---------------------------------------------------------------------------
# the mixer: init, conv, block, decode step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mamba2-370m", "jamba-1.5-large-398b"])
def mixer(request):
    """(jax dims, params), (port dims, params): the JAX package's
    init_mamba at the reduced config, carried into the port."""
    jdims = jcompute_dims(jconfigs.reduced(request.param), tp=1)
    tdims = tcompute_dims(tconfigs.reduced(request.param), tp=1)
    jp = jax.tree_util.tree_map(np.asarray,
                                split_tree(jssm.init_mamba(jax.random.PRNGKey(3), jdims))[0])
    return (jdims, jax.tree_util.tree_map(jnp.asarray, jp)), \
        (tdims, convert.model_params_from_numpy(jp, device="cpu")), jp


def test_init_mamba_tree_and_deterministic_leaves(mixer):
    (_, _), (tdims, _), jp = mixer
    own = tssm.init_mamba(torch.Generator().manual_seed(0), tdims, device="cpu")
    assert sorted(own) == sorted(jp)
    for name, leaf in own.items():
        assert tuple(leaf.shape) == jp[name].shape and leaf.dtype == torch.float32, name
    for name in ("A_log", "dt_bias"):
        np.testing.assert_allclose(own[name].numpy(), jp[name], rtol=1e-6, atol=1e-7)
    for name in ("D", "norm"):
        np.testing.assert_array_equal(own[name].numpy(), jp[name])


def test_causal_conv_with_state_equals_jax():
    rng = np.random.default_rng(4)
    seq = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    st = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for state in (None, st):
        jout, jst = jssm._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                                      state=None if state is None else jnp.asarray(state))
        tout, tst = tssm._causal_conv(torch.from_numpy(seq), torch.from_numpy(w),
                                      state=None if state is None else torch.from_numpy(state))
        _close(tout, jout)
        _close(tst, jst)


def _u(dims, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, dims.cfg.d_model)).astype(np.float32)


def _close_states(t, j):
    _close(t["conv"]["x"], j["conv"]["x"])
    _close(t["conv"]["bc"], j["conv"]["bc"])
    _close(t["ssm"], j["ssm"])


def test_mamba_block_and_carried_states_equal_jax(mixer):
    (jdims, jp), (tdims, tp), _ = mixer
    u = _u(tdims, 2, 16, seed=5)
    jout, jst = jssm.mamba_block(jp, jnp.asarray(u[:, :8]), jdims, chunk=4)
    tout, tst = tssm.mamba_block(tp, torch.from_numpy(u[:, :8]), tdims, chunk=4)
    _close(tout, jout)
    _close_states(tst, jst)
    # the second half from the carried conv and SSM states
    jout2, jst2 = jssm.mamba_block(jp, jnp.asarray(u[:, 8:]), jdims, chunk=4,
                                   conv_state=jst["conv"], ssm_state=jst["ssm"])
    tout2, tst2 = tssm.mamba_block(tp, torch.from_numpy(u[:, 8:]), tdims, chunk=4,
                                   conv_state=tst["conv"], ssm_state=tst["ssm"])
    _close(tout2, jout2)
    _close_states(tst2, jst2)
    # ... which is the whole sequence in one pass
    whole, wst = tssm.mamba_block(tp, torch.from_numpy(u), tdims, chunk=8)
    np.testing.assert_allclose(torch.cat([tout, tout2], 1).numpy(), whole.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tst2["ssm"].numpy(), wst["ssm"].numpy(), rtol=1e-4, atol=1e-4)


def test_mamba_decode_step_equals_jax_and_the_block(mixer):
    (jdims, jp), (tdims, tp), _ = mixer
    u = _u(tdims, 3, 9, seed=6)
    jout, jst = jssm.mamba_block(jp, jnp.asarray(u[:, :8]), jdims, chunk=8)
    tout, tst = tssm.mamba_block(tp, torch.from_numpy(u[:, :8]), tdims, chunk=8)
    jdec, jnew = jssm.mamba_decode_step(jp, jnp.asarray(u[:, 8:]), jdims, jst["conv"],
                                        jst["ssm"])
    before = {k: v.clone() for k, v in tst["conv"].items()}
    tdec, tnew = tssm.mamba_decode_step(tp, torch.from_numpy(u[:, 8:]), tdims, tst["conv"],
                                        tst["ssm"])
    _close(tdec, jdec)
    _close_states(tnew, jnew)
    assert all(torch.equal(before[k], tst["conv"][k]) for k in before)   # inputs unwritten
    # the recurrent step continues the chunked scan: the last output of the
    # block over all 9 positions
    whole, _ = tssm.mamba_block(tp, torch.from_numpy(u), tdims, chunk=9)
    np.testing.assert_allclose(tdec[:, 0].numpy(), whole[:, -1].numpy(), rtol=1e-4, atol=1e-4)


def test_init_mamba_state_equals_jax(mixer):
    (jdims, _), (tdims, _), _ = mixer
    want = jssm.init_mamba_state(jdims, 3, jnp.float32)
    got = tssm.init_mamba_state(tdims, 3, torch.float32, device="cpu")
    for t, j in ((got["conv"]["x"], want["conv"]["x"]), (got["conv"]["bc"], want["conv"]["bc"]),
                 (got["ssm"], want["ssm"])):
        assert tuple(t.shape) == j.shape and not bool(t.any())
    assert got["ssm"].dtype == torch.float32
    stacked = tssm.init_mamba_state(tdims, 3, torch.bfloat16, stack=(5,), device="cpu")
    assert stacked["conv"]["x"].shape == (5,) + tuple(got["conv"]["x"].shape)
    assert stacked["conv"]["x"].dtype == torch.bfloat16 and stacked["ssm"].dtype == torch.float32
