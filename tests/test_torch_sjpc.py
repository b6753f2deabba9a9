"""The PyTorch port's SJPC main path against the JAX package, end to end on
the CPU: ingest under the default keys, the batched and scalar queries,
the state algebra, the numpy round trip, and the package boundary."""
import ast
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import sjpc as jsjpc
from repro_torch import convert, platform
from repro_torch.core import sjpc as tsjpc

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 24


def _configs(**kw):
    return jsjpc.SJPCConfig(**kw), tsjpc.SJPCConfig(**kw)


def _rounds(rng, d, n_rounds):
    """Record rounds with a row mask on round 1 and a fully masked round 2."""
    out = []
    for i in range(n_rounds):
        values = rng.integers(0, 4, size=(BATCH, d)).astype(np.uint32)
        mask = None
        if i == 1:
            mask = (rng.random(BATCH) < 0.6).astype(np.int32)
        elif i == 2:
            mask = np.zeros(BATCH, np.int32)
        out.append((values, mask))
    return out


def _ingest_both(depth, d=5, s=2, width=256, n_rounds=4, seed=21):
    jcfg, tcfg = _configs(d=d, s=s, width=width, depth=depth, seed=seed)
    jparams, jstate = jsjpc.init(jcfg)
    tparams, tstate = tsjpc.init(tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    for values, mask in _rounds(rng, d, n_rounds):
        jstate = jsjpc.update_fused(jcfg, jparams, jstate, values, row_mask=mask)
        tstate = tsjpc.update_fused(tcfg, tparams, tstate, values, row_mask=mask)
    return jcfg, tcfg, jstate, tstate


def _assert_same_state(jstate, tstate):
    counters, n, step = convert.state_to_numpy(tstate)
    np.testing.assert_array_equal(counters, np.asarray(jstate.counters))
    assert n == np.float32(jstate.n)
    assert step == np.int32(jstate.step)


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_update_fused_matches_jax_under_default_keys(depth):
    _, _, jstate, tstate = _ingest_both(depth)
    _assert_same_state(jstate, tstate)
    assert int(tstate.step) == 3          # the fully masked round did not count


def test_params_are_the_same_draws():
    jcfg, tcfg = _configs(d=6, s=3, depth=3, seed=99)
    jparams, _ = jsjpc.init(jcfg)
    tparams, tstate = tsjpc.init(tcfg, device="cpu")
    for a, b in zip(tparams, jparams):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tstate.counters.dtype == torch.int32 and tstate.n.dtype == torch.float32


def test_per_level_update_matches_jax_and_fused():
    jcfg, tcfg = _configs(d=5, s=2, width=256, depth=2, seed=5)
    jparams, jstate = jsjpc.init(jcfg)
    tparams, tstate = tsjpc.init(tcfg, device="cpu")
    fstate = tstate
    for values, mask in _rounds(np.random.default_rng(5), 5, 3):
        jstate = jsjpc.update(jcfg, jparams, jstate, values, row_mask=mask)
        tstate = tsjpc.update(tcfg, tparams, tstate, values, row_mask=mask)
        fstate = tsjpc.update_fused(tcfg, tparams, fstate, values, row_mask=mask)
    _assert_same_state(jstate, tstate)
    _assert_same_state(jstate, fstate)


def test_explicit_key():
    import jax
    jcfg, tcfg = _configs(d=5, s=2, width=256, depth=3, seed=8)
    jparams, jstate = jsjpc.init(jcfg)
    tparams, tstate = tsjpc.init(tcfg, device="cpu")
    values = np.random.default_rng(8).integers(0, 3, size=(BATCH, 5)).astype(np.uint32)
    key = jax.random.fold_in(jax.random.PRNGKey(77), 4)
    jstate = jsjpc.update_fused(jcfg, jparams, jstate, values, key)
    tstate = tsjpc.update_fused(tcfg, tparams, tstate, values,
                                torch.from_numpy(np.asarray(key).astype(np.int64)))
    _assert_same_state(jstate, tstate)


def _stack_both(depth):
    """Three streams' sketches under one params draw, plus their n."""
    jcfg, tcfg = _configs(d=5, s=2, width=256, depth=depth, seed=31)
    jparams, _ = jsjpc.init(jcfg)
    tparams, _ = tsjpc.init(tcfg, device="cpu")
    rng = np.random.default_rng(31 + depth)
    jstates, tstates = [], []
    for rows in (BATCH, 15, 0):
        _, js = jsjpc.init(jcfg)
        _, ts = tsjpc.init(tcfg, device="cpu")
        if rows:
            values = rng.integers(0, 3, size=(BATCH, 5)).astype(np.uint32)
            mask = (np.arange(BATCH) < rows).astype(np.int32)
            js = jsjpc.update_fused(jcfg, jparams, js, values, row_mask=mask)
            ts = tsjpc.update_fused(tcfg, tparams, ts, values, row_mask=mask)
        jstates.append(js)
        tstates.append(ts)
    return jcfg, tcfg, jstates, tstates


def _assert_batch_close(got, want):
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.n, want.n)
    for field in ("x", "g", "stderr", "stderr_offline"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("depth,clamp", [(2, True), (3, True), (3, False)])
def test_estimate_batch_and_join_batch(depth, clamp):
    jcfg, tcfg, jstates, tstates = _stack_both(depth)
    jc = jnp.stack([s.counters for s in jstates])
    tc = torch.stack([s.counters for s in tstates])
    n = np.array([float(s.n) for s in jstates], np.float32)
    _assert_batch_close(tsjpc.estimate_batch(tcfg, tc, n, clamp=clamp),
                        jsjpc.estimate_batch(jcfg, jc, n, clamp=clamp))
    order = [1, 2, 0]
    _assert_batch_close(
        tsjpc.estimate_join_batch(tcfg, tc, tc[order], n, n[order], clamp=clamp),
        jsjpc.estimate_join_batch(jcfg, jc, jc[np.array(order)], n, n[order], clamp=clamp))


def _torch_f32_estimate(cfg, moments, n, *, clamp, join):
    """The estimate's float32 formulation as torch ops (what ran on the
    card before the host path): the oracle of the host version."""
    d, s, r = cfg.d, cfg.s, cfg.ratio

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=moments.device)

    y = tsjpc.median_depth(moments)
    X = {}
    for k in range(d, s - 1, -1):
        if join:
            acc = y[:, k - s] / f32(r * r)
        else:
            acc = y[:, k - s] - f32(math.comb(d, k) * r) * n
        for j in range(k + 1, d + 1):
            acc = acc - f32(math.comb(j, k)) * X[j]
        if clamp:
            acc = torch.clamp_min(acc, 0.0)
        X[k] = acc
    x = torch.stack([X[k] for k in range(s, d + 1)], dim=1)
    if not join:
        x = x / f32(r * r)
    g = torch.flip(torch.cumsum(torch.flip(x, [1]), dim=1), [1])
    if not join:
        g = g + n[:, None]
    return y, x, g


def _moments(kind, rng, cfg, join):
    """(N, L, t) float32 moments and (N,) n: sketch-sized values, values the
    recursion drives below zero, or values that hit zero exactly."""
    L, t = cfg.num_levels, cfg.depth
    if kind == "sketch":
        m = rng.integers(0, 2**31, size=(6, L, t)).astype(np.float32)
        if join:
            m *= rng.choice([-1.0, 1.0], size=m.shape).astype(np.float32)
        n = rng.integers(1, 2**24, size=6).astype(np.float32)
    elif kind == "negative":
        m = rng.integers(-40, 40, size=(6, L, t)).astype(np.float32)
        n = rng.integers(1000, 5000, size=6).astype(np.float32)
    else:
        n = np.array([0, 0, 8, 12, 100, 3], np.float32)
        # the top level's moments at r * C(d, d) * n: X_d is exactly zero
        m = np.broadcast_to((cfg.ratio * n)[:, None, None], (6, L, t)).astype(np.float32)
        m[0] = 0.0
        m[1] = -0.0
        m[5, :, 0] = -0.0
    return m, n


@pytest.mark.parametrize("kind", ["sketch", "negative", "zero"])
@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("join", [False, True])
@pytest.mark.parametrize("d,s,depth,ratio", [(6, 3, 3, 0.5), (5, 3, 3, 0.3), (6, 3, 2, 0.5)])
def test_host_estimate_equals_the_torch_float32_formulation(d, s, depth, ratio, join, clamp,
                                                          kind):
    """``estimate_from_moments`` on the host equals the float32 torch ops
    bit for bit (signed zeros included), from numpy arrays and tensors."""
    cfg = tsjpc.SJPCConfig(d=d, s=s, ratio=ratio, depth=depth)
    m, n = _moments(kind, np.random.default_rng(d * 100 + depth), cfg, join)
    want = _torch_f32_estimate(cfg, torch.from_numpy(m.copy()), torch.from_numpy(n.copy()),
                               clamp=clamp, join=join)
    for args in ((m, n), (torch.from_numpy(m.copy()), torch.from_numpy(n.copy()))):
        got = tsjpc.estimate_from_moments(cfg, *args, clamp=clamp, join=join)
        for name, a, b in zip("yxg", got, want):
            assert a.dtype == np.float32 and a.shape == tuple(b.shape), name
            np.testing.assert_array_equal(a.view(np.uint32), b.numpy().view(np.uint32),
                                          err_msg=name)


def test_scalar_estimates_and_algebra():
    jcfg, tcfg, jstates, tstates = _stack_both(3)
    for js, ts in zip(jstates, tstates):
        a, b = tsjpc.estimate(tcfg, ts), jsjpc.estimate(jcfg, js)
        for field in ("x", "y"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert (a.g_s, a.n, a.pairs) == (b.g_s, b.n, b.pairs)
    a = tsjpc.estimate_join(tcfg, tstates[0], tstates[1])
    b = jsjpc.estimate_join(jcfg, jstates[0], jstates[1])
    np.testing.assert_array_equal(a.x, b.x)
    assert a.g_s == b.g_s
    _assert_same_state(jsjpc.merge(jstates[0], jstates[1]),
                       tsjpc.merge(tstates[0], tstates[1]))
    _assert_same_state(jsjpc.subtract(jstates[0], jstates[1]),
                       tsjpc.subtract(tstates[0], tstates[1]))
    assert tsjpc.offline_variance_bound(6, 3, 0.5, 1e4) == \
        jsjpc.offline_variance_bound(6, 3, 0.5, 1e4)
    assert tsjpc.online_variance_bound(6, 3, 0.5, 1024, 5e3, 1e4) == \
        jsjpc.online_variance_bound(6, 3, 0.5, 1024, 5e3, 1e4)


def test_median_averages_the_middle_pair():
    m = torch.tensor([[1.0, 4.0], [3.0, 3.0]])
    np.testing.assert_array_equal(tsjpc.median_depth(m).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(m.numpy()), axis=-1)))
    assert tsjpc.median_depth(torch.tensor([[5.0, 1.0, 3.0]])).item() == 3.0


def test_convert_round_trip():
    _, _, jstate, _ = _ingest_both(2, n_rounds=2)
    jcfg, _ = _configs(d=5, s=2, width=256, depth=2, seed=21)
    jparams, _ = jsjpc.init(jcfg)
    arrays = [np.asarray(a) for a in jparams]
    params = convert.params_from_numpy(*arrays, device="cpu")
    for a, b in zip(params, arrays):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b)
    state = convert.state_from_numpy(np.asarray(jstate.counters), np.asarray(jstate.n),
                                     np.asarray(jstate.step), device="cpu")
    _assert_same_state(jstate, state)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        platform.default_device()
    with pytest.raises(RuntimeError):
        tsjpc.init(tsjpc.SJPCConfig(d=3, s=2))
    assert platform.resolve("cpu") == torch.device("cpu")


def test_helpers_follow_their_input_or_go_to_the_card(monkeypatch):
    """A helper without a tensor input defaults to the card and raises
    without one; a helper with a key draws on the key's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import prng, projections, sketch
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch.empty_counters(3, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch.make_sketch_params(np.random.default_rng(0), 3)
    assert sketch.empty_counters(3, 64, device="cpu").device == torch.device("cpu")
    key = prng.PRNGKey(3)
    keys = prng.split(key, 4)
    for draw in (prng.random_bits(key, (5,)), prng.uniform(keys, (2,)),
                 prng.randint(keys, (2,), 0, 7),
                 projections.sample_combo_weights(key, 4, 6, 0.5)):
        assert draw.device == key.device == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(path.relative_to(ROOT / "src" / "repro_torch")) for path in files[:-1]}
    assert {"kernels/registry.py", "kernels/fused_pairs.py", "kernels/sketch_update.py",
            "kernels/sketch_moments.py", "obs/metrics.py", "service/ingest.py",
            "estimators/base.py", "estimators/uncertainty.py", "estimators/reservoir.py",
            "estimators/lsh_ss.py", "estimators/sjpc_backend.py", "kernels/flash_attention.py",
            "models/config.py", "models/layers.py", "models/attention.py", "models/blocks.py",
            "models/model.py", "launch/serve.py", "configs/qwen2_5_3b.py",
            "data/recordize.py", "sketchstream/monitor.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"
