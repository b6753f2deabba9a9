"""The port's estimator path against the JAX package on the CPU: the same
records, masks and keys through ``ingest_rounds``, ``merge``,
``subtract`` and ``estimate_batch`` of every kind (SJPC, reservoir,
LSH-SS), plus the randomness they replay (ingest keys, bootstrap keys and
resampling, Algorithm R) and the protocol conformance matrix of
``tests/test_estimators.py`` rerun through the port.

States are held bit-exact, leaf by leaf; reservoir and LSH-SS tables
exactly, stderr included; SJPC tables with y exact and x/g/stderr to 1e-6
(the f32 query epilogue, as in ``test_torch_sjpc.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import estimators as JE
from repro.core.sjpc import SJPCConfig as JConfig
from repro.estimators import base as jbase
from repro.estimators import reservoir as jres
from repro.estimators import uncertainty as junc
from repro.service import ingest as jingest
from repro_torch import convert
from repro_torch import estimators as TE
from repro_torch.core.sjpc import SJPCConfig as TConfig
from repro_torch.estimators import base as tbase
from repro_torch.estimators import reservoir as tres
from repro_torch.estimators import uncertainty as tunc
from repro_torch.service import ingest as tingest

KW = dict(d=5, s=3, ratio=1.0, width=128, depth=2, seed=31)
JCFG, TCFG = JConfig(**KW), TConfig(**KW)
KINDS = ("sjpc", "reservoir", "lsh_ss")
# one instance per kind and package: the JAX ingest jit caches stay warm
JESTS = {kind: JE.make(kind, JCFG) for kind in KINDS}
TESTS = {kind: TE.make(kind, TCFG, device="cpu") for kind in KINDS}
R, S, B = 3, 3, 48


def _np(x):
    return np.asarray(x)


def _assert_same_state(jstate, tstate, what=""):
    assert tuple(jstate._fields) == tuple(tstate._fields)
    for field in jstate._fields:
        a, b = _np(getattr(jstate, field)), getattr(tstate, field).numpy()
        assert a.shape == b.shape, (what, field)
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{what} {field}")


def _assert_same_table(jt, tt, kind):
    assert jt.stderr_kind == tt.stderr_kind
    np.testing.assert_array_equal(jt.n, tt.n)
    if kind == "sjpc":
        np.testing.assert_array_equal(jt.y, tt.y)
        for field in ("x", "g", "stderr", "stderr_offline"):
            np.testing.assert_allclose(getattr(tt, field), getattr(jt, field), rtol=1e-6,
                                       atol=1e-6, err_msg=field)
    else:
        for field in ("x", "g", "y", "stderr", "stderr_offline"):
            np.testing.assert_array_equal(getattr(tt, field), getattr(jt, field),
                                          err_msg=f"{kind} {field}")


def _rounds(seed, vocab=4):
    """(R, S, B, d) records, masks with a partial last round and one fully
    masked (stream, round) cell, and the key grid of both packages."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, vocab, size=(R, S, B, KW["d"])).astype(np.uint32)
    for r in range(R):                            # some exact duplicates across rounds
        values[r, :, :6] = values[0, :, :6]
    mask = np.ones((R, S, B), np.int32)
    mask[-1, :, 30:] = 0
    mask[1, 2, :] = 0
    uids = np.arange(S, dtype=np.int32) + 5
    ridx = np.broadcast_to(np.arange(R, dtype=np.int32)[:, None], (R, S))
    seed_ = JESTS["sjpc"].ingest_seed
    jkeys = jingest.ingest_key_grid(seed_, jnp.asarray(uids), jnp.asarray(ridx))
    tkeys = tingest.ingest_key_grid(seed_, uids, ridx)
    return values, mask, jkeys, tkeys


def _ingest_both(kind, seed, sid=1, rounds=slice(None)):
    values, mask, jkeys, tkeys = _rounds(seed)
    je, te = JESTS[kind], TESTS[kind]
    js = JE.stack_states([je.init(sid=sid) for _ in range(S)])
    ts = TE.stack_states([te.init(sid=sid) for _ in range(S)])
    js = je.ingest_rounds(js, values[rounds], mask[rounds], jkeys[rounds])
    ts = te.ingest_rounds(ts, values[rounds], mask[rounds], tkeys[rounds])
    return js, ts


# ---------------------------------------------------------------------------
# keys and the randomness the estimators replay
# ---------------------------------------------------------------------------

def test_ingest_keys_equal_jax():
    _, _, jkeys, tkeys = _rounds(0)
    np.testing.assert_array_equal(tkeys.numpy(), _np(jkeys))
    for uid, ridx in ((0, 0), (7, 3), (2**31 - 1, 9)):
        np.testing.assert_array_equal(tingest.ingest_key(TCFG, uid, ridx).numpy(),
                                      _np(jingest.ingest_key(JCFG, uid, ridx)))


@pytest.mark.parametrize("n0,capacity", [(0, 16), (10, 16), (1000, 16), (5, 40)])
def test_reservoir_accept_equals_jax(n0, capacity):
    rng = np.random.default_rng(n0 + capacity)
    keys = jax.random.split(jax.random.PRNGKey(n0), 3)
    masks = (rng.random((3, 30)) < 0.7).astype(np.int32)
    n = np.array([n0, n0 + 3, 0], np.int32)
    win, src, n_new = tres.reservoir_accept(torch.from_numpy(_np(keys).astype(np.int64)),
                                            torch.from_numpy(n), torch.from_numpy(masks),
                                            capacity)
    for i in range(3):
        jw, js, jn = jres.reservoir_accept(keys[i], jnp.int32(n[i]), jnp.asarray(masks[i]),
                                           capacity)
        np.testing.assert_array_equal(win[i].numpy(), _np(jw))
        np.testing.assert_array_equal(src[i].numpy()[_np(jw)], _np(js)[_np(jw)])
        assert int(n_new[i]) == int(jn)


def test_bootstrap_keys_and_resampling_equal_jax():
    n = np.array([0, 1, 50, 2**20 + 3], np.int32)
    step = np.array([0, 3, 1, 16], np.int32)
    jkeys = junc.bootstrap_key(31, n, step)
    tkeys = tunc.bootstrap_key(31, torch.from_numpy(n), torch.from_numpy(step))
    np.testing.assert_array_equal(tkeys.numpy(), _np(jkeys))
    valid = (np.random.default_rng(1).random((4, 70)) < 0.6).astype(np.int32)
    valid[0] = 0
    valid[1, :] = 0
    valid[1, 5] = 1
    for cap in (16, 256):
        jidx, jrv, jb = junc.resample_valid_slots(jkeys, valid, 8, cap)
        tidx, trv, tb = tunc.resample_valid_slots(tkeys, torch.from_numpy(valid), 8, cap)
        np.testing.assert_array_equal(tidx.numpy(), _np(jidx))
        np.testing.assert_array_equal(trv.numpy(), _np(jrv))
        np.testing.assert_array_equal(tb.numpy(), _np(jb))


# ---------------------------------------------------------------------------
# every kind against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_rounds_states_are_bit_exact(kind, seed):
    js, ts = _ingest_both(kind, seed)
    _assert_same_state(js, ts, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_and_subtract_are_bit_exact(kind):
    """The window algebra on two epochs: A = rounds [0, 2) with sid 1,
    B = round 2 from scratch with sid 2, per stream and stacked."""
    je, te = JESTS[kind], TESTS[kind]
    ja, ta = _ingest_both(kind, 3, sid=1, rounds=slice(0, 2))
    jb, tb = _ingest_both(kind, 3, sid=2, rounds=slice(2, 3))
    merged = []
    for i in range(S):
        a_j, b_j = JE.index_state(ja, i), JE.index_state(jb, i)
        a_t, b_t = TE.index_state(ta, i), TE.index_state(tb, i)
        m_j, m_t = je.merge(a_j, b_j), te.merge(a_t, b_t)
        _assert_same_state(m_j, m_t, f"{kind} merge {i}")
        _assert_same_state(je.merge(b_j, a_j), te.merge(b_t, a_t), f"{kind} merge' {i}")
        _assert_same_state(je.subtract(m_j, b_j), te.subtract(m_t, b_t), f"{kind} sub {i}")
        merged.append(m_t)
    # the stacked algebra equals the per-stream one
    stacked = te.merge(ta, tb)
    for i in range(S):
        for x, y in zip(TE.index_state(stacked, i), merged[i]):
            assert torch.equal(x, y)
    back = te.subtract(stacked, tb)
    for i in range(S):
        for x, y in zip(TE.index_state(back, i), te.subtract(merged[i], TE.index_state(tb, i))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["reservoir", "lsh_ss"])
def test_backing_merge_is_bit_exact(kind):
    je, te = JESTS[kind], TESTS[kind]
    ja, ta = _ingest_both(kind, 4, sid=1)
    jb, tb = _ingest_both(kind, 5, sid=2)
    a_j, b_j, a_t, b_t = (JE.index_state(ja, 0), JE.index_state(jb, 1), TE.index_state(ta, 0),
                          TE.index_state(tb, 1))
    _assert_same_state(je.merge(a_j, b_j, backing=2), te.merge(a_t, b_t, backing=2), kind)


def test_priority_merge_keys_are_close_and_select_alike():
    rng = np.random.default_rng(8)
    items = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint64).astype(np.uint32)
    tags = rng.integers(-1, 3, size=300).astype(np.int32)
    jk = _np(jbase.priority_merge_keys(jnp.asarray(items), jnp.asarray(tags),
                                       jnp.float32(37.0), 0x7E5E4B01))
    tk = tbase.priority_merge_keys(torch.from_numpy(items.astype(np.int64)),
                                   torch.from_numpy(tags), 37.0, 0x7E5E4B01).numpy()
    np.testing.assert_array_equal(np.isinf(tk), np.isinf(jk))
    live = ~np.isinf(jk)
    np.testing.assert_allclose(tk[live], jk[live], rtol=1e-6)
    np.testing.assert_array_equal(np.argsort(-tk, kind="stable"), np.argsort(-jk, kind="stable"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_batch_tables_equal_jax(kind, seed):
    js, ts = _ingest_both(kind, seed)
    _assert_same_table(JESTS[kind].estimate_batch(js), TESTS[kind].estimate_batch(ts), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_estimate_ref_equals_jax(kind):
    js, ts = _ingest_both(kind, 6)
    for i in range(S):
        _assert_same_table(JESTS[kind].estimate_ref(JE.index_state(js, i)),
                           TESTS[kind].estimate_ref(TE.index_state(ts, i)), kind)


def test_reservoir_bootstrap_off_and_capacity_one():
    est = TE.make("reservoir", TCFG, device="cpu", opts={"bootstrap_replicates": 0})
    jest = JE.make("reservoir", JCFG, opts={"bootstrap_replicates": 0})
    js, ts = _ingest_both("reservoir", 2)
    _assert_same_table(jest.estimate_batch(js), est.estimate_batch(ts), "reservoir")
    with pytest.raises(ValueError):
        TE.make("reservoir", TCFG, device="cpu", opts={"bootstrap_replicates": 1})
    tiny = TE.ReservoirEstimator(TE.ReservoirConfig(d=5, s=3, capacity=1), device="cpu")
    assert tiny.bootstrap == 0


def test_sjpc_unfused_and_sharded_ingest_equal_jax():
    values, mask, jkeys, tkeys = _rounds(9)
    je, te = JESTS["sjpc"], TESTS["sjpc"]
    fused = te.ingest_rounds(TE.stack_states([te.init()] * S), values, mask, tkeys)
    unfused = TE.make("sjpc", TCFG, device="cpu", opts={"use_fused": False})
    got = unfused.ingest_rounds(TE.stack_states([te.init()] * S), values, mask, tkeys)
    for x, y in zip(got, fused):
        assert torch.equal(x, y)
    for shards in (2, 4):
        jest = JE.make("sjpc", JCFG, opts={"shards": shards})
        test = TE.make("sjpc", TCFG, device="cpu", opts={"shards": shards})
        js = jest.ingest_rounds(JE.stack_states([je.init()] * S), values, mask, jkeys)
        ts = test.ingest_rounds(TE.stack_states([te.init()] * S), values, mask, tkeys)
        _assert_same_state(js, ts, f"shards={shards}")


def test_sjpc_join_batch_equals_jax():
    js, ts = _ingest_both("sjpc", 10)
    order = [1, 2, 0]
    jb = JE.stack_states([JE.index_state(js, i) for i in order])
    tb = TE.stack_states([TE.index_state(ts, i) for i in order])
    _assert_same_table(JESTS["sjpc"].estimate_join_batch(js, jb),
                       TESTS["sjpc"].estimate_join_batch(ts, tb), "sjpc")
    _assert_same_table(JESTS["sjpc"].estimate_join_ref(JE.index_state(js, 0),
                                                       JE.index_state(jb, 0)),
                       TESTS["sjpc"].estimate_join_ref(TE.index_state(ts, 0),
                                                       TE.index_state(tb, 0)), "sjpc")


# ---------------------------------------------------------------------------
# registry, conversion, equal space
# ---------------------------------------------------------------------------

def test_registry_and_equal_space():
    # the JAX registry may also hold plugin kinds other test files load
    assert TE.available() == sorted(KINDS) and set(KINDS) <= set(JE.available())
    for kind in KINDS:
        assert TESTS[kind].memory_bytes() == JESTS[kind].memory_bytes() <= TCFG.counters_bytes
        assert TE.spec(kind).linear == (kind == "sjpc")
    assert TE.capacity_for_bytes(TCFG) == JE.capacity_for_bytes(JCFG)
    assert TE.derive_config(TCFG) == TE.LSHSSConfig(**vars(JE.derive_config(JCFG)))
    with pytest.raises(KeyError):
        TE.make("no_such_kind", TCFG, device="cpu")
    with pytest.raises(ValueError, match="conflicting"):
        TE.register("reservoir", lambda *a, **k: None)
    spec = TE.spec("reservoir")
    assert TE.register("reservoir", spec.factory, state_cls=spec.state_cls, linear=False,
                       join_capable=False, stderr_kind="bootstrap",
                       exact_oracle=spec.exact_oracle).kind == "reservoir"


def test_pairwise_exact_oracle_equals_jax():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 3, size=(40, 5)).astype(np.uint32)
    b = rng.integers(0, 3, size=(30, 5)).astype(np.uint32)
    for query, records in (("self_join", (a,)), ("join", (a, b))):
        tg = TE.pairwise_exact_oracle(query, records)
        jg = JE.pairwise_exact_oracle(query, records)
        assert [tg(s) for s in range(1, 6)] == [jg(s) for s in range(1, 6)]


@pytest.mark.parametrize("kind", ["reservoir", "lsh_ss"])
def test_convert_sample_states_round_trip(kind):
    js, ts = _ingest_both(kind, 7)
    leaves = [_np(leaf) for leaf in JE.index_state(js, 1)]
    state = convert.sample_state_from_numpy(type(ts), *leaves, device="cpu")
    for x, y in zip(state, TE.index_state(ts, 1)):
        assert torch.equal(x, y)
    back = convert.sample_state_to_numpy(state)
    for x, y in zip(back, leaves):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the protocol conformance matrix of tests/test_estimators.py, through the port
# ---------------------------------------------------------------------------

def _ingest(est, state, vals, key_seed=0):
    vals = np.ascontiguousarray(np.asarray(vals, np.uint32))
    keys = tingest.ingest_key_grid(est.ingest_seed, [key_seed], [[0]])
    new = est.ingest_rounds(TE.stack_states([state]), vals[None, None],
                            np.ones((1, 1, vals.shape[0]), np.int32), keys)
    return TE.index_state(new, 0)


def _dups(rng, n=300, d=5):
    vals = rng.integers(0, 40, size=(n, d)).astype(np.uint32)
    for i in range(n // 10):
        vals[n - 1 - i] = vals[i]
    return vals


@pytest.mark.parametrize("kind", KINDS)
def test_conformance_batch_matches_ref_and_permutation(kind):
    est = TESTS[kind]
    rng = np.random.default_rng(11)
    a = _ingest(est, est.init(sid=1), _dups(rng), key_seed=1)
    b = _ingest(est, est.init(sid=2), rng.integers(0, 9, size=(200, 5)), key_seed=2)
    batch = est.estimate_batch(TE.stack_states([a]))
    ref = est.estimate_ref(a)
    for field in ("x", "g", "n", "stderr"):
        np.testing.assert_allclose(getattr(batch, field), getattr(ref, field), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{kind}.{field}")
    ab = est.estimate_batch(TE.stack_states([a, b]))
    ba = est.estimate_batch(TE.stack_states([b, a]))
    np.testing.assert_allclose(ab.g, ba.g[::-1], rtol=1e-9)
    np.testing.assert_allclose(ab.x, ba.x[::-1], rtol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_conformance_merge_subtract_algebra(kind):
    est = TESTS[kind]
    rng = np.random.default_rng(13)
    a = _ingest(est, est.init(sid=1), _dups(rng), key_seed=1)
    b = _ingest(est, est.init(sid=2), rng.integers(0, 9, size=(160, 5)), key_seed=2)
    m1, m2 = est.merge(a, b), est.merge(b, a)
    assert float(m1.n) == float(m2.n) == float(a.n) + float(b.n)
    np.testing.assert_allclose(est.estimate_ref(m1).g, est.estimate_ref(m2).g, rtol=1e-9)
    back = est.subtract(m1, b)
    assert float(back.n) == pytest.approx(float(a.n))
    if est.linear:
        assert torch.equal(back.counters, a.counters)
    else:
        for field in back._fields:
            if field.endswith("tags"):
                assert not bool((getattr(back, field) == int(b.sid)).any()), (kind, field)
    m = est.estimate_ref(m1)
    assert np.all(np.isfinite(m.g)) and np.all(m.g >= 0) and m.g[0, 0] >= float(m.n[0]) - 1e-6


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1])
def test_conformance_no_pairs_means_g_equals_n(kind, n):
    est = TESTS[kind]
    st = est.init(sid=0)
    if n:
        st = _ingest(est, st, np.ones((1, 5), np.uint32))
    for table in (est.estimate_batch(TE.stack_states([st])), est.estimate_ref(st)):
        assert float(table.n[0]) == float(n)
        assert np.all(np.isfinite(table.g))
        np.testing.assert_allclose(table.g[0], float(n), atol=1e-6, err_msg=f"{kind} n={n}")
        assert np.all(table.stderr >= 0)


def test_metrics_registry_copy_behaves_as_the_jax_package():
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    for reg in regs:
        reg.inc("kernel_dispatch_total", kernel="fused_pairs", impl="x")
        reg.inc("kernel_dispatch_total", 2, kernel="fused_pairs", impl="x")
        reg.set_max("depth", 3, group="g")
        reg.set_max("depth", 1, group="g")
        for v in (1e-4, 3e-3, 0.2, 20.0):
            reg.observe("latency", v, op="q")
        reg.absorb({"other": {'{w="1"}': 4.0}}, worker="2")
    assert regs[0].collect() == regs[1].collect()
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    off = tmetrics.MetricsRegistry(enabled=False)
    off.inc("x")
    assert off.collect() == {}
