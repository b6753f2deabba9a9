"""The port's estimation service against the JAX package's on the CPU: the
same record rounds into both, with every estimator kind, two hash groups
and sample windows with and without the backing-epoch refill.

Every window state is held bit for bit, every (stream, s) result's
floats within 1e-6 (relative and absolute) with its metadata equal.  On
the port alone: the window invariants W1-W3 and the offline replay, the
version stability of idle cohort-mates, snapshot-cache invalidation, the
delta export between two services, the monitor client, and that no state
anyone kept (a snapshot, a shipped baseline) changes after later flushes
and rotations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_service_cases import (  # noqa: E402
    JCFG, QUERIES, ROWS, TCFG, TOPOLOGY, assert_result_close, assert_same_results,
    assert_same_state, assert_same_windows, build_twins, epoch_batches, every_cell, ingest_both,
    records, twins)

from repro.service import ingest as jingest  # noqa: E402
from repro.sketchstream import monitor as jmon  # noqa: E402
from repro import service as jsvc  # noqa: E402
from repro_torch.core import sjpc as tsjpc  # noqa: E402
from repro_torch.service import ingest as tingest  # noqa: E402
from repro_torch.sketchstream import monitor as tmon  # noqa: E402
from repro_torch import service as tsvc  # noqa: E402

NAMES = [name for name, _, _, _ in TOPOLOGY]
EPOCHS = 5
# idle cells: stream "b" skips epoch 1 and "r" epoch 3 (ride-along rounds
# in a busy cohort), "c" skips epoch 2 (its group's only other stream
# keeps flushing)
IDLE = {(1, "b"), (3, "r"), (2, "c")}


@pytest.mark.parametrize("use_fused_query", [True, False])
def test_windows_and_results_equal_jax(use_fused_query):
    """Five epochs over a three-epoch window (every window expires twice):
    after each epoch every window state equals the JAX service's bit for
    bit, and every standing query and every (stream, s) and join cell
    agrees within 1e-6."""
    j, t = build_twins(use_fused_query=use_fused_query)
    for batch in epoch_batches(1, NAMES, EPOCHS, IDLE):
        ingest_both((j, t), batch)
        j.advance_epoch()
        t.advance_epoch()
        assert_same_windows(j, t)
        assert_same_results(j.poll(), t.poll())
    cells_j, cells_t = every_cell(j), every_cell(t)
    assert cells_j.keys() == cells_t.keys()
    for key in cells_j:
        assert_result_close(cells_j[key], cells_t[key])


def test_mid_epoch_flushes_and_sharded_ingest_equal_jax():
    """Two flushes inside an epoch and ``shards=2``: the per-shard key
    folding and the deferred merge give the JAX service's windows."""
    topology = (TOPOLOGY[0], TOPOLOGY[2])
    j, t = build_twins(topology, (QUERIES[0], QUERIES[6]), shards=2)
    names = [name for name, _, _, _ in topology]
    batches = epoch_batches(2, names, 6)
    for first, second in zip(batches[::2], batches[1::2]):
        ingest_both((j, t), first)
        j.flush()
        t.flush()
        ingest_both((j, t), second)
        j.advance_epoch()
        t.advance_epoch()
        assert_same_windows(j, t)
        assert_same_results(j.poll(), t.poll())


def test_auto_flush_and_describe_equal_jax():
    """``auto_flush_rows`` flushes a group once its backlog reaches the
    threshold, before any explicit flush, as the JAX service does; the
    ``describe()`` reports agree."""
    topology = (TOPOLOGY[0], TOPOLOGY[1], TOPOLOGY[5])
    j, t = build_twins(topology, (), auto_flush_rows=2 * ROWS)
    for batch in epoch_batches(10, ["a", "b", "c"], 2):
        ingest_both((j, t), batch)
        for svc in (j, t):
            assert svc._pipelines["g"].pending_rows() == 0         # flushed by the threshold
            assert svc._pipelines["h"].pending_rows() == ROWS
        assert_same_windows(j, t)
        j.advance_epoch()
        t.advance_epoch()
    dj, dt = j.describe(), t.describe()
    assert dj["groups"].keys() == dt["groups"].keys()
    for gid in dj["groups"]:
        assert dj["groups"][gid]["streams"] == dt["groups"][gid]["streams"]
        assert dj["groups"][gid]["ingest"] == dt["groups"][gid]["ingest"]
    assert {k: v for k, v in dj.items() if k not in ("groups", "flush_s")} == \
        {k: v for k, v in dt.items() if k not in ("groups", "flush_s")}


def test_multi_stream_update_equals_jax():
    """One round of S streams, fused and unfused, equals the JAX package's
    ``multi_stream_update``."""
    rng = np.random.default_rng(3)
    S, B = 3, 16
    values = rng.integers(0, 4, size=(S, B, 4)).astype(np.uint32)
    mask = np.ones((S, B), np.int32)
    mask[1, 10:] = 0
    jkeys = jnp.stack([jingest.ingest_key(JCFG, u, 0) for u in range(S)])
    tkeys = torch.stack([tingest.ingest_key(TCFG, u, 0) for u in range(S)])
    from repro.core import sjpc as jsjpc
    jparams, jstate = jsjpc.init(JCFG)
    tparams, tstate = tsjpc.init(TCFG, device="cpu")
    for fused in (True, False):
        jc, jn, js = jingest.multi_stream_update(
            JCFG, jparams, jnp.stack([jstate.counters] * S), jnp.stack([jstate.n] * S),
            jnp.stack([jstate.step] * S), values, mask, jkeys, use_fused=fused)
        tc, tn, ts = tingest.multi_stream_update(
            TCFG, tparams, torch.stack([tstate.counters] * S), torch.stack([tstate.n] * S),
            torch.stack([tstate.step] * S), values, mask, tkeys, use_fused=fused)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unfused_service_counters_equal_fused():
    """``use_fused=False`` (the ``fingerprint`` and ``sketch_update`` ops)
    gives the fused service's counters bit for bit."""
    topology = (("a", "g", "sjpc", 0), ("b", "g", "sjpc", 0), ("c", "h", "sjpc", 0))
    fused = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=32))
    unfused = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=32,
                                                        use_fused=False))
    for svc in (fused, unfused):
        for gid in ("g", "h"):
            svc.create_group(gid, TCFG)
        for name, gid, kind, _ in topology:
            svc.create_stream(name, gid, estimator=kind)
    for batch in epoch_batches(4, ["a", "b", "c"], 3, {(1, "b")}):
        ingest_both((fused, unfused), batch)
        fused.advance_epoch()
        unfused.advance_epoch()
        for name in ("a", "b", "c"):
            assert_same_state(fused.registry.stream(name).window.total,
                              unfused.registry.stream(name).window.total, name)


# ---------------------------------------------------------------------------
# window invariants and offline replay
# ---------------------------------------------------------------------------

def _replay(svc, name, batches, live):
    """Offline rebuild of the live epochs' batches with the pipeline's keys
    (one flush per epoch; each epoch advances the stream's replay
    coordinate by its own rounds)."""
    entry = svc.registry.stream(name)
    group = svc.registry.group(entry.group_id)
    B, cfg = svc.cfg.batch_rows, group.cfg
    _, state = tsjpc.init(cfg, device="cpu")
    rounds = [-(-b[name].shape[0] // B) for b in batches]
    for ep in live:
        rows = batches[ep][name]
        for r in range(rounds[ep]):
            chunk = rows[r * B:(r + 1) * B]
            padded = np.zeros((B, cfg.d), np.uint32)
            padded[:chunk.shape[0]] = chunk
            mask = np.zeros((B,), np.int32)
            mask[:chunk.shape[0]] = 1
            state = tsjpc.update_fused(cfg, group.params, state, padded,
                                       key=tingest.ingest_key(cfg, entry.uid, sum(rounds[:ep]) + r),
                                       row_mask=torch.from_numpy(mask))
    return state


def test_window_invariants_and_offline_replay():
    """W1 at every epoch (total == the ring's sum), W2 at the end (total ==
    a sketch rebuilt from only the live epochs under ``ingest_key``), W3
    (n >= 0, clamped estimates >= 0)."""
    _, t = build_twins()
    batches = epoch_batches(5, NAMES, 6, IDLE)
    for batch in batches:
        ingest_both((t,), batch)
        t.advance_epoch()
        for e in t.registry.streams():
            assert float(e.window.total.n) >= 0
            if e.estimator_kind == "sjpc":
                rs = e.window.ring_sum()
                assert_same_state(e.window.total, rs, e.name)
    for e in t.registry.streams():
        if e.estimator_kind != "sjpc":
            continue
        # window 3: the open (empty) epoch and epochs 4, 5 are live
        want = _replay(t, e.name, batches, [4, 5])
        got = e.window.total
        np.testing.assert_array_equal(got.counters.numpy(), want.counters.numpy())
        assert float(got.n) == float(want.n)
    for (name, *_), r in every_cell(t).items():
        assert r.estimate >= 0.0 and (np.asarray(r.per_level) >= 0.0).all(), name


def test_backing_epochs_refill_widens_the_total():
    """A sample window with backing epochs folds at the expanded capacity
    from its first version on, and keeps more of the live window's records
    than the plain fold (equal to JAX in the conformance test above)."""
    _, t = build_twins()
    for batch in epoch_batches(6, NAMES, 4):
        ingest_both((t,), batch)
        t.advance_epoch()
    r, r0 = (t.registry.stream(n).window for n in ("r", "r0"))
    est = r.estimator
    assert r.total.items.shape[0] == est.refill_capacity(1) > r0.total.items.shape[0]
    assert int((r.total.tags >= 0).sum()) > int((r0.total.tags >= 0).sum())
    assert float(r.total.n) == float(r0.total.n) == 2 * ROWS


# ---------------------------------------------------------------------------
# versions and caches
# ---------------------------------------------------------------------------

def _two_stream_service(estimator="sjpc", window_epochs=None):
    svc = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=16,
                                                    window_epochs=window_epochs))
    svc.create_group("g", TCFG)
    svc.create_stream("busy", "g", estimator=estimator)
    svc.create_stream("idle", "g", estimator=estimator)
    return svc


@pytest.mark.parametrize("estimator", ["sjpc", "reservoir"])
def test_cohort_mate_flush_preserves_idle_version(estimator):
    svc = _two_stream_service(estimator)
    rng = np.random.default_rng(3)
    svc.ingest("busy", records(rng, 40))
    svc.ingest("idle", records(rng, 40))
    svc.flush()
    idle = svc.registry.stream("idle")
    v0, f0, total0 = idle.window.version, idle.flushes, idle.window.total
    r0 = svc.snapshot().self_join("idle")
    cached = len(svc.engine._cache)
    for _ in range(3):
        svc.ingest("busy", records(rng, 40))
        svc.flush()
    assert idle.window.version == v0 and idle.flushes == f0
    assert idle.window.total is total0          # the same object, not an equal one
    assert svc.snapshot().self_join("idle").estimate == r0.estimate
    assert len(svc.engine._cache) <= cached + 3


def test_empty_submission_and_rewrapped_state_keep_the_version():
    svc = _two_stream_service()
    svc.ingest("busy", records(np.random.default_rng(4), 24))
    svc.flush()
    win = svc.registry.stream("busy").window
    v = win.version
    svc.ingest("busy", np.zeros((0, 4), np.uint32))
    svc.flush()
    assert win.version == v
    win.absorb_delta(type(win.total)(*win.total))   # new tuple, same leaves
    assert win.version == v


def test_window_version_tracks_mutations():
    svc = _two_stream_service(window_epochs=2)
    win = svc.registry.stream("busy").window
    v0 = win.version
    svc.ingest("busy", records(np.random.default_rng(0), 8))
    svc.flush()
    assert win.version > v0
    v1 = win.version
    svc.advance_epoch()                            # ring not full: no bump
    assert win.version == v1
    svc.ingest("busy", records(np.random.default_rng(1), 8))
    svc.advance_epoch()
    v2 = win.version
    svc.advance_epoch()                            # expiry subtraction
    assert win.version > v2
    v3 = win.version
    svc.flush()
    assert win.version == v3


@pytest.mark.parametrize("use_fused_query", [True, False])
def test_snapshot_across_expiry_boundary_not_stale(use_fused_query):
    svc = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=16,
                                                    window_epochs=2,
                                                    use_fused_query=use_fused_query))
    svc.create_group("g", TCFG)
    svc.create_stream("a", "g")
    rng = np.random.default_rng(5)
    svc.ingest("a", records(rng, 24))
    svc.advance_epoch()
    before = svc.snapshot().self_join("a")
    for _ in range(2):
        svc.ingest("a", records(rng, 24))
        svc.advance_epoch()
    after = svc.snapshot().self_join("a")
    fresh = tsvc.QueryEngine(svc.registry, use_fused_query=use_fused_query) \
        .snapshot().self_join("a")
    assert after.estimate == fresh.estimate
    np.testing.assert_array_equal(after.per_level, fresh.per_level)
    assert before.n != after.n or before.estimate != after.estimate
    # an unchanged window is a pure lookup
    entries = len(svc.engine._cache)
    assert svc.snapshot().self_join("a").estimate == after.estimate
    assert len(svc.engine._cache) == entries


# ---------------------------------------------------------------------------
# nothing kept is written in place
# ---------------------------------------------------------------------------

def _clone(state):
    return type(state)(*(leaf.clone() for leaf in state))


def test_kept_states_unchanged_after_later_flushes_and_rotations():
    """A snapshot's views, a shipped export baseline, a committed row of a
    stacked flush output and a sample window's slot read back unchanged
    after later flushes, exports and expiring rotations."""
    _, t = build_twins(window_epochs=2)
    rng = np.random.default_rng(8)
    for name in NAMES:
        t.ingest(name, records(rng, ROWS))
    t.flush()
    t.export_deltas()                             # ships a baseline per stream
    t.ingest("a", records(rng, ROWS))
    t.export_deltas()
    snap = t.snapshot()
    kept = {name: (v.state, _clone(v.state)) for name, v in snap._views.items()}
    base = t.registry.stream("a").window._shipped_base
    base_copy = _clone(base)
    slot = t.registry.stream("r").window.ingest_base()
    slot_copy = _clone(slot)
    before = {name: r for name, r in t.poll().items()}
    for _ in range(3):                            # expiring rotations
        for name in NAMES:
            t.ingest(name, records(rng, ROWS))
        t.flush()
        t.ingest("a", records(rng, ROWS))
        t.export_deltas()
        t.advance_epoch()
    for name, (state, copy) in kept.items():
        assert_same_state(copy, state, f"snapshot view {name}")
    assert_same_state(base_copy, base, "shipped baseline")
    assert_same_state(slot_copy, slot, "sample slot")
    for name in before:                           # the old snapshot still answers as before
        q = t._continuous[name]
        assert_result_close(before[name], q.evaluate(snap), tol=0.0)


# ---------------------------------------------------------------------------
# delta export and the monitor client
# ---------------------------------------------------------------------------

def test_export_deltas_equal_jax_and_replicate():
    """Each epoch's exported deltas equal the JAX service's; applied to a
    second port service they rebuild every window: counters, n and sample
    states bit for bit (an SJPC receiver's step stays 0)."""
    j, t = build_twins(queries=())
    replica = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=32,
                                                        window_epochs=3))
    for gid in ("g", "h"):
        replica.create_group(gid, TCFG)
    for name, gid, kind, backing in TOPOLOGY:
        replica.create_stream(name, gid, estimator=kind, backing_epochs=backing)
    for batch in epoch_batches(7, NAMES, 5, IDLE):
        ingest_both((j, t), batch)
        dj, dt = j.export_deltas(), t.export_deltas()
        assert [d[:5] for d in dj] == [d[:5] for d in dt]
        for (_, _, _, _, _, js), (name, _, _, _, mode, ts) in zip(dj, dt):
            assert_same_state(js, ts, name)
            replica.apply_remote_delta(name, mode, ts)
        assert j.export_deltas() == [] and t.export_deltas() == []
        for svc in (j, t, replica):
            svc.advance_epoch()
        for e in t.registry.streams():
            got = replica.registry.stream(e.name).window.total
            if e.estimator_kind == "sjpc":
                assert_same_state(e.window.total._replace(step=got.step), got, e.name)
                assert int(got.step) == 0
            else:
                assert_same_state(e.window.total, got, e.name)


def _monitor_progress(pkg, cfg, params, state, tokens):
    if pkg is jmon:
        c, n = pkg.monitor_update_local(cfg, params, state.counters[0], state.n[0],
                                        jnp.asarray(tokens), state.step)
        return jmon.MonitorState(c[None], n[None], state.step + 1)
    c, n = pkg.monitor_update_local(cfg, params, state.counters[0], state.n[0],
                                    torch.from_numpy(tokens), state.step)
    return tmon.MonitorState(c[None], n[None], state.step + 1)


def test_monitor_client_publish_equals_jax():
    """Each publish ingests the monitor's progress as one epoch: the
    windows and the windowed all-thresholds queries equal the JAX
    client's."""
    kw = dict(d=4, s=3, ratio=1.0, width=64, depth=2, shards=1)
    jcfg, tcfg = jmon.SketchMonitorConfig(**kw), tmon.SketchMonitorConfig(**kw)
    jservice, tservice = twins(window_epochs=2)
    jclient = jsvc.MonitorServiceClient(jservice, "train", jcfg)
    tclient = tsvc.MonitorServiceClient(tservice, "train", tcfg)
    jparams, jstate = jmon.init_monitor(jcfg)
    tparams, tstate = tmon.init_monitor(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    for step in range(4):
        tokens = rng.integers(0, 40, size=(6, 16)).astype(np.int32)
        jstate = _monitor_progress(jmon, jcfg, jparams, jstate, tokens)
        tstate = _monitor_progress(tmon, tcfg, tparams, tstate, tokens)
        jclient.publish(jstate)
        tclient.publish(tstate)
        assert_same_windows(jservice, tservice)
        assert_result_close(jclient.query(), tclient.query())
        assert jclient.log_entry(step).keys() == tclient.log_entry(step).keys()
