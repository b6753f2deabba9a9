"""The plugin estimator kinds of the PyTorch port (``examples/plugins_torch``)
on the CPU: the checks of ``tests/test_plugins.py`` through the port --
registry, service, planner, accuracy audit, a 2-worker cluster -- with no
edit to the port's service, distributed or obs modules; and the port held
against the JAX package's plugins (``examples/plugins``):

  1. each kind's states, window algebra and tables on the same rounds;
  2. a port service and a JAX service with plugin tenants fed the same
     records: window states bit for bit, every result within 1e-6;
  3. a port cluster and a JAX cluster of plugin tenants: every exported
     bundle byte-identical cycle by cycle;
  4. a fresh interpreter imports ``examples.plugins_torch`` without any
     ``jax`` or ``repro`` module.

The port's plugin kinds are registered by a module fixture and taken out
of the port's registry after this file's tests, so that other test files
see the built-in kinds alone.
"""
from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import examples.plugins as jplugins  # noqa: E402  (the JAX package's kinds)
from repro import estimators as JE  # noqa: E402
from repro import service as jsvc  # noqa: E402
from repro.distributed import coordinator as jcoord  # noqa: E402
from repro.distributed import harness as jharness  # noqa: E402
from repro_torch import estimators as TE  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402
from repro_torch.distributed import coordinator as tcoord  # noqa: E402
from repro_torch.distributed import harness  # noqa: E402
from repro_torch.distributed.transport import OP_EXPORT  # noqa: E402
from repro_torch.estimators import base as tbase  # noqa: E402
from repro_torch.obs import MetricsRegistry, Observability, Tracer  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402
from torch_service_cases import (JCFG, TCFG, assert_result_close, assert_same_state,  # noqa: E402
                                 assert_same_windows, twins)

ROOT = Path(__file__).resolve().parents[1]
PLUGINS = "examples.plugins_torch"
CFG = SJPCConfig(d=5, s=3, ratio=1.0, width=128, depth=2, seed=31)
PLUGIN_KINDS = ("theta_kmv", "ipf")


@pytest.fixture(scope="module", autouse=True)
def plugins():
    """Register the port's plugin kinds for this file's tests, then restore
    the port's registry and forget the plugin modules."""
    saved = dict(tbase._REGISTRY)
    assert TE.load_plugins([PLUGINS]) == [PLUGINS]
    yield importlib.import_module(PLUGINS)
    tbase._REGISTRY.clear()
    tbase._REGISTRY.update(saved)
    for name in [m for m in sys.modules if m == PLUGINS or m.startswith(PLUGINS + ".")]:
        del sys.modules[name]


def _records(n, rng=None, hi=6):
    rng = rng or np.random.default_rng(0)
    return rng.integers(0, hi, size=(n, CFG.d), dtype=np.uint32)


def _service(**cfg_kw):
    reg = MetricsRegistry()
    obs = Observability(metrics=reg, tracer=Tracer(registry=reg))
    svc = EstimationService(ServiceConfig(batch_rows=64, device="cpu", **cfg_kw), obs=obs)
    svc.create_group("g", CFG)
    return svc, obs


# ---------------------------------------------------------------------------
# registry: completeness, idempotency, conflict diagnostics, REPRO_PLUGINS
# ---------------------------------------------------------------------------

class TestPluginRegistry:
    def test_plugin_kinds_fully_registered(self):
        for kind in PLUGIN_KINDS:
            assert kind in TE.available()
            sp = TE.spec(kind)
            assert sp.factory is not None and sp.state_cls is not None
            assert sp.linear is not None and sp.join_capable is not None
            assert sp.stderr_kind == "none"
            assert sp.registrant.startswith(PLUGINS)
        assert TE.spec("ipf").linear and TE.spec("ipf").join_capable
        assert TE.spec("ipf").wire_mode == "merge"
        assert TE.spec("ipf").exact_oracle is not None
        sp = TE.spec("theta_kmv")
        assert not sp.linear and not sp.join_capable
        assert sp.wire_mode == "replace" and sp.exact_oracle is None

    def test_reimport_and_reload_are_idempotent(self, plugins):
        before = {k: TE.spec(k) for k in TE.available()}
        importlib.import_module(PLUGINS)
        importlib.reload(plugins.theta_sketch)
        importlib.reload(plugins.inner_product)
        assert set(TE.available()) == set(before)
        for kind in PLUGIN_KINDS:
            assert TE.spec(kind).state_cls.__name__ == before[kind].state_cls.__name__

    def test_conflicting_reregistration_names_both_parties(self):
        def other_factory(cfg, *, params=None, estimator_cfg=None, opts=None,
                          device=None):                      # pragma: no cover
            raise AssertionError

        with pytest.raises(ValueError) as ei:
            TE.register("theta_kmv", other_factory, linear=True)
        msg = str(ei.value)
        assert "theta_kmv" in msg
        assert f"{PLUGINS}.theta_sketch" in msg               # prior claimant
        assert "test_torch_plugins" in msg                    # new claimant
        assert TE.spec("theta_kmv").factory.__module__ == f"{PLUGINS}.theta_sketch"

    def test_load_plugins_env_roundtrip(self, monkeypatch):
        monkeypatch.setenv("REPRO_PLUGINS", f" {PLUGINS} ,")
        assert TE.load_plugins() == [PLUGINS]       # re-registration: identical, no-op
        assert set(PLUGIN_KINDS) <= set(TE.available())
        monkeypatch.delenv("REPRO_PLUGINS")
        assert TE.load_plugins() == []


# ---------------------------------------------------------------------------
# service: plugin kinds served side by side with the built-in kinds
# ---------------------------------------------------------------------------

class TestPluginService:
    def test_plugins_serve_alongside_builtins(self):
        svc, _ = _service()
        recs = _records(400)
        for kind in TE.available():
            svc.create_stream(kind, "g", estimator=kind)
            svc.ingest(kind, recs)
        snap = svc.snapshot()
        x = np.asarray(exact.exact_pair_counts(recs))
        n = recs.shape[0]
        for kind in PLUGIN_KINDS:
            for s in range(CFG.s, CFG.d + 1):
                r = snap.self_join(kind, s=s)
                truth = float(x[s:].sum() + n)
                assert np.isfinite(r.estimate) and r.estimate >= 0
                assert r.stderr_kind == "none" and r.stderr == 0
                if kind == "ipf":          # an estimator of the paper's g
                    assert r.estimate == pytest.approx(truth, rel=1.0)
        # theta's constant g column is n + the duplicate-pair estimate: at
        # the top threshold (exact duplicates) it is in the ballpark
        r = snap.self_join("theta_kmv", s=CFG.d)
        assert r.estimate == pytest.approx(float(x[CFG.d:].sum() + n), rel=0.5)

    def test_ipf_join_fused_matches_ref(self):
        recs_a, recs_b = _records(300), _records(200, np.random.default_rng(4))
        results = {}
        for fused in (True, False):
            svc, _ = _service(use_fused_query=fused)
            svc.create_stream("a", "g", estimator="ipf")
            svc.create_stream("b", "g", estimator="ipf")
            svc.ingest("a", recs_a)
            svc.ingest("b", recs_b)
            snap = svc.snapshot()
            results[fused] = [snap.join("a", "b", s=s).estimate
                              for s in range(CFG.s, CFG.d + 1)]
        assert results[True] == pytest.approx(results[False], rel=1e-6)
        truth = np.asarray(exact.brute_force_join_counts(recs_a, recs_b))
        assert results[True][0] == pytest.approx(float(truth[CFG.s:].sum()), rel=0.5)

    def test_theta_join_refused_via_spec(self):
        svc, _ = _service()
        svc.create_stream("a", "g", estimator="theta_kmv")
        svc.create_stream("b", "g", estimator="theta_kmv")
        svc.ingest("a", _records(50))
        svc.ingest("b", _records(50))
        with pytest.raises(ValueError, match="join-capable"):
            svc.snapshot().join("a", "b")

    def test_ipf_linear_window_expires_by_subtraction(self):
        svc, _ = _service(window_epochs=2)
        svc.create_stream("a", "g", estimator="ipf")
        rng = np.random.default_rng(9)
        for recs in [_records(60, rng) for _ in range(4)]:
            svc.ingest("a", recs)
            svc.flush()
            svc.advance_epoch()
        mid = svc.registry.stream("a").window.total
        assert int(mid.n) > 0                       # window still live
        for _ in range(3):                          # idle epochs: all expire
            svc.advance_epoch()
        total = svc.registry.stream("a").window.total
        assert int(total.n) == 0
        assert not bool(total.counters.any())


# ---------------------------------------------------------------------------
# observability: kinds without an exact oracle skip with a reason
# ---------------------------------------------------------------------------

class TestPluginAudit:
    def test_no_oracle_kind_skips_with_reason(self):
        svc, obs = _service(audit_rate=1.0, window_epochs=4)
        svc.create_stream("t", "g", estimator="theta_kmv")
        svc.register_continuous(ContinuousQuery("q", "self_join", ("t",)))
        svc.ingest("t", _records(80))
        svc.poll()
        m = obs.metrics
        assert m.counter("accuracy_audit_skipped_total", reason="no_exact_oracle") >= 1.0
        assert m.counter_total("accuracy_audits_total") == 0.0

    def test_oracle_bearing_plugin_is_audited(self):
        svc, obs = _service(audit_rate=1.0, window_epochs=4)
        svc.create_stream("p", "g", estimator="ipf")
        svc.register_continuous(ContinuousQuery("q", "self_join", ("p",)))
        svc.ingest("p", _records(80))
        svc.poll()
        m = obs.metrics
        assert m.counter("accuracy_audits_total", kind="ipf") == 1.0
        assert m.counter("accuracy_audit_skipped_total", reason="no_exact_oracle") == 0.0


# ---------------------------------------------------------------------------
# distributed: plugin tenants through LocalWorker + Coordinator
# ---------------------------------------------------------------------------

def test_plugin_cluster_matches_oracle():
    """A 2-worker cluster whose tenants all run plugin kinds (merge deltas
    for ipf, replace for theta) matches the single-process oracle: ipf bit
    for bit, both kinds within 1e-6 on estimates."""
    spec = harness.make_spec(4, kinds=PLUGIN_KINDS[::-1], d=CFG.d, s=CFG.s, width=CFG.width,
                             depth=CFG.depth, seed=CFG.seed, window_epochs=3, batch_rows=64,
                             device="cpu")
    cycles = 3
    batches = harness.make_batches(spec, cycles=cycles, rows_per_cycle=96, seed=5)
    run = harness.run_cluster(spec, batches, n_workers=2, cycles=cycles, local=True,
                              keep_open=True)
    try:
        assert all(t["deltas"] > 0 for t in run.sync_trace)
        oracle = harness.run_oracle(spec, batches, cycles=cycles)
        agree = harness.compare_to_oracle(run.coordinator, oracle, spec)
        assert agree["linear_exact"]
        assert agree["worst_rel_err"] <= 1e-6
    finally:
        run.coordinator.close()


# ---------------------------------------------------------------------------
# against the JAX package's plugins
# ---------------------------------------------------------------------------

def _estimators(kind, **override):
    """The JAX and the port estimator of ``kind`` for the service cases'
    group config; ``override`` sets fields of the kind's config."""
    jest = JE.make(kind, JCFG)
    if override:
        cls = {"theta_kmv": jplugins.ThetaConfig, "ipf": jplugins.IPFConfig}[kind]
        jest = JE.make(kind, JCFG, estimator_cfg=cls(**{**vars(jest.cfg), **override}))
    tcls = type(TE.make(kind, TCFG, device="cpu").cfg)
    test = TE.make(kind, TCFG, device="cpu", estimator_cfg=tcls(**vars(jest.cfg)))
    return jest, test


def _assert_same_table(a, b):
    for field in ("x", "g", "y", "n", "stderr", "stderr_offline"):
        np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    assert a.stderr_kind == b.stderr_kind


@pytest.mark.parametrize("kind,override", [("theta_kmv", {}), ("theta_kmv", {"capacity": 16}),
                                           ("ipf", {}), ("ipf", {"row_width": 40})])
def test_states_algebra_and_tables_equal_jax(kind, override):
    """Three rounds of four streams (some rows masked, one stream idle in a
    round) through each package's ``ingest_rounds``: the states bit for
    bit, then merge, subtract and the tables (joins for ipf)."""
    jest, test = _estimators(kind, **override)
    rng = np.random.default_rng(13)
    R, S, B = 3, 4, 24
    values = rng.integers(0, 5, size=(R, S, B, JCFG.d), dtype=np.uint32)
    mask = (rng.random((R, S, B)) < 0.8).astype(np.int32)
    mask[1, 2] = 0
    keys = np.zeros((R, S, 2), np.uint32)
    js = JE.stack_states([jest.init(sid=i + 1) for i in range(S)])
    ts = TE.stack_states([test.init(sid=i + 1) for i in range(S)])
    js = jest.ingest_rounds(js, values, mask, jnp.asarray(keys))
    ts = test.ingest_rounds(ts, values, mask, keys)
    assert_same_state(js, ts, "ingest")
    for field, leaf in zip(ts._fields, ts):     # the JAX package's dtypes, uint32 as int64
        want = np.asarray(getattr(js, field)).dtype
        assert leaf.dtype == (torch.int64 if want == np.uint32 else torch.int32), field
    _assert_same_table(jest.estimate_batch(js), test.estimate_batch(ts))
    j0, j1 = JE.index_state(js, 0), JE.index_state(js, 1)
    t0, t1 = TE.index_state(ts, 0), TE.index_state(ts, 1)
    jm, tm = jest.merge(j0, j1), test.merge(t0, t1)
    assert_same_state(jm, tm, "merge")
    assert_same_state(jest.subtract(jm, j1), test.subtract(tm, t1), "subtract")
    _assert_same_table(jest.estimate_ref(jm), test.estimate_ref(tm))
    if kind == "ipf":
        _assert_same_table(jest.estimate_join_batch(js, js),
                           test.estimate_join_batch(ts, ts))
        _assert_same_table(jest.estimate_join_ref(j0, j1), test.estimate_join_ref(t0, t1))
    assert test.memory_bytes() == jest.memory_bytes()


PLUGIN_TOPOLOGY = (("i", "g", "ipf", 0), ("j", "g", "ipf", 0), ("t", "g", "theta_kmv", 0),
                   ("t2", "g", "theta_kmv", 1), ("a", "g", "sjpc", 0))
PLUGIN_QUERIES = (("qi", "all_thresholds", ("i",), None), ("qij", "join", ("i", "j"), None),
                  ("qt", "self_join", ("t",), 4), ("qt2", "all_thresholds", ("t2",), None),
                  ("qa", "self_join", ("a",), None))


def test_twin_services_with_plugin_tenants_equal_jax():
    """Both packages' services with plugin tenants beside an SJPC tenant,
    fed the same records over five epochs of a 3-epoch window (so windows
    expire), polled after each flush: windows bit for bit, every standing
    result and every (stream, s) cell within 1e-6."""
    j, t = twins()
    for svc, cfg, qcls in ((j, JCFG, jsvc.ContinuousQuery), (t, TCFG, ContinuousQuery)):
        svc.create_group("g", cfg)
        for name, gid, kind, backing in PLUGIN_TOPOLOGY:
            svc.create_stream(name, gid, estimator=kind, backing_epochs=backing)
        for name, kind, streams, s in PLUGIN_QUERIES:
            svc.register_continuous(qcls(name, kind, streams, s))
    rng = np.random.default_rng(21)
    for _ in range(5):
        batch = {name: rng.integers(0, 4, size=(40, JCFG.d)).astype(np.uint32)
                 for name, *_ in PLUGIN_TOPOLOGY}
        for svc in (j, t):
            for name, rows in batch.items():
                svc.ingest(name, rows)
            svc.flush()
        out_j, out_t = j.poll(), t.poll()
        assert out_j.keys() == out_t.keys()
        for name in out_j:
            assert_result_close(out_j[name], out_t[name])
        assert_same_windows(j, t)
        snap_j, snap_t = j.snapshot(), t.snapshot()
        for name, _, kind, _ in PLUGIN_TOPOLOGY:
            for s in range(JCFG.s, JCFG.d + 1):
                assert_result_close(snap_j.self_join(name, s), snap_t.self_join(name, s))
        for s in range(JCFG.s, JCFG.d + 1):
            assert_result_close(snap_j.join("i", "j", s), snap_t.join("i", "j", s))
        for svc in (j, t):
            svc.advance_epoch()


class _Recording:
    """A worker handle that keeps every export payload it returns."""

    def __init__(self, handle):
        self.handle = handle
        self.exports: list[bytes] = []
        self._op = None

    def send(self, op, body=b""):
        self._op = op
        self.handle.send(op, body)

    def recv(self):
        payload = self.handle.recv()
        if self._op == OP_EXPORT:
            self.exports.append(payload)
        return payload

    def close(self):
        self.handle.close()


def test_plugin_cluster_bundles_byte_identical_to_jax():
    """Same spec, same batches, plugin tenants: the two packages' clusters
    export the same bytes every cycle, and their replicas hold the same
    windows and estimates."""
    kw = dict(kinds=PLUGIN_KINDS, d=CFG.d, s=CFG.s, width=CFG.width, depth=CFG.depth,
              seed=CFG.seed, window_epochs=3, batch_rows=64)
    jspec = jharness.make_spec(6, **kw)
    tspec = harness.make_spec(6, device="cpu", **kw)
    cycles = 4
    batches = jharness.make_batches(jspec, cycles=cycles, rows_per_cycle=96, seed=7)
    jworkers = [_Recording(jcoord.LocalWorker()) for _ in range(2)]
    tworkers = [_Recording(tcoord.LocalWorker()) for _ in range(2)]
    jc = jcoord.Coordinator(jspec, jworkers)
    tc = tcoord.Coordinator(tspec, tworkers)
    try:
        for coord, spec in ((jc, jspec), (tc, tspec)):
            for c in range(cycles):
                for st in spec.streams:
                    coord.ingest(st["name"], batches[st["name"]][c])
                coord.sync()
                coord.advance_epoch()
        for jw, tw in zip(jworkers, tworkers):
            assert len(jw.exports) == len(tw.exports) == cycles
            for cycle, (a, b) in enumerate(zip(jw.exports, tw.exports)):
                assert a and a == b, f"cycle {cycle}: bundles differ"
        jrep, trep = jc.replicas[0], tc.replicas[0]
        for st in tspec.streams:
            name = st["name"]
            assert_same_state(jrep.registry.stream(name).window.window_state(),
                              trep.registry.stream(name).window.window_state(), name)
            ej, et = jc.self_join(name).estimate, tc.self_join(name).estimate
            assert abs(ej - et) <= 1e-6 * max(abs(ej), 1.0), (name, ej, et)
    finally:
        jc.close()
        tc.close()


def test_plugins_import_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import examples.plugins_torch as p\n"
        "from repro_torch import estimators as E\n"
        "assert {'theta_kmv', 'ipf'} <= set(E.available())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
