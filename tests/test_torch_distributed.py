"""The port's multi-host service (``repro_torch.distributed``) on the CPU:
the checks of ``tests/test_distributed.py`` run through the port, and the
port held against the JAX package.

Through the port: a local 2-worker cluster against the single-process
oracle (bit-exact replica state, every estimate within 1e-6), uid
pinning, the zero-byte idle heartbeat, a lost worker serving stale,
``export_delta`` increments and rotation, and worker metrics absorbed
under a ``worker`` label.  The subprocess smoke run is in the slow lane,
as the reference's is.

Against the JAX package:
  1. a port cluster and a JAX cluster on the same spec and batches: every
     exported bundle byte-identical cycle by cycle, the replica windows
     equal bit for bit, every estimate within 1e-6;
  2. a mixed cluster: the JAX ``Coordinator`` drives one JAX worker and
     one port worker and matches the JAX oracle;
  3. a fresh interpreter imports ``repro_torch.distributed`` without any
     ``jax`` or ``repro`` module.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import coordinator as jcoord  # noqa: E402
from repro.distributed import harness as jharness  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402
from repro_torch.distributed import coordinator as tcoord  # noqa: E402
from repro_torch.distributed import harness, shard_of, wire  # noqa: E402
from repro_torch.distributed.transport import OP_EXPORT  # noqa: E402
from repro_torch.distributed.worker import service_kwargs  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = SJPCConfig(d=5, s=3, ratio=0.5, width=128, depth=2, seed=9)
GEOM = dict(d=CFG.d, s=CFG.s, width=CFG.width, depth=CFG.depth, seed=CFG.seed,
            window_epochs=3, batch_rows=64)
# the cross-package cluster: every kind, a backing-epoch sample window
XKW = dict(GEOM, kinds=("sjpc", "reservoir", "lsh_ss"), backing_epochs=2)
XTENANTS, XCYCLES, XROWS = 6, 3, 96


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mini_spec(**kw):
    kw.setdefault("kinds", ("sjpc", "reservoir"))
    return harness.make_spec(4, device="cpu", **GEOM, **kw)


def _run_pair(spec, cycles=3, rows=96, seed=5):
    batches = harness.make_batches(spec, cycles=cycles, rows_per_cycle=rows, seed=seed)
    run = harness.run_cluster(spec, batches, n_workers=2, cycles=cycles,
                              local=True, keep_open=True)
    oracle = harness.run_oracle(spec, batches, cycles=cycles)
    return run, oracle


def _service(**kw):
    svc = EstimationService(ServiceConfig(batch_rows=64, device="cpu", **kw),
                            obs=Observability.disabled())
    svc.create_group("g", CFG)
    return svc


def _recs(rng, rows=64):
    return rng.integers(0, 60, size=(rows, CFG.d), dtype=np.uint32)


# ---------------------------------------------------------------------------
# the checks of tests/test_distributed.py, through the port
# ---------------------------------------------------------------------------

class TestClusterVsOracle:
    def test_local_two_worker_cluster_matches_oracle(self):
        spec = _mini_spec()
        run, oracle = _run_pair(spec)
        try:
            agree = harness.compare_to_oracle(run.coordinator, oracle, spec)
            assert agree["linear_exact"]
            assert agree["worst_rel_err"] <= 1e-6
        finally:
            run.coordinator.close()

    def test_every_cycle_merged_deltas(self):
        spec = _mini_spec()
        run, _ = _run_pair(spec, cycles=2)
        try:
            assert all(t["deltas"] > 0 for t in run.sync_trace)
            m = run.coordinator.obs.metrics
            assert m.counter_total("coordinator_merges_total") > 0
            h = m._hists.get("coordinator_merge_seconds", {})
            assert sum(x.count for x in h.values()) == 2 * sum(
                1 for t in run.sync_trace if t["deltas"])
        finally:
            run.coordinator.close()


class TestUidPinning:
    def test_pinned_shard_matches_dense_registration(self):
        """A service registering ONLY stream b at its global uid sketches b
        bit-identically to one registering a then b densely."""
        recs = np.random.default_rng(3).integers(0, 60, size=(128, CFG.d), dtype=np.uint32)

        def build(streams):
            svc = _service(window_epochs=3)
            for name, uid in streams:
                svc.create_stream(name, "g", uid=uid)
            return svc

        dense = build([("a", None), ("b", None)])
        shard = build([("b", 1)])
        for svc in (dense, shard):
            svc.ingest("b", recs)
            svc.flush()
        tb_dense = dense.registry.stream("b").window.total
        tb_shard = shard.registry.stream("b").window.total
        assert torch.equal(tb_dense.counters, tb_shard.counters)
        assert torch.equal(tb_dense.n, tb_shard.n)

    def test_duplicate_pinned_uid_rejected(self):
        svc = _service()
        svc.create_stream("a", "g", uid=3)
        with pytest.raises(ValueError, match="uid"):
            svc.create_stream("b", "g", uid=3)
        svc.create_stream("c", "g")
        assert svc.registry.stream("c").uid == 4


class TestIdleHeartbeat:
    def test_idle_sync_is_zero_byte_no_version_bump_no_merge(self):
        spec = _mini_spec()
        run, _ = _run_pair(spec, cycles=2)
        coord = run.coordinator
        try:
            m = coord.obs.metrics
            merges_before = m.counter_total("coordinator_merges_total")
            versions = {s["name"]: coord.replicas[0].registry.stream(s["name"]).window.version
                        for s in spec.streams}
            for _, h in coord._alive():
                h.send(OP_EXPORT)
                payload = h.recv()
                assert payload == b""
                assert wire.decode_bundle(payload) is wire.HEARTBEAT
            stats = coord.sync()
            assert stats["deltas"] == 0
            assert stats["heartbeats"] == coord.n_workers
            assert m.counter_total("coordinator_heartbeats_total") >= 2
            assert m.counter_total("coordinator_merges_total") == merges_before
            for s in spec.streams:
                assert coord.replicas[0].registry.stream(
                    s["name"]).window.version == versions[s["name"]]
            for _, h in coord._alive():
                assert h.runtime.service.obs.metrics.counter_total(
                    "worker_heartbeats_total") >= 2
        finally:
            coord.close()


class TestWorkerFailure:
    def test_lost_worker_serves_stale_from_last_merge(self):
        spec = _mini_spec(kinds=("sjpc",))
        batches = harness.make_batches(spec, cycles=2, rows_per_cycle=96)
        run = harness.run_cluster(spec, batches, n_workers=2, cycles=2,
                                  local=True, keep_open=True)
        coord = run.coordinator
        try:
            names = [s["name"] for s in spec.streams]
            dead_w = 0
            dead = [n for n in names if shard_of(n, 2) == dead_w]
            live = [n for n in names if shard_of(n, 2) != dead_w]
            assert dead and live
            before = {n: coord.self_join(n).estimate for n in names}
            coord.workers[dead_w].fail()
            more = _recs(np.random.default_rng(7))
            for n in names:
                coord.ingest(n, more)
            coord.sync()
            assert coord._dead == {dead_w}
            assert set(coord.stale_tenants) == set(dead)
            for n in dead:
                res = coord.self_join(n)
                assert res.stale
                assert res.estimate == before[n]
            for n in live:
                assert not coord.self_join(n).stale
            m = coord.obs.metrics
            assert m.counter("coordinator_worker_failures_total", worker=str(dead_w)) == 1.0
            assert m.counter_total("coordinator_lost_ingest_records_total") == 64.0 * len(dead)
            coord.register_continuous(ContinuousQuery(name="qd", kind="self_join",
                                                      streams=(dead[0],)))
            coord.register_continuous(ContinuousQuery(name="ql", kind="self_join",
                                                      streams=(live[0],)))
            out = coord.poll()
            assert out["qd"].stale and not out["ql"].stale
        finally:
            coord.close()


class TestExportDelta:
    def test_linear_exports_are_per_epoch_increments(self):
        svc = _service(window_epochs=3)
        svc.create_stream("t", "g")
        rng = np.random.default_rng(0)
        w = svc.registry.stream("t").window
        svc.ingest("t", _recs(rng))
        svc.flush()
        mode, d1 = w.export_delta()
        assert mode == "merge"
        assert w.export_delta() is None
        svc.ingest("t", _recs(rng))
        svc.flush()
        mode, d2 = w.export_delta()
        total = w.ingest_base()
        assert torch.equal(d1.counters + d2.counters, total.counters)
        assert float(d1.n + d2.n) == float(total.n)
        assert int(d1.step) == 0 and int(d2.step) == 0

    def test_rotation_rearms_baseline_expiry_not_reshipped(self):
        svc = _service(window_epochs=2)
        svc.create_stream("t", "g")
        rng = np.random.default_rng(1)
        w = svc.registry.stream("t").window
        for _ in range(3):
            svc.ingest("t", _recs(rng))
            svc.flush()
            assert w.export_delta() is not None
            svc.advance_epoch()
            assert w.export_delta() is None

    def test_unbounded_linear_window_stays_incremental(self):
        svc = _service(window_epochs=None)
        svc.create_stream("t", "g", window_epochs=None)
        rng = np.random.default_rng(2)
        w = svc.registry.stream("t").window
        svc.ingest("t", _recs(rng))
        svc.flush()
        _, d1 = w.export_delta()
        svc.advance_epoch()
        assert w.export_delta() is None
        svc.ingest("t", _recs(rng))
        svc.flush()
        _, d2 = w.export_delta()
        assert torch.equal(d1.counters + d2.counters, w.total.counters)

    def test_sample_kind_exports_open_slot_replace(self):
        svc = _service(window_epochs=3)
        svc.create_stream("r", "g", estimator="reservoir")
        w = svc.registry.stream("r").window
        svc.ingest("r", _recs(np.random.default_rng(3)))
        svc.flush()
        mode, state = w.export_delta()
        assert mode == "replace"
        for la, lb in zip(state, w.ingest_base()):
            assert torch.equal(la, lb)
        assert w.export_delta() is None


class TestMetricsAggregation:
    def test_worker_metrics_absorbed_with_worker_label(self):
        spec = _mini_spec(kinds=("sjpc",))
        run, _ = _run_pair(spec, cycles=2)
        coord = run.coordinator
        try:
            per_worker = coord.aggregate_metrics()
            assert set(per_worker) == {0, 1}
            m = coord.obs.metrics
            for w, rep in per_worker.items():
                assert rep["worker"] == w
                assert m.gauge("worker_stats:ingested_records", worker=str(w)) > 0
            report = coord.metrics_report()
            assert 'worker="0"' in report and 'worker="1"' in report
            assert "coordinator_merge_seconds" in report
            v = m.gauge("worker_stats:ingested_records", worker="0")
            coord.aggregate_metrics()
            assert m.gauge("worker_stats:ingested_records", worker="0") == v
        finally:
            coord.close()


def test_service_kwargs_read_the_reference_platform_key():
    assert service_kwargs({"batch_rows": 8, "platform": "cpu"}) == {"batch_rows": 8,
                                                                     "device": "cpu"}
    assert service_kwargs({"platform": "tpu"}) == {"device": None}
    assert service_kwargs({"platform": "gpu", "device": "cpu"}) == {"device": "cpu"}
    assert service_kwargs({"window_epochs": 3}) == {"window_epochs": 3}


def test_scaleout_workload_is_the_paper_group_balanced():
    from repro_torch.configs.sjpc_paper import PAPER_DEFAULTS
    spec = harness.scaleout_spec("cpu")
    assert spec.groups == (("g", PAPER_DEFAULTS),)
    assert spec.service == {"batch_rows": 512, "window_epochs": 4, "device": "cpu"}
    assert "device" not in harness.scaleout_spec().service
    kinds = [st["estimator"] for st in spec.streams]
    assert (kinds.count("sjpc"), kinds.count("reservoir"), kinds.count("lsh_ss")) == (48, 8, 8)
    assert all(st.get("backing_epochs") == 2 for st in spec.streams if st["estimator"] != "sjpc")
    for n in (1, 2, 4):
        shards = [shard_of(st["name"], n) for st in spec.streams]
        assert all(shards.count(i) == 64 // n for i in range(n))
    a = harness.scaleout_records(3, 1)
    assert a.shape == (4096, PAPER_DEFAULTS.d) and a.dtype == np.uint32
    assert np.array_equal(a, harness.scaleout_records(3, 1))
    assert not np.array_equal(a, harness.scaleout_records(3, 2))
    assert not np.array_equal(a, harness.scaleout_records(4, 1))
    batches = harness.scaleout_batches(spec)
    names = [st["name"] for st in spec.streams]
    assert list(batches) == names and all(len(v) == 6 for v in batches.values())
    assert np.array_equal(batches[names[3]][1], a)
    assert sum(b.shape[0] for v in batches.values() for b in v) == 1572864


def test_scaleout_holds_each_run_against_the_oracle():
    spec = _mini_spec()
    batches = harness.make_batches(spec, cycles=2, rows_per_cycle=96, seed=5)
    oracle = harness.run_oracle(spec, batches, cycles=2)
    rows = harness.run_scaleout(spec, batches, oracle, (1, 2), cycles=2)
    assert list(rows) == ["workers_1", "workers_2"]
    for n, row in zip((1, 2), rows.values()):
        assert row["workers"] == n and row["records"] == 4 * 2 * 96
        assert row["linear_exact"] and row["worst_rel_err"] <= 1e-6
        assert len(row["sync_s"]) == 2
    assert rows["workers_1"]["speedup_vs_1w"] == 1.0
    other = harness.make_batches(spec, cycles=2, rows_per_cycle=96, seed=6)
    with pytest.raises(RuntimeError, match="diverged from the oracle"):
        harness.run_scaleout(spec, other, oracle, (1,), cycles=2)


@pytest.mark.slow
class TestSubprocess:
    def test_subprocess_smoke_matches_oracle(self, tmp_path):
        report = harness.run_smoke(str(tmp_path / "smoke.json"), device="cpu")
        assert report["linear_exact"]
        assert report["worst_rel_err"] <= 1e-6
        assert (tmp_path / "smoke.json").exists()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

class Recording:
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


def _drive(coord, spec, batches, cycles):
    for c in range(cycles):
        for st in spec.streams:
            coord.ingest(st["name"], batches[st["name"]][c])
        coord.sync()
        coord.advance_epoch()


def _cross_specs():
    jspec = jharness.make_spec(XTENANTS, **XKW)
    tspec = harness.make_spec(XTENANTS, device="cpu", **XKW)
    assert [s["name"] for s in jspec.streams] == [s["name"] for s in tspec.streams]
    batches = jharness.make_batches(jspec, cycles=XCYCLES, rows_per_cycle=XROWS, seed=5)
    return jspec, tspec, batches


def test_port_cluster_equals_jax_cluster():
    """Same spec, same batches: the two packages' clusters export the same
    bytes every cycle, and their replicas hold the same windows and give
    the same estimates."""
    jspec, tspec, batches = _cross_specs()
    jworkers = [Recording(jcoord.LocalWorker()) for _ in range(2)]
    tworkers = [Recording(tcoord.LocalWorker()) for _ in range(2)]
    jc = jcoord.Coordinator(jspec, jworkers)
    tc = tcoord.Coordinator(tspec, tworkers)
    try:
        _drive(jc, jspec, batches, XCYCLES)
        _drive(tc, tspec, batches, XCYCLES)
        for jw, tw in zip(jworkers, tworkers):
            assert len(jw.exports) == len(tw.exports) == XCYCLES
            for cycle, (a, b) in enumerate(zip(jw.exports, tw.exports)):
                assert a and a == b, f"cycle {cycle}: bundles differ"
        jrep, trep = jc.replicas[0], tc.replicas[0]
        for st in tspec.streams:
            name = st["name"]
            jstate = jrep.registry.stream(name).window.window_state()
            tstate = trep.registry.stream(name).window.window_state()
            assert tuple(jstate._fields) == tuple(tstate._fields)
            for field, a, b in zip(jstate._fields, jstate, tstate):
                np.testing.assert_array_equal(_host(a).astype(np.int64),
                                              _host(b).astype(np.int64),
                                              err_msg=f"{name} {field}")
            ej, et = jc.self_join(name).estimate, tc.self_join(name).estimate
            assert abs(ej - et) <= 1e-6 * max(abs(ej), 1.0), (name, ej, et)
    finally:
        jc.close()
        tc.close()


def test_mixed_cluster_matches_jax_oracle():
    """The JAX coordinator drives a JAX worker and a port worker (which
    reads the JAX spec's ``"platform": "cpu"``); its replicas match the
    JAX package's single-process oracle."""
    jspec, _, batches = _cross_specs()
    port = tcoord.LocalWorker()
    coord = jcoord.Coordinator(jspec, [jcoord.LocalWorker(), port])
    try:
        _drive(coord, jspec, batches, XCYCLES)
        assert port.runtime.service.device.type == "cpu"
        kinds = {s["estimator"] for s in jspec.streams if shard_of(s["name"], 2) == 1}
        assert kinds == {"sjpc", "reservoir", "lsh_ss"}
        oracle = jharness.run_oracle(jspec, batches, cycles=XCYCLES)
        agree = jharness.compare_to_oracle(coord, oracle, jspec)
        assert agree["linear_exact"]
        assert agree["worst_rel_err"] <= 1e-6
    finally:
        coord.close()


def test_distributed_imports_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch.distributed, repro_torch.distributed.harness\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
