"""Shared cases of the service conformance tests (``test_torch_service.py``,
``test_torch_planner.py``, ``test_torch_obs.py``): twin services of both
packages on the CPU over one topology and the same records, and the
comparisons that hold them together.

The shapes are shared across the files, so the JAX side compiles each
ingest and query shape once per worker: one config (d=4, s=2, w=64, t=2),
``batch_rows`` 32, and per epoch 40 records per busy stream (two rounds,
the second padded).
"""
import numpy as np
import pytest

from repro.core.sjpc import SJPCConfig as JConfig
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Observability as JObs
from repro.obs import Tracer as JTracer
from repro import service as jsvc
from repro_torch.core.sjpc import SJPCConfig as TConfig
from repro_torch.obs import MetricsRegistry as TRegistry
from repro_torch.obs import Observability as TObs
from repro_torch.obs import Tracer as TTracer
from repro_torch import service as tsvc

KW = dict(d=4, s=2, ratio=0.5, width=64, depth=2, seed=19)
JCFG, TCFG = JConfig(**KW), TConfig(**KW)
BATCH_ROWS = 32
ROWS = 40
TOL = 1e-6

# (stream, group, kind, backing_epochs): every kind, two hash groups of one
# config (so the planner fuses across them), sample kinds with and
# without the backing-epoch refill
TOPOLOGY = (("a", "g", "sjpc", 0), ("b", "g", "sjpc", 0),
            ("r", "g", "reservoir", 1), ("r0", "g", "reservoir", 0),
            ("l", "g", "lsh_ss", 2),
            ("c", "h", "sjpc", 0), ("d", "h", "sjpc", 0))
QUERIES = (("qa", "self_join", ("a",), None), ("qa3", "self_join", ("a",), 3),
           ("qc4", "self_join", ("c",), 4), ("qd", "all_thresholds", ("d",), None),
           ("qab", "join", ("a", "b"), None), ("qcd", "join", ("c", "d"), 3),
           ("qr", "all_thresholds", ("r",), None), ("qr0", "self_join", ("r0",), None),
           ("ql", "all_thresholds", ("l",), None))


def records(rng, n, d=4, card=4):
    return rng.integers(0, card, size=(n, d)).astype(np.uint32)


def bundles():
    """A private metrics registry and tracer per package (the default
    bundles are process-global, so counters would pile up across tests)."""
    jm, tm = JRegistry(), TRegistry()
    return (JObs(metrics=jm, tracer=JTracer(registry=jm)),
            TObs(metrics=tm, tracer=TTracer(registry=tm)))


def twins(*, obs=False, **cfg_kw):
    """A JAX service and a port service (``device="cpu"``) with the same
    config, groups and streams (uids pinned by creation order)."""
    cfg_kw = {"batch_rows": BATCH_ROWS, "window_epochs": 3, **cfg_kw}
    jo, to = bundles() if obs else (None, None)
    j = jsvc.EstimationService(jsvc.ServiceConfig(**cfg_kw), obs=jo)
    t = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", **cfg_kw), obs=to)
    return j, t


def build(svc, cfg, topology=TOPOLOGY, queries=QUERIES, query_cls=None):
    for gid in sorted({g for _, g, _, _ in topology}):
        svc.create_group(gid, cfg)
    for name, gid, kind, backing in topology:
        svc.create_stream(name, gid, estimator=kind, backing_epochs=backing)
    for name, kind, streams, s in queries:
        svc.register_continuous(query_cls(name, kind, streams, s))


def build_twins(topology=TOPOLOGY, queries=QUERIES, **kw):
    j, t = twins(**kw)
    build(j, JCFG, topology, queries, jsvc.ContinuousQuery)
    build(t, TCFG, topology, queries, tsvc.ContinuousQuery)
    return j, t


def epoch_batches(seed, names, epochs, idle=()):
    """Per epoch, the records of each stream: ROWS each, none for the
    (epoch, stream) cells in ``idle`` (ride-along rounds)."""
    rng = np.random.default_rng(seed)
    return [{n: (records(rng, 0) if (e, n) in idle else records(rng, ROWS)) for n in names}
            for e in range(epochs)]


def ingest_both(services, batch):
    for svc in services:
        for name, rows in batch.items():
            svc.ingest(name, rows)


def assert_same_state(jstate, tstate, what=""):
    assert tuple(jstate._fields) == tuple(tstate._fields), what
    for field in jstate._fields:
        a = np.asarray(getattr(jstate, field))
        b = getattr(tstate, field).cpu().numpy()
        assert a.shape == b.shape, (what, field)
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{what} {field}")


def assert_same_windows(j, t):
    for e in j.registry.streams():
        te = t.registry.stream(e.name)
        assert (te.uid, te.flushes, te.records) == (e.uid, e.flushes, e.records), e.name
        assert te.window.version == e.window.version, e.name
        assert_same_state(e.window.total, te.window.total, e.name)


def assert_result_close(a, b, tol=TOL):
    """One served result of each package: the floats within ``tol``
    (relative and absolute), the metadata equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_result_close(a[k], b[k], tol)
        return
    assert (a.kind, tuple(a.streams), a.s) == (b.kind, tuple(b.streams), b.s)
    for field in ("estimate", "stderr", "stderr_offline"):
        assert getattr(b, field) == pytest.approx(getattr(a, field), rel=tol, abs=tol), field
    np.testing.assert_allclose(np.asarray(b.per_level), np.asarray(a.per_level),
                               rtol=tol, atol=tol)
    assert tuple(a.n) == tuple(b.n)
    assert tuple(a.window_epochs) == tuple(b.window_epochs)
    assert a.stderr_kind == b.stderr_kind
    assert a.stale == b.stale


def assert_same_results(out_j, out_t):
    assert out_j.keys() == out_t.keys()
    for name in out_j:
        assert_result_close(out_j[name], out_t[name])


def every_cell(svc):
    """Every (stream, s) result of one snapshot (joins: every SJPC pair of
    a group at every s)."""
    snap = svc.snapshot()
    out = {}
    for e in svc.registry.streams():
        cfg = svc.registry.group(e.group_id).cfg
        for s in range(cfg.s, cfg.d + 1):
            out[(e.name, s)] = snap.self_join(e.name, s)
    names = [e.name for e in svc.registry.streams() if e.estimator_kind == "sjpc"]
    for a in names:
        for b in names:
            if a < b and svc.registry.joinable(a, b):
                cfg = svc.registry.group_of(a).cfg
                for s in range(cfg.s, cfg.d + 1):
                    out[(a, b, s)] = snap.join(a, b, s)
    return out
