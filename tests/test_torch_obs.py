"""The port's observability (``repro_torch.obs``) on the CPU: tracer spans
(nesting, paths, the JSON-lines sink, the shared no-op span of a disabled
tracer, device-inclusive totals), ``Observability.span`` observing into
its own registry, the accuracy auditor and the service's instrumentation
against the JAX package's on the same workload, and the import hygiene of
``repro_torch.obs`` and ``repro_torch.service``.
"""
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_service_cases import (JCFG, TCFG, assert_same_results, bundles, records)  # noqa: E402

from repro import service as jsvc  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import service as tsvc  # noqa: E402
from repro_torch.obs import MetricsRegistry, Observability, Tracer  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# tracer spans
# ---------------------------------------------------------------------------

def test_nesting_paths_and_depth():
    tr = Tracer()
    with tr.span("outer"):
        with tr.span("inner", rows=3):
            pass
    ev = list(tr.events)
    assert [e["name"] for e in ev] == ["inner", "outer"]
    assert ev[0]["path"] == "outer/inner" and ev[0]["depth"] == 1 and ev[0]["rows"] == 3
    assert ev[1]["path"] == "outer" and ev[1]["depth"] == 0


def test_cpu_tensors_registered_total_covers_dispatch():
    """Registered CPU tensors (bare, in NamedTuples, lists and dicts) wait
    for nothing and total_s >= dispatch_s."""
    tr = Tracer()
    x = torch.ones((64, 64))
    with tr.span("work") as sp:
        y = x @ x
        sp.sync(y, None, [y, {"k": (y,)}], TCFG, 3.0)
    assert sp._sync == set()
    ev = tr.events[-1]
    assert ev["total_ms"] >= ev["dispatch_ms"] and sp.total_s >= sp.dispatch_s
    assert float(y[0, 0]) == 64.0


def test_cuda_devices_are_found_in_containers():
    """The walk that decides what a span waits for reaches tensors inside
    NamedTuples, lists and dicts (CPU tensors add no device)."""
    found = set()
    ttrace._cuda_devices((torch.zeros(2), [torch.zeros(1)], {"a": (torch.zeros(3),)}), found)
    assert found == set()


def test_jsonl_sink_and_path_sink(tmp_path):
    buf = io.StringIO()
    tr = Tracer(sink=buf)
    with tr.span("a", k="v"):
        pass
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(lines) == 1 and lines[0]["name"] == "a" and lines[0]["k"] == "v"
    assert {"ts", "dispatch_ms", "total_ms", "depth"} <= set(lines[0])
    path = tmp_path / "trace.jsonl"
    tr = Tracer(sink=str(path))
    for name in ("x", "y"):
        with tr.span(name):
            pass
    tr.close()
    assert [json.loads(line)["name"] for line in path.read_text().splitlines()] == ["x", "y"]


def test_event_ring_is_bounded():
    tr = Tracer()
    for i in range(ttrace._EVENT_RING + 5):
        with tr.span("s", i=i):
            pass
    assert len(tr.events) == ttrace._EVENT_RING and tr.events[0]["i"] == 5


def test_disabled_tracer_hands_out_the_shared_null_span():
    tr = Tracer(enabled=False)
    span = tr.span("x", histogram="h")
    assert span is tobs.NULL_SPAN and tr.span("y") is span
    with span as sp:
        sp.sync(torch.ones(3))
        sp.set(a=1)
    assert not tr.events and span.total_s == 0.0
    assert Observability.disabled() is Observability.disabled()
    assert Observability.disabled().span("z") is tobs.NULL_SPAN
    assert not Observability.disabled().enabled


def test_exception_pops_stack_without_emitting():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert not tr.events
    with tr.span("after"):
        pass
    assert tr.events[-1]["path"] == "after"


def test_annotate_runs_spans_inside_record_function():
    tr = Tracer(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "outer/inner"} <= names


def test_observability_span_observes_into_its_own_registry():
    reg = MetricsRegistry()
    obs = Observability(metrics=reg, tracer=Tracer())
    with obs.span("s", histogram="s_seconds", labels={"g": "x"}):
        pass
    h = reg.histogram("s_seconds", g="x")
    assert h is not None and h.count == 1
    assert obs.tracer.registry.histogram("s_seconds", g="x") is None
    assert Observability.default().metrics is tobs.default_registry()
    assert Observability.default().tracer is tobs.default_tracer()


def test_exports_match_the_jax_package():
    import repro.obs as jobs
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    assert sorted(tsvc.__all__) == sorted(jsvc.__all__)


# ---------------------------------------------------------------------------
# the auditor and the service's instrumentation against the JAX package
# ---------------------------------------------------------------------------

def _audited_twins(**kw):
    """A JAX and a port service with private registries and the auditor at
    rate 1, one group, streams of every kind and standing queries."""
    out = []
    for (pkg, cfg), obs in zip(((jsvc, JCFG), (tsvc, TCFG)), bundles()):
        extra = {"device": "cpu"} if pkg is tsvc else {}
        svc = pkg.EstimationService(pkg.ServiceConfig(batch_rows=32, window_epochs=2,
                                                      audit_rate=1.0, **kw, **extra), obs=obs)
        svc.create_group("g", cfg)
        for name, kind in (("a", "sjpc"), ("b", "sjpc"), ("r", "reservoir"),
                           ("l", "lsh_ss")):
            svc.create_stream(name, "g", estimator=kind)
        for q in (("qs", "self_join", ("a",)), ("qt", "all_thresholds", ("a",)),
                  ("qj", "join", ("a", "b")), ("qr", "self_join", ("r",)),
                  ("ql", "all_thresholds", ("l",))):
            svc.register_continuous(pkg.ContinuousQuery(*q))
        out.append(svc)
    return out


def _families(svc, prefixes):
    """The counter and gauge families (and the accuracy histograms) whose
    names start with ``prefixes``; latency histograms are compared by
    their counts alone."""
    return {name: fam for name, fam in svc.obs.metrics.collect().items()
            if name.startswith(prefixes) and not name.endswith("_seconds")}


def test_auditor_counters_equal_jax():
    """Mirrored batches across two rotations past the window edge, every
    polled result audited: the accuracy_* counters and histograms equal
    the JAX auditor's, and nothing skips."""
    j, t = _audited_twins()
    rng = np.random.default_rng(7)
    for _ in range(4):
        batch = {name: records(rng, 30, card=3) for name in ("a", "b", "r", "l")}
        for svc in (j, t):
            for name, rows in batch.items():
                svc.ingest(name, rows)
        assert_same_results(j.poll(), t.poll())
        for svc in (j, t):
            svc.advance_epoch()
    fams, want = _families(t, ("accuracy_",)), _families(j, ("accuracy_",))
    rel_t, rel_j = fams.pop("accuracy_rel_err"), want.pop("accuracy_rel_err")
    assert fams == want and rel_t.keys() == rel_j.keys()
    for key, h in rel_j.items():                  # buckets exact, the sum to 1e-6
        assert h["sum"] == pytest.approx(rel_t[key]["sum"], rel=1e-6, abs=1e-6)
        assert {k: v for k, v in h.items() if k != "sum"} == \
            {k: v for k, v in rel_t[key].items() if k != "sum"}
    m = t.obs.metrics
    assert m.counter("accuracy_audits_total", kind="sjpc") == 4 * 5.0
    assert m.counter_total("accuracy_audit_skipped_total") == 0.0


def test_auditor_skips_state_delta_and_oversize_windows():
    for max_records, reason in ((65536, "state_delta_stream"), (16, "window_too_large")):
        j, t = _audited_twins(audit_max_records=max_records)
        for svc in (j, t):
            svc.ingest("b", records(np.random.default_rng(1), 24))
            svc.flush()
            if reason == "state_delta_stream":
                svc.ingest_state_delta("a", svc.registry.stream("b").window.total)
            else:
                svc.ingest("a", records(np.random.default_rng(2), 24))
            svc.poll()
            assert svc.obs.metrics.counter("accuracy_audit_skipped_total", reason=reason) >= 1
        assert _families(t, ("accuracy_",)) == _families(j, ("accuracy_",))


SERVICE_FAMILIES = ("ingest_", "window_", "query_cache_", "query_prefetch_", "planner_",
                    "service_epochs", "estimator_memory", "delta_exports")


def test_service_instrumentation_equal_jax():
    """The service's counters and gauges (ingest, window rotations and
    refolds, cache accounting, the planner, memory gauges, exports) equal
    the JAX service's after the same workload; every *_seconds histogram
    the JAX service fills is filled here too, with the same counts."""
    j, t = _audited_twins()
    rng = np.random.default_rng(3)
    for epoch in range(3):
        batch = {name: records(rng, 40) for name in ("a", "b", "r", "l")}
        for svc in (j, t):
            for name, rows in batch.items():
                if (epoch, name) != (1, "b"):
                    svc.ingest(name, rows)
            svc.poll()
            svc.poll()
            svc.export_deltas()
            svc.advance_epoch()
    for svc in (j, t):
        svc.metrics_report()
    assert _families(t, SERVICE_FAMILIES) == _families(j, SERVICE_FAMILIES)
    hist = lambda svc: {name: {k: v["count"] for k, v in fam.items()}  # noqa: E731
                        for name, fam in svc.obs.metrics.collect().items()
                        if name.endswith("_seconds")}
    assert hist(t) == hist(j) and hist(t)
    assert "query_cache_hit_ratio" in t.metrics_report()


def test_observe_false_keeps_the_service_working_and_silent():
    svc = tsvc.EstimationService(tsvc.ServiceConfig(device="cpu", batch_rows=32,
                                                    observe=False))
    assert svc.obs is Observability.disabled()
    svc.create_group("g", TCFG)
    svc.create_stream("a", "g")
    svc.ingest("a", records(np.random.default_rng(0), 40))
    svc.register_continuous(tsvc.ContinuousQuery("q", "self_join", ("a",)))
    assert svc.poll()["q"].estimate > 0
    assert svc.stats["flush_s"] > 0 and svc.metrics_report() == ""


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_obs_and_service_import_no_jax_and_no_reference_module():
    """A fresh interpreter imports every module of ``repro_torch.obs`` and
    ``repro_torch.service``: no ``jax`` and no ``repro`` module is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.obs, repro_torch.service\n"
        "for pkg in (repro_torch.obs, repro_torch.service):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch.service.')]))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert int(done.stdout.strip()) == 7          # the service's seven modules
