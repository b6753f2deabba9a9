"""The kernel path's spans (``obs.trace.path_tracer``) in SJPC's scan path,
on the CPU: off without a profiler (no range, no registry write, the
shared null span), live under ``torch.profiler`` (nested ranges, one
histogram observation a call, event stamps on the profiler's clock) or
when an operator enables the tracer, and the results bit-identical
either way."""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sjpc  # noqa: E402
from repro_torch.obs import NULL_SPAN, MetricsRegistry, set_default_registry  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

CFG = sjpc.SJPCConfig(d=5, s=3, width=64, depth=3, seed=7)
FAMILY = "sjpc_span_seconds"
UPDATE_STAGES = ("prepare", "draws", "ingest")
ESTIMATE_STAGES = ("wait", "query", "recursion", "to_host", "bounds")
ROOTS = ("sjpc.update_fused", "sjpc.estimate_batch", "sjpc.estimate_join_batch")


@pytest.fixture
def registry():
    """A fresh default registry for the test, the previous one restored."""
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        yield reg
    finally:
        set_default_registry(prev)


@pytest.fixture
def enabled():
    """The path tracer switched on by an operator for the test, with a
    JSON-lines sink."""
    tracer = ttrace.path_tracer()
    sink = io.StringIO()
    tracer.switch(True, sink=sink)
    try:
        yield tracer, sink
    finally:
        tracer.switch(False)


@pytest.fixture
def no_range(monkeypatch):
    """Fails the test if a profiler range is constructed."""
    def fail(*args, **kwargs):
        pytest.fail(f"profiler range opened: {args}")
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fail)


def _job(calls=2, rows=32):
    """Two half streams of ``calls`` update_fused calls each, the whole
    stream, and both batched estimates: (states, tables)."""
    rng = np.random.default_rng(5)
    params, empty = sjpc.init(CFG, device="cpu")
    half = whole = empty
    for i in range(2 * calls):
        values = rng.integers(0, 3, size=(rows, CFG.d)).astype(np.uint32)
        whole = sjpc.update_fused(CFG, params, whole, values)
        if i == calls - 1:
            half = whole
    second = sjpc.subtract(whole, half)
    self_table = sjpc.estimate_batch(CFG, whole.counters[None], whole.n[None])
    join_table = sjpc.estimate_join_batch(CFG, half.counters[None], second.counters[None],
                                          half.n[None], second.n[None])
    return (half, whole, second), (self_table, join_table)


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, prof


def _counts(reg) -> dict:
    fam = reg.collect().get(FAMILY, {})
    return {key[len('{span="'):-2]: v["count"] for key, v in fam.items()}


def test_off_without_a_profiler_writes_nothing_and_opens_no_range(registry, no_range):
    assert not torch.autograd._profiler_enabled()
    tracer = ttrace.path_tracer()
    assert not tracer.enabled
    assert all(tracer.span(root) is NULL_SPAN for root in ROOTS)
    assert NULL_SPAN.stage("prepare") is None
    before = len(tracer.events)
    _job()
    assert FAMILY not in registry.collect()
    assert len(tracer.events) == before


def test_switched_on_without_a_profiler_observes_but_opens_no_range(registry, enabled,
                                                                     no_range):
    tracer, sink = enabled
    _job(calls=2)
    counts = _counts(registry)
    assert counts["sjpc.update_fused"] == 4
    assert all(counts[f"sjpc.update_fused/{s}"] == 4 for s in UPDATE_STAGES)
    assert all(counts[f"{root}/{s}"] == 1 for root in ROOTS[1:] for s in ESTIMATE_STAGES)
    lines = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert len(lines) == sum(counts.values())
    roots = [e for e in lines if e["path"] == "sjpc.update_fused"]
    assert len(roots) == 4 and all(e["rows"] == 32 and e["depth"] == 0 for e in roots)
    assert {e["path"] for e in lines} == set(counts)
    tracer.switch(False)
    assert tracer.span("sjpc.update_fused") is NULL_SPAN


def test_profiler_opens_nested_ranges_counted_once_a_call(registry):
    tracer = ttrace.path_tracer()
    before = len(tracer.events)
    _, prof = _profiled(lambda: _job(calls=3))
    assert len(tracer.events) == before           # events only when switched on
    names = {e.key for e in prof.key_averages()}
    stages = ([f"sjpc.update_fused/{s}" for s in UPDATE_STAGES]
              + [f"{root}/{s}" for root in ROOTS[1:] for s in ESTIMATE_STAGES])
    assert set(ROOTS) <= names and set(stages) <= names
    counts = _counts(registry)
    assert counts == {**{p: 6 for p in ("sjpc.update_fused",) + tuple(stages[:3])},
                      **{p: 1 for p in ROOTS[1:] + tuple(stages[3:])}}
    ranges = [e for e in prof.events() if e.name.startswith("sjpc.")]
    for child in ranges:
        if "/" not in child.name:
            continue
        parent = child.name.rsplit("/", 1)[0]
        assert any(p.name == parent
                   and p.time_range.start <= child.time_range.start
                   and child.time_range.end <= p.time_range.end for p in ranges), child.name
    assert not torch.autograd._profiler_enabled()
    assert ttrace.path_tracer().span("sjpc.update_fused") is NULL_SPAN


def test_event_stamps_share_the_profiler_clock(registry, enabled, tmp_path):
    tracer, _ = enabled
    before = len(tracer.events)
    _, prof = _profiled(lambda: _job(calls=1))
    events = list(tracer.events)[before:]
    assert len(events) == 2 * (1 + len(UPDATE_STAGES)) + 2 * (1 + len(ESTIMATE_STAGES))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    base_us = chrome.get("baseTimeNanoseconds", 0) / 1e3
    ranges = {}
    for e in chrome["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("sjpc."):
            ranges.setdefault(e["name"], []).append((base_us + e["ts"]) / 1e6)
    assert {e["path"] for e in events} <= set(ranges)
    for e in events:
        assert min(abs(e["ts"] - ts) for ts in ranges[e["path"]]) < 1e-3, e["path"]


def _same(a, b):
    for sa, sb in zip(a[0], b[0]):
        for la, lb in zip(sa, sb):
            assert torch.equal(la, lb)
    for ta, tb in zip(a[1], b[1]):
        for fa, fb in zip(ta, tb):
            np.testing.assert_array_equal(fa, fb)


def test_results_bit_identical_live_and_off(registry, enabled):
    live_enabled = _job()
    enabled[0].switch(False)
    off = _job()
    live_profiled, _ = _profiled(_job)
    _same(off, live_enabled)
    _same(off, live_profiled)


def test_wait_blocks_only_on_cuda_streams():
    """A live span's ``wait`` finds no CUDA device among host tensors (and
    containers of them) and returns at once."""
    tracer = ttrace.PathTracer(enabled=True)
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        with tracer.span("root") as root:
            root.stage("wait")
            root.wait(torch.ones(3), [torch.zeros(2)], None)
    finally:
        set_default_registry(prev)
    assert reg.histogram(FAMILY, span="root/wait").count == 1
    assert [e["path"] for e in tracer.events] == ["root/wait", "root"]
