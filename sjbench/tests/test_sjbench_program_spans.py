"""The readers of the program's own spans (``sjpc.prepare_us``,
``sjpc.draws_us``, ``sjpc.ingest_us``, ``sjpc.estimate_wait_ms``,
``sjpc.estimate_host_ms``) on a registry filled by hand: their values,
the division by the jobs, and nothing read where the family is absent."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro_torch.obs.metrics import MetricsRegistry, set_default_registry  # noqa: E402

from sjbench import harness  # noqa: E402

FAMILY = "sjpc_span_seconds"
READERS = ("sjpc.prepare_us", "sjpc.draws_us", "sjpc.ingest_us", "sjpc.estimate_wait_ms",
           "sjpc.estimate_host_ms")


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        yield reg
    finally:
        set_default_registry(prev)


def _read(name: str):
    return harness.load_module("metrics", name).read(harness.Run())


def _fill(reg, path: str, *seconds: float) -> None:
    for s in seconds:
        reg.observe(FAMILY, s, span=path)


def test_stage_readers_give_the_mean_in_us(registry):
    _fill(registry, "sjpc.update_fused", 300e-6, 340e-6)
    _fill(registry, "sjpc.update_fused/prepare", 50e-6, 70e-6)
    _fill(registry, "sjpc.update_fused/draws", 80e-6, 100e-6)
    _fill(registry, "sjpc.update_fused/ingest", 120e-6, 160e-6)
    assert _read("sjpc.prepare_us") == pytest.approx(60.0)
    assert _read("sjpc.draws_us") == pytest.approx(90.0)
    assert _read("sjpc.ingest_us") == pytest.approx(140.0)


def test_estimate_readers_divide_by_the_jobs(registry):
    # three jobs: each one estimate_batch and one estimate_join_batch
    _fill(registry, "sjpc.estimate_batch", 0.008, 0.009, 0.010)
    _fill(registry, "sjpc.estimate_join_batch", 0.002, 0.002, 0.002)
    _fill(registry, "sjpc.estimate_batch/wait", 0.006, 0.007, 0.008)
    _fill(registry, "sjpc.estimate_join_batch/wait", 0.0001, 0.0001, 0.0001)
    wait, host = _read("sjpc.estimate_wait_ms"), _read("sjpc.estimate_host_ms")
    assert wait == pytest.approx((0.021 + 0.0003) / 3 * 1e3)
    assert host == pytest.approx((0.027 + 0.006 - 0.0213) / 3 * 1e3)
    assert wait + host == pytest.approx((0.027 + 0.006) / 3 * 1e3)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_family(registry, name):
    registry.observe("other_seconds", 1.0, span="sjpc.update_fused/prepare")
    assert _read(name) is None


def test_estimate_readers_need_both_estimates_and_their_waits(registry):
    _fill(registry, "sjpc.estimate_batch", 0.01)
    _fill(registry, "sjpc.estimate_batch/wait", 0.005)
    _fill(registry, "sjpc.estimate_join_batch", 0.002)
    assert _read("sjpc.estimate_wait_ms") is None and _read("sjpc.estimate_host_ms") is None
    _fill(registry, "sjpc.estimate_join_batch/wait", 0.0)
    assert _read("sjpc.estimate_wait_ms") == pytest.approx(5.0)
    assert _read("sjpc.estimate_host_ms") == pytest.approx(7.0)
