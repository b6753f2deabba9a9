"""Each cell's comparison catches the faults its timed path can have.

The harness runs on the CPU at a tiny size (its look for a chip skipped),
with the program's plain path, and with the timed path broken underneath:
a step that returns its state unchanged, half of each batch left out, an
answer altered where it is produced.  ``correct`` has to come out false for
each, and true without a fault.  (No cell spans chips, so no exchange
between chips can be left out.)"""
from __future__ import annotations

import time

import pytest

from repro_torch.core import sjpc
from repro_torch.estimators.reservoir import ReservoirEstimator
from sjbench import harness

SMALL = {
    "dblp_titles.scan": ({"rows": 1 << 10}, {"call_rows": 1 << 8}),
    "yfcc.scan": ({"rows": 1 << 10}, {"call_rows": 1 << 8}),
    "dblp_titles.sample_query": ({"rows": 1 << 11, "width": 64}, {"streams": 4, "round_rows": 32}),
}


def _scan_fault(monkeypatch, fault):
    update, estimate = sjpc.update_fused, sjpc.estimate_batch
    if fault == "unchanged":
        monkeypatch.setattr(sjpc, "update_fused", lambda cfg, params, state, values, **kw: state)
    elif fault == "half_batch":
        monkeypatch.setattr(sjpc, "update_fused", lambda cfg, params, state, values, **kw:
                            update(cfg, params, state, values[:values.shape[0] // 2], **kw))
    elif fault == "altered":
        def altered(*args, **kw):
            est = estimate(*args, **kw)
            return est._replace(g=est.g * (1 + 1e-3))
        monkeypatch.setattr(sjpc, "estimate_batch", altered)


def _query_fault(monkeypatch, fault):
    ingest, estimate = ReservoirEstimator.ingest_rounds, ReservoirEstimator.estimate_batch
    if fault == "unchanged":
        monkeypatch.setattr(ReservoirEstimator, "ingest_rounds",
                            lambda self, states, values, mask, keys: states)
    elif fault == "half_batch":
        monkeypatch.setattr(ReservoirEstimator, "ingest_rounds",
                            lambda self, states, values, mask, keys: ingest(
                                self, states, values[:, :, :values.shape[2] // 2],
                                mask[:, :, :mask.shape[2] // 2], keys))
    elif fault == "altered":
        def altered(self, states, **kw):
            table = estimate(self, states, **kw)
            return table._replace(g=table.g * (1 + 1e-3))
        monkeypatch.setattr(ReservoirEstimator, "estimate_batch", altered)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", list(SMALL))
def test_sjbench_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    config, traffic = cell.split(".")
    entry = {"name": cell, "config": config, "traffic": traffic, "chips": 1}
    c = harness.Cell(harness.load_spec(), entry, *SMALL[cell])
    (_scan_fault if c.traffic["kind"] == "scan" else _query_fault)(monkeypatch, fault)
    result, _ = harness.execute(c, 2**31 + 17, 0.01, False, "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), result["checks"]
    if fault is not None:
        assert result["failed"] > 0
    assert list(result)[-1] == "checks"
