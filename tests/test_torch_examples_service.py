"""The service and cluster example twins (``examples/*_torch.py``) on the
CPU at small sizes: each prints its reference's lines, and each holds the
property its reference demonstrates -- the batched query equal to the
per-stream oracle, windowed estimates beside their exact counts, equal
space across the three estimator kinds, one fused launch per poll and the
budgeted tenant's stale answers, audits covering the polled queries, the
contamination join near its exact size, and the cluster's replica bit for
bit equal to its single-process oracle.
"""
import math
import os
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, argv, capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        module = __import__(f"{name}_torch")
    finally:
        sys.path.pop(0)
    out = module.main(["--device", "cpu", *argv])
    return out, capsys.readouterr().out


def test_batched_queries(capsys):
    out, text = _run("batched_queries", ["--tenants", "8", "--records", "512",
                                         "--snapshots", "5"], capsys)
    assert "fused batched: 24 (stream, threshold) cells" in text
    assert "per-stream oracle: 24 (stream, threshold) cells" in text
    assert "tenant-00 all-thresholds (fused vs oracle):" in text
    assert "steady-state polling (8 streams x all thresholds" in text
    assert "(cache refreshed by window version, never stale)" in text
    assert sorted(out["fused"]) == [4, 5, 6]
    for k, v in out["fused"].items():
        assert abs(v - out["oracle"][k]) <= 1e-6 * max(abs(v), 1.0)


def test_serve_estimates(capsys):
    out, text = _run("serve_estimates", ["--ticks", "3", "--batch", "200"], capsys)
    assert "D=6 S=4 window=4 epochs; per-tenant window memory" in text
    assert all(f"tick {t}: alpha g_4 = " in text for t in range(3))
    assert "all-thresholds snapshot for alpha:" in text
    assert "ingest: 1800 records in" in text
    for _, est, exact_g, join in out:
        assert math.isfinite(est) and exact_g > 0 and join >= 0


def test_equal_space_serving(capsys):
    out, text = _run("equal_space_serving", ["--records", "2048", "--cluster-scale", "0.25"],
                     capsys)
    assert "2048 records, SJPC budget 73728 bytes" in text
    for kind in ("sjpc", "reservoir", "lsh_ss"):
        assert any(line.strip().startswith(kind) for line in text.splitlines()), kind
        assert sorted(out[kind]) == [4, 5, 6]
    assert "per-stream estimator metadata:" in text
    # the reservoir holds every record at this size: its answers are exact
    assert out["reservoir"] == out["exact"]


def test_planner_admission(capsys):
    out, text = _run("planner_admission", ["--records", "256"], capsys)
    assert "4 groups x 4 streams, 16 standing queries:" in text
    assert out["launches"] == 1 and out["cohorts"] == 4
    assert out["built"] == 1 and out["reused"] == 2
    assert out["stale"] == [False, True, False, True] and out["rejections"] == 2
    assert "admission_rejections_total = 2; every other tenant stayed fresh" in text


def test_observability(capsys):
    out, text = _run("observability", ["--epochs", "2", "--rows", "60"], capsys)
    assert "tenant-a self-join g_4:" in text and "95% CI" in text
    assert "Prometheus exposition (excerpt)" in text and "trace excerpt" in text
    assert "kernel_dispatch_total" in out["report"]
    assert out["audits"] > 0 and out["covered"] <= out["audits"]
    assert {"service.flush", "service.poll"} <= {ev["name"] for ev in out["events"]}
    assert f"{len(out['events'])} span events; audits run: {out['audits']:.0f}" in text


def test_join_contamination(capsys):
    out, text = _run("join_contamination", ["--train", "1024", "--eval", "128",
                                            "--shared", "16"], capsys)
    assert "planted contaminated sequences: 16" in text
    assert "SJPC join estimate:" in text and "per-level join estimates:" in text
    assert out["exact"] >= 16
    assert abs(out["estimate"] - out["exact"]) <= 0.5 * out["exact"]


def test_distributed_scaleout(capsys):
    out, text = _run("distributed_scaleout", ["--cycles", "2", "--rows", "64"], capsys)
    assert "2 workers, 8 tenants, 1024 records in 2 epochs" in text
    assert "replica vs oracle: linear counters bit-exact=True" in text
    assert out["agree"]["linear_exact"] and out["agree"]["worst_rel_err"] == 0.0
    assert out["heartbeats"] == 2
    assert len(out["dead"]) + len(out["live"]) == 8 and out["dead"] and out["live"]
    assert out["dead_stale"] is True and out["live_stale"] is False
