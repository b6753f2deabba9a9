"""Observability tour on the PyTorch port: metrics, spans, and live
accuracy telemetry.  The port's counterpart of
``examples/observability.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/observability_torch.py                # on the card
    PYTHONPATH=src python examples/observability_torch.py --device cpu   # on the CPU

Runs a two-tenant estimation service with every signal turned on -- span
tracing to a JSON-lines file, ``audit_rate=1`` sampled exact replay --
drives a few ingest/poll/epoch cycles, then prints the Prometheus text
exposition and a trace excerpt (dispatch vs device-inclusive time per
span: ``Span.sync`` waits for the card).
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402

KEEP = ("ingest_", "query_cache", "service_", "accuracy_", "window_", "kernel_dispatch")


def main(argv=None) -> dict:
    """Prints the estimate, the exposition excerpt and the trace excerpt;
    returns the span events and the audit counters."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--rows", type=int, default=300, help="tenant-a's rows a round")
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    trace_dir = tempfile.mkdtemp(prefix="repro-torch-obs-")
    trace_path = os.path.join(trace_dir, "trace.jsonl")
    svc = EstimationService(ServiceConfig(
        device=device, batch_rows=256, window_epochs=4,
        audit_rate=1.0,                  # audit every polled query (demo rate;
                                         # production samples, e.g. 0.01)
        trace_sink=trace_path))
    svc.create_group("g", SJPCConfig(d=6, s=4, width=1024, depth=3))
    svc.create_stream("tenant-a", "g")
    svc.create_stream("tenant-b", "g")
    svc.register_continuous(ContinuousQuery("a-self", "self_join", ("tenant-a",)))
    svc.register_continuous(ContinuousQuery("a-join-b", "join", ("tenant-a", "tenant-b")))

    met = svc.obs.metrics
    # audit counters since here (the registry may be shared by earlier services)
    base = {name: met.counter_total(name)
            for name in ("accuracy_audits_total", "accuracy_ci_covered_total")}
    rng = np.random.default_rng(0)
    for _ in range(args.epochs):
        for _ in range(2):
            svc.ingest("tenant-a", rng.integers(0, 40, size=(args.rows, 6), dtype=np.uint32))
            svc.ingest("tenant-b",
                       rng.integers(0, 40, size=(args.rows * 2 // 3, 6), dtype=np.uint32))
            out = svc.poll()             # flush + batched queries + audit
        svc.advance_epoch()

    r = out["a-self"]
    lo, hi = r.ci(1.96)
    print(f"tenant-a self-join g_{r.s}: {r.estimate:.0f}  "
          f"(95% CI [{lo:.0f}, {hi:.0f}], n={r.n[0]:.0f})")

    print("\n================ Prometheus exposition (excerpt) ================")
    report = svc.metrics_report()        # refreshes derived gauges first
    for line in report.splitlines():
        if line.startswith(KEEP) or (line.startswith("# TYPE")
                                     and line.split()[2].startswith(KEEP)):
            print(line)

    svc.obs.tracer.close()
    print(f"\n================ trace excerpt ({trace_path}) ================")
    print(f"{'span':<28} {'dispatch ms':>12} {'total ms':>10}   (device gap)")
    with open(trace_path) as f:
        events = [json.loads(line) for line in f]
    for ev in events[-8:]:
        gap = ev["total_ms"] - ev["dispatch_ms"]
        print(f"{'  ' * ev['depth'] + ev['name']:<28} "
              f"{ev['dispatch_ms']:>12.3f} {ev['total_ms']:>10.3f}   (+{gap:.3f})")
    audits, covered = (met.counter_total(name) - n for name, n in base.items())
    print(f"\n{len(events)} span events; audits run: {audits:.0f}, CI covered: {covered:.0f}")
    os.remove(trace_path)
    os.rmdir(trace_dir)
    return {"events": events, "audits": audits, "covered": covered, "report": report}


if __name__ == "__main__":
    main()
