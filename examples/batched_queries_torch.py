"""Answer every tenant's full all-thresholds table from one batched call,
on the PyTorch port.  The port's counterpart of
``examples/batched_queries.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/batched_queries_torch.py                # on the card
    PYTHONPATH=src python examples/batched_queries_torch.py --device cpu   # on the CPU

64 tenant streams share one hash group.  After ingest, a single snapshot
answers 64 streams x every threshold: the batched query engine stacks all
windows into one (N, levels, t, w) tensor and runs one ``fused_query``
call (on the card, the kernel) for the moments, then the depth medians
and the Eq. 4 inversion for all streams at once.  The per-stream numpy
oracle (``use_fused_query=False``) answers the identical query set for
comparison, and a standing-query poll loop shows the steady-state cost
with the version-keyed cache.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import sjpc  # noqa: E402
from repro_torch.service import EstimationService, QueryEngine, ServiceConfig  # noqa: E402

D, S = 6, 4


def main(argv=None) -> dict:
    """Prints the timings and tables; returns the first tenant's fused and
    oracle tables ``{k: estimate}`` and the refreshed g_S."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--records", type=int, default=2048)
    ap.add_argument("--snapshots", type=int, default=200)
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    svc = EstimationService(ServiceConfig(device=device, batch_rows=512, window_epochs=4))
    svc.create_group("tenants", sjpc.SJPCConfig(d=D, s=S, ratio=0.5, width=2048, depth=3))
    rng = np.random.default_rng(0)
    names = [f"tenant-{i:02d}" for i in range(args.tenants)]
    for nm in names:
        svc.create_stream(nm, "tenants")
        svc.ingest(nm, rng.integers(0, 2000, size=(args.records, D), dtype=np.uint32))
    svc.flush()

    # -- one batched snapshot vs the per-stream reference oracle -----------
    svc.engine.snapshot().all_thresholds(names[0])   # warm the batched call
    for tag, engine in (("fused batched", svc.engine),
                        ("per-stream oracle",
                         QueryEngine(svc.registry, use_fused_query=False))):
        engine._cache.clear()                        # time compute, not caching
        snap = engine.snapshot()
        t0 = time.perf_counter()
        tables = {nm: snap.all_thresholds(nm) for nm in names}
        dt = 1e3 * (time.perf_counter() - t0)
        cells = sum(len(t) for t in tables.values())
        print(f"{tag:>18}: {cells} (stream, threshold) cells in {dt:7.2f} ms")

    fused = svc.engine.snapshot().all_thresholds(names[0])
    oracle = QueryEngine(svc.registry, use_fused_query=False).snapshot().all_thresholds(names[0])
    print(f"\n{names[0]} all-thresholds (fused vs oracle):")
    for k in fused:
        print(f"  g_{k} = {fused[k].estimate:>12.1f} +/- {fused[k].stderr:>10.1f}"
              f"   (oracle {oracle[k].estimate:>12.1f})")

    # -- steady-state polling: the version-keyed cache ---------------------
    watched = names[:16]
    t0 = time.perf_counter()
    for _ in range(args.snapshots):
        snap = svc.engine.snapshot(watched)
        for nm in watched:
            snap.all_thresholds(nm)
    dt = time.perf_counter() - t0
    print(f"\nsteady-state polling ({len(watched)} streams x all thresholds, window "
          f"unchanged): {args.snapshots / dt:7.0f} snapshots/s "
          f"({1e3 * dt / args.snapshots:.2f} ms each)")

    svc.ingest(names[0], rng.integers(0, 2000, size=(256, D), dtype=np.uint32))
    svc.flush()                      # bumps tenant-00's window version
    r = svc.engine.snapshot([names[0]]).self_join(names[0])
    print(f"after one more flush, {names[0]} g_{S} = {r.estimate:.1f} "
          f"(cache refreshed by window version, never stale)")
    return {"fused": {k: v.estimate for k, v in fused.items()},
            "oracle": {k: v.estimate for k, v in oracle.items()}, "refreshed": r.estimate}


if __name__ == "__main__":
    main()
