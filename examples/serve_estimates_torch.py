"""Serve windowed similarity estimates to multiple tenants on the PyTorch
port.  The port's counterpart of ``examples/serve_estimates.py``, with
``--device`` and size flags.

    PYTHONPATH=src python examples/serve_estimates_torch.py                # on the card
    PYTHONPATH=src python examples/serve_estimates_torch.py --device cpu   # on the CPU

Three tenant streams share one hash group (so any pair supports the §6
join estimator).  Each tick the tenants ingest a batch of records --
buffered host-side, then flushed in batched rounds for all tenants (on
the card, the ``sample_weights`` and ``fused_ingest`` kernels) -- and the
epoch rotates, expiring data older than the window by counter
subtraction.  Standing queries are polled each tick from one shared
snapshot, with analytical error bars, and the windowed self-join estimate
is compared against the exact count over the same live window.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import exact, sjpc  # noqa: E402
from repro_torch.data.synthetic import shingle_records  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402

D, S, WINDOW = 6, 4, 4
TENANTS = ("alpha", "beta", "gamma")


def main(argv=None) -> list:
    """Prints each tick's line; returns [(tick, alpha g_S, exact, join)]."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--batch", type=int, default=800)
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")
    batch = args.batch

    svc = EstimationService(ServiceConfig(device=device, batch_rows=256,
                                          window_epochs=WINDOW))
    svc.create_group("tenants", sjpc.SJPCConfig(d=D, s=S, ratio=1.0, width=4096, depth=3))
    for t in TENANTS:
        svc.create_stream(t, "tenants")
    svc.register_continuous(ContinuousQuery("alpha/self", "self_join", ("alpha",)))
    svc.register_continuous(ContinuousQuery("alpha|beta", "join", ("alpha", "beta")))

    mem = svc.registry.stream("alpha").window.memory_bytes()
    print(f"{D=} {S=} window={WINDOW} epochs; per-tenant window memory "
          f"{mem / 1024:.0f} KiB\n")

    # beta replays a slice of alpha's records each tick -> a planted join signal
    history = {t: [] for t in TENANTS}
    out = []
    for tick in range(args.ticks):
        a = shingle_records(batch, d=D, seed=100 + tick, group=6,
                            dup_profile=((4, 0.10), (5, 0.05), (6, 0.02)))
        b = np.concatenate([a[:batch // 8],
                            shingle_records(batch - batch // 8, d=D, seed=500 + tick,
                                            group=6)])
        g = shingle_records(batch, d=D, seed=900 + tick, group=6)
        for name, recs in (("alpha", a), ("beta", b), ("gamma", g)):
            svc.ingest(name, recs)
            history[name].append(recs)
            # mirror the live window: after advance_epoch the open epoch is
            # empty, so the window holds the last WINDOW-1 closed epochs
            history[name] = history[name][-(WINDOW - 1):]
        svc.advance_epoch()

        results = svc.poll()
        r = results["alpha/self"]
        true_g = exact.exact_g(np.concatenate(history["alpha"]), S)
        j = results["alpha|beta"]
        out.append((tick, r.estimate, true_g, j.estimate))
        print(f"tick {tick}: alpha g_{S} = {r.estimate:>9.0f} +/- {r.stderr:>8.0f}"
              f"  (exact {true_g:>9.0f})   alpha|beta join = {j.estimate:>7.0f}")

    print("\nall-thresholds snapshot for alpha:")
    for k, r in svc.snapshot().all_thresholds("alpha").items():
        print(f"  s={k}: {r.estimate:>10.0f} +/- {r.stderr:.0f}")

    d = svc.describe()
    ing = d["groups"]["tenants"]["ingest"]
    print(f"\ningest: {ing['submitted_records']} records in {ing['rounds']} "
          f"batched dispatches ({ing['padded_rows']} padded rows); "
          f"flush time {d['flush_s']:.2f}s")
    return out


if __name__ == "__main__":
    main()
