"""Three estimators, one service, equal space, on the PyTorch port.  The
port's counterpart of ``examples/equal_space_serving.py``, with
``--device`` and size flags.

    PYTHONPATH=src python examples/equal_space_serving_torch.py                # on the card
    PYTHONPATH=src python examples/equal_space_serving_torch.py --device cpu   # on the CPU

Creates one hash group and registers a stream per estimator kind -- SJPC
("the paper"), streaming reservoir sampling, and streaming LSH-SS -- at
byte budgets derived from the group's SJPCConfig (equal space by
construction, the Fig. 8 rule).  One planted-cluster stream is replayed
through all three; ``poll()`` answers every standing query from one
snapshot, so the competitors are served side by side.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402
from repro_torch.data.synthetic import planted_cluster_records  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402

KINDS = ("sjpc", "reservoir", "lsh_ss")
CLUSTERS = [(4, 192, 3), (5, 128, 2), (6, 64, 1)]


def main(argv=None) -> dict:
    """Prints the side-by-side table; returns ``{kind: {s: estimate}}``
    and the exact g_s under ``"exact"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--records", type=int, default=8192)
    ap.add_argument("--cluster-scale", type=float, default=1.0,
                    help="multiplies the planted clusters' counts")
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    cfg = SJPCConfig(d=6, s=4, ratio=1.0, width=2048, depth=3, seed=23)
    rng = np.random.default_rng(41)
    clusters = [(k, max(1, int(n * args.cluster_scale)), m) for k, n, m in CLUSTERS]
    vals = planted_cluster_records(args.records, cfg.d, rng, clusters)
    x = exact.exact_pair_counts(vals)
    g_true = {s: float(x[s:].sum() + len(vals)) for s in range(4, 7)}

    svc = EstimationService(ServiceConfig(device=device, batch_rows=2048,
                                          window_epochs=None))
    svc.create_group("g", cfg)
    for kind in KINDS:
        svc.create_stream(kind, "g", estimator=kind)
        svc.ingest(kind, vals)
        svc.register_continuous(ContinuousQuery(f"q/{kind}", "all_thresholds", (kind,)))

    results = svc.poll()                    # ONE snapshot serves all kinds
    print(f"{len(vals)} records, SJPC budget {cfg.counters_bytes} bytes\n")
    print(f"{'estimator':>10} {'mem B':>8} " + " ".join(f"{'s=' + str(s):>18}" for s in g_true))
    print(f"{'(exact)':>10} {'':>8} " + " ".join(f"{g_true[s]:>18.0f}" for s in g_true))
    out = {"exact": g_true}
    for kind in KINDS:
        mem = svc.registry.stream(kind).estimator.memory_bytes()
        row = results[f"q/{kind}"]
        cells = []
        for s in g_true:
            r = row[s]
            err = abs(r.estimate - g_true[s]) / g_true[s]
            cells.append(f"{r.estimate:>8.0f}±{r.stderr:<6.0f}({err:>4.0%})")
        kinds_bar = next(iter(row.values())).stderr_kind
        print(f"{kind:>10} {mem:>8} " + " ".join(cells) + f"   [{kinds_bar}]")
        out[kind] = {s: row[s].estimate for s in g_true}
    print("\nper-stream estimator metadata:",
          {nm: row["estimator"] for nm, row in svc.describe()["groups"]["g"]["streams"].items()})
    return out


if __name__ == "__main__":
    main()
