"""Quickstart on the PyTorch port: one-pass similarity self-join size
estimation on a stream.  The port's counterpart of
``examples/quickstart.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # on the CPU

Streams 20k 6-column records (with planted near-duplicates) through SJPC in
batches, then queries g_s for every threshold and compares to the exact
answer computed offline.  Each batch's sampling key is the reference's,
``fold_in(PRNGKey(0), i)``, replayed by ``repro_torch.core.prng``; on the
card every update runs the ``sample_weights``, ``fingerprint`` and
``sketch_update`` kernels.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import exact, prng, sjpc  # noqa: E402
from repro_torch.data.synthetic import shingle_records  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

D, S_MIN = 6, 3
DUP_PROFILE = ((3, 0.15), (4, 0.08), (5, 0.05), (6, 0.03))


def main(argv=None) -> list:
    """Prints the table; returns its rows (s, estimate, exact, rel err)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--records", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=2_000)
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    records = shingle_records(args.records, d=D, seed=1, group=6, dup_profile=DUP_PROFILE)
    cfg = sjpc.SJPCConfig(d=D, s=S_MIN, ratio=0.5, width=1024, depth=3)
    params, state = sjpc.init(cfg, device=device)
    print(f"sketch memory: {cfg.counters_bytes / 1024:.0f} KiB "
          f"({cfg.num_levels} levels x {cfg.depth} x {cfg.width} int32)")

    key = prng.PRNGKey(0)
    update_fn = ops.make_sjpc_update_fn()
    for i in range(0, args.records, args.batch):          # one pass, limited memory
        state = sjpc.update(cfg, params, state, records[i:i + args.batch],
                            prng.fold_in(key, i), update_fn=update_fn)

    est = sjpc.estimate(cfg, state)
    rows = []
    print(f"\n{'s':>2} {'estimate g_s':>14} {'exact g_s':>14} {'rel err':>8}")
    for s in range(S_MIN, D + 1):
        g_est = est.x[s - S_MIN:].sum() + est.n
        g_true = exact.exact_g(records, s)
        rel = abs(g_est - g_true) / g_true
        rows.append((s, float(g_est), float(g_true), float(rel)))
        print(f"{s:>2} {g_est:>14.0f} {g_true:>14.0f} {rel:>8.3f}")
    return rows


if __name__ == "__main__":
    main()
