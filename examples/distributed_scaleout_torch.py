"""Multi-host distributed service on the PyTorch port: sharded workers,
one coordinator.  The port's counterpart of
``examples/distributed_scaleout.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/distributed_scaleout_torch.py                # on the card
    PYTHONPATH=src python examples/distributed_scaleout_torch.py --device cpu   # on the CPU
    PYTHONPATH=src python examples/distributed_scaleout_torch.py --subprocess   # child processes

A 2-worker cluster (in-process handles by default, so the example runs
fast; ``--subprocess`` for real child processes, all on the one card)
serves 8 tenants hashed across the workers by ``crc32(name) % 2``.  Each
cycle the coordinator routes ingest to the owning worker, pulls every
worker's epoch-aligned sketch deltas over the wire format (frames
byte-compatible with the JAX package's), merges them into its query
replica, and closes the epoch everywhere.  The replica state is
bit-identical to a single-process run over the same records.

Then one worker "dies": its tenants keep serving from the last merged
window, marked ``stale=True``, while the surviving shard stays fresh.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.distributed import harness, shard_of  # noqa: E402


def main(argv=None) -> dict:
    """Prints the cluster's lines; returns the oracle agreement and the
    stale and fresh tenants after the loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--subprocess", action="store_true", help="workers as child processes")
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--rows", type=int, default=256, help="rows a tenant a cycle")
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    spec = harness.make_spec(8, kinds=("sjpc", "reservoir"), width=512, window_epochs=4,
                             batch_rows=128, device=device.type)
    batches = harness.make_batches(spec, cycles=args.cycles, rows_per_cycle=args.rows)
    run = harness.run_cluster(spec, batches, n_workers=2, cycles=args.cycles,
                              local=not args.subprocess, keep_open=True)
    coord = run.coordinator
    try:
        # -- replica == single-process oracle ------------------------------
        oracle = harness.run_oracle(spec, batches, cycles=args.cycles)
        agree = harness.compare_to_oracle(coord, oracle, spec)
        names = [s["name"] for s in spec.streams]
        print(f"2 workers, {len(names)} tenants, {run.records} records in "
              f"{args.cycles} epochs ({run.rec_per_s:,.0f} rec/s aggregate)")
        print(f"  replica vs oracle: linear counters bit-exact={agree['linear_exact']}, "
              f"worst estimate gap {agree['worst_rel_err']:.2e}")
        print(f"  merge p50/p95: {1e3 * run.merge_p50_s:.1f}/"
              f"{1e3 * run.merge_p95_s:.1f} ms per worker sync")

        nm = names[0]
        res = coord.self_join(nm)
        print(f"  {nm} (worker {shard_of(nm, 2)}): g_s ~= {res.estimate:.0f} "
              f"+/- {res.stderr:.0f}, stale={res.stale}")

        # -- idle cycle: the zero-byte heartbeat ---------------------------
        stats = coord.sync()                       # nothing ingested since last sync
        print(f"idle sync: {stats['heartbeats']}/{stats['workers']} workers sent "
              f"the zero-byte heartbeat ({stats['deltas']} deltas to merge)")

        # -- losing a worker -----------------------------------------------
        if args.subprocess:
            coord.workers[0].kill()
        else:
            coord.workers[0].fail()
        for n in names:                            # routed records to a dead shard
            coord.ingest(n, np.asarray(batches[n][0]))   # are counted and dropped
        coord.sync()
        dead = sorted(coord.stale_tenants)
        live = [n for n in names if n not in coord.stale_tenants]
        print(f"worker 0 lost: {len(dead)} tenants now serve their last-merged "
              f"window stale=True, {len(live)} stay fresh")
        print(f"  {dead[0]}: stale={coord.self_join(dead[0]).stale}   "
              f"{live[0]}: stale={coord.self_join(live[0]).stale}")
        return {"agree": agree, "heartbeats": stats["heartbeats"], "dead": dead,
                "live": live, "dead_stale": coord.self_join(dead[0]).stale,
                "live_stale": coord.self_join(live[0]).stale}
    finally:
        coord.close()


if __name__ == "__main__":
    main()
