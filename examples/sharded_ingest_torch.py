"""Fused, sharded ingest through the PyTorch port: the Step-1 hot path end
to end.  The port's counterpart of ``examples/sharded_ingest.py``, with
``--device``.

    PYTHONPATH=src python examples/sharded_ingest_torch.py                # on the card
    PYTHONPATH=src python examples/sharded_ingest_torch.py --device cpu   # on the CPU

Three things happen here:

1. **Fused == reference.**  A batch is folded into the sketch through the
   fused path (on the card: the ``sample_weights`` and ``fused_ingest``
   kernels, every lattice level in one launch) and through the per-level
   path with the same key; the counters are compared bit for bit.
2. **Sharded ingest with deferred merges.**  A stream of micro-batches is
   split across a ``ShardedIngest`` executor, its shards stacked on the
   one device.  Nothing crosses shards per micro-batch; ``merged()`` pays
   the single deferred reduction at query time.
3. **Estimates are path-independent.**  The merged sharded sketch and a
   plain unsharded sketch of the same records are the same counters at
   ratio=1.0, where no per-record sampling randomness exists.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import exact, prng, sjpc  # noqa: E402

D, S, WIDTH, DEPTH = 6, 4, 4096, 3
MICRO, N_MICRO, SHARDS = 1000, 6, 2


def main(device) -> None:
    device = platform.resolve(device)
    print(f"device: {device}")
    cfg = sjpc.SJPCConfig(d=D, s=S, ratio=1.0, width=WIDTH, depth=DEPTH, seed=42)
    params, state0 = sjpc.init(cfg, device=device)
    rng = np.random.default_rng(0)

    # --- 1. fused path == reference path, bit for bit --------------------
    batch = rng.integers(0, 8, size=(MICRO, D)).astype(np.uint32)
    key = prng.PRNGKey(7)
    ref = sjpc.update(cfg, params, state0, batch, key=key)
    fused = sjpc.update_fused(cfg, params, state0, batch, key=key)
    assert bool((ref.counters == fused.counters).all())
    print(f"fused ingest == per-level reference: bit-exact "
          f"({ref.counters.numel()} counters)")

    # --- 2. sharded executor, merge deferred across micro-batches --------
    sh = sjpc.ShardedIngest(cfg, params, num_shards=SHARDS, device=device)
    history = []
    for _ in range(N_MICRO):
        mb = rng.integers(0, 8, size=(MICRO, D)).astype(np.uint32)
        history.append(mb)
        sh.ingest(mb)                      # shard-local deltas, no reduction
    merged = sh.merged()                   # THE one cross-shard reduction
    print(f"{N_MICRO} micro-batches across {SHARDS} shards (stacked on {device}); "
          f"merges paid: {sh.merges}")

    # --- 3. the estimate is the same sketch it always was ----------------
    all_records = np.concatenate(history)
    plain = sjpc.update(cfg, params, state0, all_records)
    assert bool((merged.counters == plain.counters).all())

    est = sjpc.estimate(cfg, merged)
    g_true = exact.exact_g(all_records, S)
    print(f"g_{S} estimate {est.g_s:,.0f} vs exact {g_true:,.0f} "
          f"(rel err {abs(est.g_s - g_true) / g_true:.3%}, "
          f"n={est.n:.0f} records, {cfg.counters_bytes / 1024:.0f} KiB sketch)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    main(parser.parse_args().device)
