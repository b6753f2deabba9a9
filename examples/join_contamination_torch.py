"""Similarity JOIN size estimation (paper §6) as train<->eval
contamination detection, on the PyTorch port.  The port's counterpart of
``examples/join_contamination.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/join_contamination_torch.py                # on the card
    PYTHONPATH=src python examples/join_contamination_torch.py --device cpu   # on the CPU

Sketch both corpora with shared hash parameters; the sketch inner
products at each lattice level invert (Eq. 7) into the cross-corpus
near-duplicate count.  On the card every monitor update runs the
``sample_weights``, ``fingerprint`` and ``sketch_update`` kernels.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.data.recordize import np_records_from_tokens  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sketchstream.monitor import (MonitorState, SketchMonitorConfig,  # noqa: E402
                                              contamination_estimate, init_monitor,
                                              monitor_update_local)

D, SEQ, CHUNK = 6, 96, 512


def main(argv=None) -> dict:
    """Prints the planted, exact and estimated join sizes; returns them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--train", type=int, default=4096, help="training sequences")
    ap.add_argument("--eval", type=int, default=512, help="evaluation sequences")
    ap.add_argument("--shared", type=int, default=64, help="planted shared sequences")
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")

    rng = np.random.default_rng(3)
    train_toks = zipf_tokens(rng, args.train, SEQ, 50_000, dup_fraction=0.0)
    eval_toks = zipf_tokens(rng, args.eval, SEQ, 50_000, dup_fraction=0.0)
    eval_toks[:args.shared] = train_toks[:args.shared]       # planted contamination

    cfg = SketchMonitorConfig(d=D, s=D, ratio=1.0, width=4096, depth=3, shards=1)
    params, st_a = init_monitor(cfg, device=device)
    _, st_b = init_monitor(cfg, device=device)
    update_fn = ops.make_sjpc_update_fn()

    step = torch.zeros((), dtype=torch.int32, device=device)
    ca, na = st_a.counters[0], st_a.n[0]
    for i in range(0, args.train, CHUNK):                    # stream in batches
        ca, na = monitor_update_local(cfg, params, ca, na,
                                      torch.as_tensor(train_toks[i:i + CHUNK], device=device),
                                      step + i, update_fn=update_fn)
    cb, nb = monitor_update_local(cfg, params, st_b.counters[0], st_b.n[0],
                                  torch.as_tensor(eval_toks, device=device), step,
                                  update_fn=update_fn)

    est = contamination_estimate(cfg, MonitorState(ca[None], na[None], step),
                                 MonitorState(cb[None], nb[None], step))

    ra = np_records_from_tokens(train_toks, D)
    rb = np_records_from_tokens(eval_toks, D)
    true_join = exact.exact_join_g(ra, rb, D)

    print(f"planted contaminated sequences: {args.shared}")
    print(f"exact {D}-similar join size:    {true_join:.0f}")
    print(f"SJPC join estimate:             {est['join'][D]:.0f}")
    print(f"relative error:                 "
          f"{abs(est['join'][D] - true_join) / true_join:.3f}")
    print("\nper-level join estimates:", {D - i: f"{v:.0f}" for i, v in
                                          enumerate(reversed(est['per_level_pairs']))})
    return {"exact": float(true_join), "estimate": float(est["join"][D])}


if __name__ == "__main__":
    main()
