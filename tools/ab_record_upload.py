"""A/B on one CUDA card: how ``sjpc.update_fused`` uploads a numpy batch.

A: the records go up as int64 (numpy widens them on the host, 8 B per
   value), as ``core.hashing.as_field_tensor`` uploaded them before.
B: the records go up as their 4-byte words (the uint32 bits in an int32
   array) and are widened to int64 on the card, as ``as_field_tensor``
   uploads them now.

Both give the same int64 tensor on the card; the ``fused_ingest`` wrapper
narrows it to the kernel's words either way.  The SJPC stream's own
shapes: the paper's defaults (d=6, s=3, r=0.5, w=1024, t=3), batches of
65,536 ``shingle_records``.  Each side is swapped into ``sjpc`` in turn,
for PAIRS pairs whose order alternates (A then B, then B then A); one
measurement is the mean milliseconds per call of CALLS ``update_fused``
calls over distinct batches, host clock around synchronised work.  Prints
each side's median and interquartile range, B's wins, and a JSON line.

    python3 tools/ab_record_upload.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import sjpc  # noqa: E402
from repro_torch.core.hashing import as_field_tensor as upload_words  # noqa: E402
from repro_torch.data.synthetic import shingle_records  # noqa: E402

BATCH = 65536
BATCHES = 16
CALLS = 32
PAIRS = 12


def upload_int64(values, device) -> torch.Tensor:
    arr = np.asarray(values).astype(np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def per_call_ms(upload, cfg, params, state, batches) -> float:
    sjpc.as_field_tensor = upload
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CALLS):
        state = sjpc.update_fused(cfg, params, state, batches[i % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_record_upload: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = sjpc.SJPCConfig(d=6, s=3, ratio=0.5, width=1024, depth=3)
    params, state = sjpc.init(cfg, device=device)
    records = shingle_records(BATCH * BATCHES, d=6, seed=1, group=6)
    batches = [records[j * BATCH:(j + 1) * BATCH] for j in range(BATCHES)]
    want = upload_int64(batches[0], device)
    assert torch.equal(upload_words(batches[0], device), want)
    kept = sjpc.as_field_tensor
    try:
        for upload in (upload_int64, upload_words):   # warm both
            per_call_ms(upload, cfg, params, state, batches)
        a, b = [], []
        for pair in range(PAIRS):
            order = ((a, upload_int64), (b, upload_words))
            for out, upload in (order if pair % 2 == 0 else order[::-1]):
                out.append(per_call_ms(upload, cfg, params, state, batches))
    finally:
        sjpc.as_field_tensor = kept
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    wins = sum(y < x for x, y in zip(a, b))
    result = {"card": card, "pairs": PAIRS, "calls": CALLS,
              "a_int64_ms": a, "b_words_ms": b,
              "a_median": float(np.median(a)), "b_median": float(np.median(b)),
              "a_iqr": float(np.subtract(*np.percentile(a, [75, 25]))),
              "b_iqr": float(np.subtract(*np.percentile(b, [75, 25]))),
              "b_wins": wins}
    print(f"{card}: update_fused per numpy batch of {BATCH}, ms: A (int64 upload) median "
          f"{result['a_median']:.4f} (IQR {result['a_iqr']:.4f}), B (4-byte words) median "
          f"{result['b_median']:.4f} (IQR {result['b_iqr']:.4f}); B faster in {wins} of "
          f"{PAIRS} pairs")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
