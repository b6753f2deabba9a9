"""Scale-out harness: 1/2/4-worker clusters vs the single-process oracle,
ported from the JAX package's ``distributed/harness.py``.

Two jobs:

* **Benchmark** (:func:`run_scaleout`): launch N subprocess workers,
  drive identical ingest through the coordinator, hold each run against
  the single-process oracle, and report aggregate ingest records/s,
  merge latency p50/p95 and replica query-freshness lag per worker
  count.  Worker environments are pinned identically (capped BLAS/OMP
  threads) so the scaling ratio measures sharding, not accidental
  thread-count differences.  Every worker process uses the same CUDA
  card unless the spec names the CPU.  The CLI runs it over the
  scale-out workload (:func:`scaleout_spec`, :func:`scaleout_batches`).

* **Smoke/correctness** (:func:`run_smoke`): a 2-worker cluster over a
  small geometry whose coordinator estimates must match a single-process
  oracle run -- bit-exact replica counters for linear kinds, |Δ|/max ≤
  1e-6 on every estimate.

Determinism contract: tenant uids are pinned globally (spec declaration
order), per-stream record sequences are identical, and the harness
flushes on the same per-cycle boundaries in both runs, so the per-
(stream, round) ingest PRNG grid -- and therefore every sketch -- is
reproduced exactly regardless of which process ingested the records.
Tenant names are salted at spec-build time so ``crc32 % 4`` (and hence
``% 2``) is perfectly balanced.

    python -m repro_torch.distributed.harness --smoke [--local] [--cpu]
    python -m repro_torch.distributed.harness --workers 1,2,4
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

from ..configs.sjpc_paper import PAPER_DEFAULTS
from ..data.synthetic import shingle_records
from .coordinator import ClusterSpec, Coordinator, LocalWorker, SubprocessWorker

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# threads pinned identically for every worker count: the scale-out ratio
# must come from sharding, not from 1-worker runs grabbing more BLAS/OMP
# threads than 4-worker runs
_THREAD_CAPS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                "MKL_NUM_THREADS": "1"}


def worker_env() -> dict:
    """The pinned child environment: this process's environment with
    capped threads and a PYTHONPATH that reaches ``repro_torch``."""
    env = dict(os.environ)
    env.update(_THREAD_CAPS)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _salted(i: int, want: int) -> str:
    """A tenant name whose crc32 lands in shard ``want`` mod 4 (balanced
    for 2- and 4-worker clusters alike)."""
    salt = 0
    while True:
        name = f"tenant-{i:02d}x{salt}"
        if zlib.crc32(name.encode()) % 4 == want:
            return name
        salt += 1


def make_spec(n_tenants: int = 8, *, kinds=("sjpc",), d: int = 6, s: int = 4,
              width: int = 1024, depth: int = 3, seed: int = 11,
              window_epochs: int = 4, backing_epochs: int = 0,
              batch_rows: int = 256, device: str | None = None) -> ClusterSpec:
    """A balanced cluster spec: ``n_tenants`` streams cycling through
    ``kinds``, names salted so every worker count shards them evenly.
    ``device`` is the service's device as a string (``"cpu"``); None
    leaves it out, which is the CUDA card."""
    from ..core.sjpc import SJPCConfig
    streams = []
    for i in range(n_tenants):
        kind = kinds[i % len(kinds)]
        st = {"name": _salted(i, i % 4), "group": "g",
              "window_epochs": window_epochs, "estimator": kind}
        if backing_epochs and kind != "sjpc":
            st["backing_epochs"] = backing_epochs
        streams.append(st)
    service = {"batch_rows": batch_rows, "window_epochs": window_epochs}
    if device is not None:
        service["device"] = str(device)
    return ClusterSpec(
        groups=(("g", SJPCConfig(d=d, s=s, ratio=0.5, width=width,
                                 depth=depth, seed=seed)),),
        streams=tuple(streams), service=service)


def make_batches(spec: ClusterSpec, *, cycles: int, rows_per_cycle: int,
                 vocab: int = 400, seed: int = 0) -> dict:
    """Per-tenant record batches, one array per (tenant, cycle).  The
    same dict feeds the oracle and every cluster size, so the per-stream
    sequences -- and the PRNG round grid -- are identical everywhere."""
    d = spec.groups[0][1].d
    rng = np.random.default_rng(seed)
    return {s["name"]: [rng.integers(0, vocab, size=(rows_per_cycle, d),
                                     dtype=np.uint32) for _ in range(cycles)]
            for s in spec.streams}


# The scale-out workload: the paper's DBLPtitles group (configs/sjpc_paper:
# d=6, s=3, r=0.5, w=1024, t=3) in one hash group over 64 tenants, kinds
# cycling six SJPC to one reservoir and one LSH-SS (48, 8 and 8; the sample
# kinds with two backing epochs), rounds of 512 over a 4-epoch window.  Each
# tenant gets 4,096 shingle_records a cycle, seeded by (tenant, cycle), with
# near-duplicate groups of 6 rows; 6 cycles, 1,572,864 records in all.
SCALEOUT_TENANTS = 64
SCALEOUT_KINDS = ("sjpc",) * 6 + ("reservoir", "lsh_ss")
SCALEOUT_ROWS = 4096
SCALEOUT_BATCH_ROWS = 512
SCALEOUT_WINDOW = 4
SCALEOUT_BACKING = 2
SCALEOUT_CYCLES = 6
SCALEOUT_SEED = 2121
SCALEOUT_DUPS = ((3, 0.15), (4, 0.08), (5, 0.05), (6, 0.03))


def scaleout_spec(device: str | None = None) -> ClusterSpec:
    """The scale-out workload's cluster spec on ``device`` (None: the
    CUDA card)."""
    p = PAPER_DEFAULTS
    return make_spec(SCALEOUT_TENANTS, kinds=SCALEOUT_KINDS, d=p.d, s=p.s,
                     width=p.width, depth=p.depth, seed=p.seed,
                     window_epochs=SCALEOUT_WINDOW,
                     backing_epochs=SCALEOUT_BACKING,
                     batch_rows=SCALEOUT_BATCH_ROWS, device=device)


def scaleout_records(uid: int, cycle: int) -> np.ndarray:
    """Tenant ``uid``'s records of one cycle of the scale-out workload."""
    return shingle_records(SCALEOUT_ROWS, d=PAPER_DEFAULTS.d,
                           seed=(SCALEOUT_SEED, uid, cycle), group=6,
                           dup_profile=SCALEOUT_DUPS)


def scaleout_batches(spec: ClusterSpec) -> dict:
    """Every tenant's scale-out records, one array per (tenant, cycle)."""
    return {st["name"]: [scaleout_records(uid, c) for c in range(SCALEOUT_CYCLES)]
            for uid, st in enumerate(spec.streams)}


# -- the oracle -------------------------------------------------------------

def run_oracle(spec: ClusterSpec, batches: dict, *, cycles: int):
    """The single-process reference: same topology (dense uids ==
    declaration order == the cluster's pinned uids), same records, same
    flush and epoch boundaries, on the spec's device."""
    from ..obs import Observability
    from ..service import EstimationService, ServiceConfig
    svc = EstimationService(ServiceConfig(**spec.service),
                            obs=Observability.disabled())
    for gid, cfg in spec.groups:
        svc.create_group(gid, cfg)
    for st in spec.streams:
        kwargs = {k: st[k] for k in
                  ("window_epochs", "estimator", "backing_epochs")
                  if k in st}
        svc.create_stream(st["name"], st["group"], **kwargs)
    for c in range(cycles):
        for st in spec.streams:
            svc.ingest(st["name"], batches[st["name"]][c])
        svc.flush()
        svc.advance_epoch()
    return svc


# -- cluster runs -----------------------------------------------------------

@dataclasses.dataclass
class ClusterRun:
    n_workers: int
    records: int
    ingest_s: float              # route + flush + merge wall time
    rec_per_s: float
    merge_p50_s: float
    merge_p95_s: float
    freshness_p50_s: float
    freshness_p95_s: float
    sync_trace: list             # per-cycle {"cycle", "sync_s", "deltas"}
    coordinator: Coordinator


def run_cluster(spec: ClusterSpec, batches: dict, *, n_workers: int,
                cycles: int, local: bool = False,
                keep_open: bool = False) -> ClusterRun:
    """Drive one cluster through ``cycles`` ingest/sync/advance rounds.
    ``local=True`` uses in-process workers (full protocol bytes, no
    subprocess startup); otherwise each worker is a child process with a
    pinned environment."""
    if local:
        workers = [LocalWorker() for _ in range(n_workers)]
    else:
        env = worker_env()
        workers = [SubprocessWorker(env=env) for _ in range(n_workers)]
    coord = Coordinator(spec, workers)
    # first-use costs (kernel loading, allocator growth) land inside cycle
    # 0 on every worker -- they overlap across workers (send-all-then-
    # recv-all broadcasts), so the wall clock charges each cluster size
    # comparably
    records = 0
    trace = []
    t0 = time.perf_counter()
    for c in range(cycles):
        for st in spec.streams:
            records += coord.ingest(st["name"], batches[st["name"]][c])
        ts = time.perf_counter()
        stats = coord.sync()
        trace.append({"cycle": c, "sync_s": time.perf_counter() - ts,
                      "deltas": stats["deltas"],
                      "heartbeats": stats["heartbeats"]})
        coord.advance_epoch()
    wall = time.perf_counter() - t0
    m = coord.obs.metrics
    run = ClusterRun(
        n_workers=n_workers, records=records, ingest_s=wall,
        rec_per_s=records / wall if wall > 0 else 0.0,
        merge_p50_s=_hist_quantile(m, "coordinator_merge_seconds", 0.50),
        merge_p95_s=_hist_quantile(m, "coordinator_merge_seconds", 0.95),
        freshness_p50_s=m.quantile("coordinator_freshness_lag_seconds", 0.50),
        freshness_p95_s=m.quantile("coordinator_freshness_lag_seconds", 0.95),
        sync_trace=trace, coordinator=coord)
    if not keep_open:
        coord.close()
    return run


def _hist_quantile(m, name: str, q: float) -> float:
    """Worst worker's quantile (the family is labeled ``worker=<i>``)."""
    hists = getattr(m, "_hists", {}).get(name, {})
    vals = [h.quantile(q) for h in hists.values()]
    return max(vals) if vals else 0.0


# -- correctness ------------------------------------------------------------

def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def compare_to_oracle(coord: Coordinator, oracle, spec: ClusterSpec) -> dict:
    """Replica-vs-oracle agreement: bit-exact counters/n for linear
    kinds, every leaf of the window state for sample kinds, and the worst
    relative estimate gap across all tenants and kinds."""
    replica = coord.replicas[0]
    worst = 0.0
    linear_exact = True
    for st in spec.streams:
        name = st["name"]
        rw = replica.registry.stream(name)
        ow = oracle.registry.stream(name)
        if rw.window.spec.linear:
            a, b = rw.window.total, ow.window.total
            # step is worker-local PRNG history: the replica mirrors data
            # (counters, n), not the fold count
            if not (np.array_equal(_host(a.counters), _host(b.counters))
                    and np.array_equal(_host(a.n), _host(b.n))):
                linear_exact = False
        else:
            for la, lb in zip(rw.window.window_state(), ow.window.window_state()):
                if not np.array_equal(_host(la), _host(lb)):
                    linear_exact = False
        est_c = coord.self_join(name).estimate
        est_o = oracle.snapshot([name]).self_join(name).estimate
        denom = max(abs(est_o), 1.0)
        worst = max(worst, abs(est_c - est_o) / denom)
    return {"linear_exact": linear_exact, "worst_rel_err": worst}


def run_smoke(out_path: str | None = None, *, local: bool = False,
              device: str | None = None) -> dict:
    """The smoke run: a 2-worker cluster (subprocess by default) over a
    small mixed-kind geometry; raises unless coordinator == oracle, and
    writes the report with its merge-latency trace to ``out_path``."""
    spec = make_spec(4, kinds=("sjpc", "reservoir"), width=256, depth=2,
                     window_epochs=3, batch_rows=64, device=device)
    cycles = 4
    batches = make_batches(spec, cycles=cycles, rows_per_cycle=128, seed=3)
    run = run_cluster(spec, batches, n_workers=2, cycles=cycles,
                      local=local, keep_open=True)
    try:
        oracle = run_oracle(spec, batches, cycles=cycles)
        agree = compare_to_oracle(run.coordinator, oracle, spec)
    finally:
        run.coordinator.close()
    report = {
        "workers": 2, "records": run.records,
        "device": spec.service.get("device", "cuda"),
        "rec_per_s": run.rec_per_s,
        "merge_p50_s": run.merge_p50_s, "merge_p95_s": run.merge_p95_s,
        "freshness_p95_s": run.freshness_p95_s,
        "sync_trace": run.sync_trace, **agree,
    }
    if not agree["linear_exact"]:
        raise RuntimeError("replica state diverged from the oracle")
    if agree["worst_rel_err"] > 1e-6:
        raise RuntimeError(f"coordinator estimates diverged: {agree['worst_rel_err']:.3e}")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"smoke report -> {out_path}")
    return report


def run_scaleout(spec: ClusterSpec, batches: dict, oracle,
                 worker_counts=(1, 2, 4), *, cycles: int) -> dict:
    """The same workload through 1/2/4 subprocess-worker clusters, each
    held against ``oracle`` (a :func:`run_oracle` service of the same spec
    and batches): a run that does not match raises.  Rows keyed
    ``workers_{N}`` carry ``compare_to_oracle``'s fields, the speedup over
    the first count and each cycle's sync seconds (every worker's flush,
    export and the merge)."""
    out = {}
    base = None
    for n in worker_counts:
        run = run_cluster(spec, batches, n_workers=n, cycles=cycles,
                          keep_open=True)
        try:
            agree = compare_to_oracle(run.coordinator, oracle, spec)
        finally:
            run.coordinator.close()
        if not agree["linear_exact"] or agree["worst_rel_err"] > 1e-6:
            raise RuntimeError(f"{n}-worker cluster diverged from the oracle: {agree}")
        if base is None:
            base = run.rec_per_s
        out[f"workers_{n}"] = {
            "workers": n, "records": run.records,
            "ingest_s": run.ingest_s, "rec_per_s": run.rec_per_s,
            "speedup_vs_1w": run.rec_per_s / base if base else 0.0,
            "merge_p50_s": run.merge_p50_s, "merge_p95_s": run.merge_p95_s,
            "freshness_p50_s": run.freshness_p50_s,
            "freshness_p95_s": run.freshness_p95_s,
            "sync_s": [t["sync_s"] for t in run.sync_trace], **agree,
        }
        print(f"workers={n}: {run.rec_per_s:,.0f} rec/s "
              f"(x{out[f'workers_{n}']['speedup_vs_1w']:.2f}), "
              f"merge p95 {run.merge_p95_s * 1e3:.2f} ms, "
              f"freshness p95 {run.freshness_p95_s * 1e3:.1f} ms")
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="2-worker correctness run vs the oracle")
    p.add_argument("--local", action="store_true",
                   help="in-process workers (no subprocesses)")
    p.add_argument("--cpu", action="store_true",
                   help="services on the CPU (default: the CUDA card)")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--workers", default="1,2,4",
                   help="scale-out worker counts (comma-separated) over the "
                        "scale-out workload, each held against the oracle")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.smoke:
        run_smoke(args.out, local=args.local, device=device)
        return 0
    counts = tuple(int(x) for x in args.workers.split(","))
    spec = scaleout_spec(device)
    batches = scaleout_batches(spec)
    oracle = run_oracle(spec, batches, cycles=SCALEOUT_CYCLES)
    rows = run_scaleout(spec, batches, oracle, counts, cycles=SCALEOUT_CYCLES)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
