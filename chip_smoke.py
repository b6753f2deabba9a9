#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a and holds each against its plain PyTorch version on the card.  Then
it drives the port's paths at the paper's defaults (d=6, s=3, r=0.5,
w=1024, t=3):

* the SJPC stream: 2^20 records in 16 batches through ``update_fused`` and
  the per-level ``update``, ``estimate_batch`` and ``estimate_join_batch``
  on the stream, and both queries over 1,024 stacked sketches;
* the equal-space estimators (``estimators`` phase): SJPC, reservoir and
  LSH-SS, each at its own factory's size, over 64 streams of 16 rounds of
  4,096 records (the unfused SJPC path on 8 of them), the window algebra,
  ``estimate_batch`` with bootstrap error bars over the 64 streams and over
  1,024 tenants, and the per-stream level F2 through ``sketch_moments``.

Every result of a kernel path is compared with the same computation
through the plain versions on the card (``impl="torch_ref"``); LSH-SS,
which launches no kernel, is held against its ``estimate_ref``.  The launch
counts and ``kernel_dispatch_total`` show that every kernel call of those
paths ran the hand-written kernel.  Prints a ``{"kernels": [...]}`` line
with each kernel's launches, times and bound, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero; it exits 2 and prints no result without a CUDA device.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import estimators as E  # noqa: E402
from repro_torch.configs.sjpc_paper import PAPER_DEFAULTS  # noqa: E402
from repro_torch.core import exact, sjpc  # noqa: E402
from repro_torch.core import projections as proj  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.hashing import P31, as_field_tensor  # noqa: E402
from repro_torch.data.synthetic import shingle_records  # noqa: E402
from repro_torch.kernels import _build, ops, ref, registry  # noqa: E402
from repro_torch.kernels import fingerprint as kfp  # noqa: E402
from repro_torch.kernels import fused_ingest as kfi  # noqa: E402
from repro_torch.kernels import fused_pairs as kpairs  # noqa: E402
from repro_torch.kernels import fused_query as kfq  # noqa: E402
from repro_torch.kernels import sketch_moments as ksm  # noqa: E402
from repro_torch.kernels import sketch_update as ksu  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.service.ingest import ingest_key_grid  # noqa: E402

# Peak rates of one H100 SXM (NVIDIA data sheet and Hopper white paper):
# HBM3 bandwidth, and 32-bit integer operations on the CUDA cores
# (132 SMs x 64 INT32 lanes x 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# A field element (record column, mask, id, base, hash coefficient,
# fingerprint) is a uint32 in the functions the kernels compute.
FIELD_BYTES = 4
# Spin cycles per second of sleep: at least the SM clock, so that a spin
# lasts at least as long as asked.
SLEEP_CYCLES_PER_S = 2.0e9
# Written between timed calls to evict the 50 MB L2.
L2_FLUSH_BYTES = 256 << 20

RECORDS = 1 << 20
BATCH = 1 << 16
TENANTS = 1024
QUICKSTART_DUPS = ((3, 0.15), (4, 0.08), (5, 0.05), (6, 0.03))

# The estimators phase: S streams, each R rounds of B rows.
EST_STREAMS = 64
EST_ROUNDS = 16
EST_ROWS = 4096
UNFUSED_STREAMS = 8     # streams also ingested through the unfused SJPC path
EXACT_STREAMS = 8       # streams whose exact g_s the paper comparison uses
REF_STREAMS = 4         # streams held against each kind's estimate_ref
KINDS = ("sjpc", "reservoir", "lsh_ss")
# the kinds whose ingest and query launch kernels; LSH-SS is host and plain
# PyTorch code with no kernel, so its plain path would be the same code
KERNEL_KINDS = ("sjpc", "reservoir")

KERNELS = {"fused_ingest": kfi, "fingerprint": kfp, "fused_query": kfq,
           "fused_pairs": kpairs, "sketch_update": ksu, "sketch_moments": ksm}
REPLACES = {"fused_ingest": "src/repro/kernels/fused_ingest.py:85",
            "fingerprint": "src/repro/kernels/fingerprint.py:41",
            "fused_query": "src/repro/kernels/fused_query.py:54",
            "fused_pairs": "src/repro/kernels/fused_pairs.py:85",
            "sketch_update": "src/repro/kernels/sketch_update.py:60",
            "sketch_moments": "src/repro/kernels/sketch_moments.py:34"}
# The (N, R, d) fused_pairs shapes of the JAX package's kernel tests
# (tests/kernel_cases.py PAIRS_SHAPES).
PAIRS_SHAPES = [(1, 1, 3), (1, 7, 3), (2, 64, 5), (1, 130, 6), (3, 33, 4), (1, 256, 2)]


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def same_state(a, b) -> bool:
    return type(a) is type(b) and all(equal(x, y) for x, y in zip(a, b))


def same_table(a, b) -> bool:
    return a.stderr_kind == b.stderr_kind and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("x", "g", "y", "n", "stderr", "stderr_offline"))


@contextlib.contextmanager
def oracle_calls():
    """Calls that compute the plain reference on the card: their kernel
    dispatches are not the path's, so they count into a disabled metrics
    registry."""
    prev = metrics.set_default_registry(metrics.MetricsRegistry(enabled=False))
    try:
        yield
    finally:
        metrics.set_default_registry(prev)


def synced_s(fn):
    """Host seconds of ``fn()`` from a synchronised start to a synchronised
    end, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def wall_ms(*fns, reps: int = 9) -> list[float]:
    """Median milliseconds of one call of each of ``fns`` between two CUDA
    events, the host's work inside included: the time of a step as its
    caller sees it.  The functions take turns, so that host noise falls on
    all of them alike."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop))
    return [float(np.median(out)) for out in times]


def device_ms(fn, calls: int, flush: torch.Tensor) -> tuple[float, float]:
    """Median device milliseconds of one ``fn()``, and the host's
    milliseconds per call.

    Each call runs between its own pair of CUDA events, after a write of
    ``flush`` that evicts L2, so that every call finds its inputs cold, as
    a query or a batch finds them.  A spin kernel holds the card while the
    host queues all the calls, so the events time the card's work alone,
    not the wrapper's checks and launch overhead between calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        flush.zero_()
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(calls)]
    torch.cuda._sleep(int(min(2 * host_s + 1e-3, 2.0) * SLEEP_CYCLES_PER_S))
    for start, stop in events:
        flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(stop) for start, stop in events]
    return float(np.median(times)), host_s / calls * 1e3


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth or integer
    operations over the INT32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def ingest_case(rng, device, batch, d, s, width, depth, zero_weights=False):
    """Padded-lattice fused_ingest arguments: random records and counters,
    {0,1} weights that are 0 in the padded slots."""
    cfg = sjpc.SJPCConfig(d=d, s=s, width=width, depth=depth, seed=int(rng.integers(1 << 16)))
    params, _ = sjpc.init(cfg, device=device)
    pad = proj.padded_lattice(d, s)
    weights = rng.integers(0, 2, size=(batch, pad.num_levels, pad.m_max)) * pad.valid[None]
    if zero_weights:
        weights[:] = 0

    def t64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    counters = rng.integers(-9, 9, size=(pad.num_levels, depth, width)).astype(np.int32)
    return (torch.from_numpy(counters).to(device),
            t64(rng.integers(0, 2**32, size=(batch, d), dtype=np.uint32)),
            t64(pad.masks), t64(pad.ids), params.fp_bases, params.bucket_coeffs,
            params.sign_coeffs, torch.from_numpy(weights.astype(np.int32)).to(device))


def counter_stack(rng, device, shape, magnitude):
    return torch.from_numpy(
        rng.integers(-magnitude, magnitude, size=shape).astype(np.int32)).to(device)


def pairs_case(rng, device, N, R, d, vocab=5, p_valid=0.8):
    """fused_pairs arguments: items (N, R, d) from a small vocabulary (so
    that pairs agree on some columns), valid (N, R)."""
    items = rng.integers(0, vocab, size=(N, R, d), dtype=np.uint64).astype(np.int64)
    valid = (rng.random((N, R)) < p_valid).astype(np.int32)
    return torch.from_numpy(items).to(device), torch.from_numpy(valid).to(device)


def sketch_update_case(rng, device, n, t, w, zero_weights=False):
    """sketch_update arguments: random counters, keys and weights."""
    params = sk.make_sketch_params(rng, t, device=device)
    fp1, fp2 = (torch.from_numpy(rng.integers(0, P31, size=n).astype(np.int64)).to(device)
                for _ in range(2))
    weights = np.zeros(n, np.int32) if zero_weights else rng.integers(-2, 3, size=n)
    return (counter_stack(rng, device, (t, w), 9), fp1, fp2, params.bucket_coeffs,
            params.sign_coeffs, torch.from_numpy(weights.astype(np.int32)).to(device))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> float:
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, path in paths.items():
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(paths)} kernels in {seconds:.1f} s")
    return seconds


def phase_kernels(device) -> None:
    """Each kernel against its plain version, bit-exact, at the main
    path's shapes and at edge shapes."""
    rng = np.random.default_rng(2024)
    n_checks = 0
    for batch in (1, 1000, BATCH):
        args = ingest_case(rng, device, batch, 6, 3, 1024, 3)
        values, masks, ids, bases = args[1], args[2], args[3], args[4]
        for lvl in range(masks.shape[0]):
            m = proj.padded_lattice(6, 3).nums[lvl]
            fargs = (values, masks[lvl, :m].contiguous(), ids[lvl, :m].contiguous(), bases)
            got, want = kfp.fingerprint(*fargs), ref.fingerprint_ref(*fargs)
            require(equal(got[0], want[0]) and equal(got[1], want[1]),
                    f"fingerprint B={batch} level={lvl}")
            n_checks += 1
    ingest_shapes = [(b, w, t) for b in (1, 777) for w in (64, 1024, 65536)
                     for t in (1, 2, 3, 5)]
    ingest_shapes += [(BATCH, 1024, 3), (BATCH, 65536, 5), (4099, 1024, 2)]
    for batch, width, depth in ingest_shapes:
        args = ingest_case(rng, device, batch, 6, 3, width, depth)
        require(equal(kfi.fused_ingest(*args), ref.fused_ingest_ref(*args)),
                f"fused_ingest B={batch} w={width} t={depth}")
        n_checks += 1
    args = ingest_case(rng, device, BATCH, 6, 3, 1024, 3, zero_weights=True)
    got = kfi.fused_ingest(*args)
    require(equal(got, ref.fused_ingest_ref(*args)) and equal(got, args[0]),
            "fused_ingest all-zero weights")
    n_checks += 1
    query_shapes = [(3, 4, t, w) for t in (1, 2, 3, 5) for w in (64, 1024, 65536)]
    query_shapes += [(1, 4, 3, 1024), (TENANTS, 4, 3, 1024)]
    for shape in query_shapes:
        for magnitude in (60, 1 << 20):
            a = counter_stack(rng, device, shape, magnitude)
            b = counter_stack(rng, device, shape, magnitude)
            require(equal(kfq.fused_query(a, b), ref.fused_query_ref(a, b)),
                    f"fused_query {shape} |c|<{magnitude}")
            require(equal(kfq.fused_query(a, a), ref.fused_query_ref(a, a)),
                    f"fused_query F2 {shape} |c|<{magnitude}")
            n_checks += 2
    zeros = counter_stack(rng, device, (2, 4, 3, 1024), 1) * 0
    require(equal(kfq.fused_query(zeros, zeros), ref.fused_query_ref(zeros, zeros)),
            "fused_query zeros")
    n_checks += 1
    n_checks += check_pairs_grid(rng, device)
    n_checks += check_sketch_update_grid(rng, device)
    n_checks += check_sketch_moments_grid(rng, device)
    log(f"kernels: {n_checks} kernel-vs-plain checks bit-exact")


def check_pairs_grid(rng, device) -> int:
    """fused_pairs against its plain version: the JAX tests' shapes, the
    reservoir sizes, the empty and duplicate edges, stacked leading dims."""
    cases = [pairs_case(rng, device, N, R, d) for N, R, d in PAIRS_SHAPES]
    cases += [pairs_case(rng, device, N, R, 6) for N in (1, 3, 1024)
              for R in (1, 2, 127, 128, 129, 1755, 2633)]
    cases += [pairs_case(rng, device, 5, 200, d) for d in (1, 7, 8, 15, 16)]
    cases.append(pairs_case(rng, device, 4, 300, 6, vocab=2**32))      # distinct records
    items, _ = pairs_case(rng, device, 2, 140, 6)
    cases.append((items, torch.zeros((2, 140), dtype=torch.int32, device=device)))
    one = torch.zeros((2, 140), dtype=torch.int32, device=device)
    one[:, 77] = 1
    cases.append((items, one))                                         # a single valid slot
    dup = torch.full((3, 300, 6), 7, dtype=torch.int64, device=device)
    cases.append((dup, torch.ones((3, 300), dtype=torch.int32, device=device)))
    for items, valid in cases:
        got, want = kpairs.fused_pairs(items, valid), ref.fused_pairs_ref(items, valid)
        require(equal(got, want), f"fused_pairs {tuple(items.shape)}")
    m = (valid != 0).sum(dim=1)
    require(bool((want[:, 6] == m * (m - 1)).all()), "fused_pairs duplicates: all pairs at d")
    for items, valid in cases[-3:-1]:
        require(int(ref.fused_pairs_ref(items, valid).sum()) == 0,
                "fused_pairs: no valid pair, no count")
    items, valid = pairs_case(rng, device, 8 * 32, 256, 6)
    got = ops.fused_pairs(items.reshape(8, 32, 256, 6), valid.reshape(8, 32, 256))
    require(equal(got, ref.fused_pairs_ref(items, valid).reshape(8, 32, 7)),
            "fused_pairs leading dims (N, B)")
    return len(cases) + 1


def check_sketch_update_grid(rng, device) -> int:
    n_checks = 0
    for w in (64, 1024, 65536):
        for t in (1, 2, 3, 5):
            for n in (1, 777, 4096 * 42):
                args = sketch_update_case(rng, device, n, t, w)
                require(equal(ksu.sketch_update(*args), ref.sketch_update_ref(*args)),
                        f"sketch_update n={n} t={t} w={w}")
                n_checks += 1
    args = sketch_update_case(rng, device, 4096 * 42, 3, 1024, zero_weights=True)
    got = ksu.sketch_update(*args)
    require(equal(got, ref.sketch_update_ref(*args)) and equal(got, args[0]),
            "sketch_update all-zero weights")
    return n_checks + 1


def check_sketch_moments_grid(rng, device) -> int:
    """Bit-exact against the plain version; against the int64 oracle exact
    below 2^24 and within 1e-6 (relative) above it."""
    n_checks = 0
    for t in (1, 3, 5):
        for w in (64, 1024, 65536):
            for magnitude in (60, 1 << 20):
                a = counter_stack(rng, device, (t, w), magnitude)
                b = counter_stack(rng, device, (t, w), magnitude)
                for x, y in ((a, b), (a, a)):
                    got = ksm.sketch_moments(x, y)
                    require(equal(got, ref.sketch_moments_ref(x, y)),
                            f"sketch_moments t={t} w={w} |c|<{magnitude}")
                    oracle = (x.to(torch.int64) * y.to(torch.int64)).sum(dim=-1).double()
                    err = ((got.double() - oracle).abs() / oracle.abs().clamp_min(1.0)).max()
                    require(float(err) <= 1e-6, f"sketch_moments vs int64 oracle: {err}")
                    small = oracle.abs() < 2**24
                    require(bool((got.double() == oracle)[small].all()),
                            "sketch_moments below 2^24 is exact")
                    n_checks += 1
    return n_checks


def plain_update_fused(cfg, params, state, values):
    """``update_fused`` with the kernel replaced by its plain version, the
    same keys: the reference the stream is held against."""
    args, B, row_mask = sjpc.fused_ingest_args(cfg, params, state, values)
    return sjpc.advance(state, ref.fused_ingest_ref(*args), B, row_mask)


def plain_estimate(cfg, counters_a, counters_b, n, join):
    moments = ref.fused_query_ref(counters_a, counters_b)
    return sjpc.estimate_from_moments(cfg, moments, n, clamp=True, join=join)


def check_batch_estimate(cfg, got, counters_a, counters_b, n, join, what):
    """The batched estimate against the same query through the plain
    moments: y, x and g bit-equal (the same float32 ops on the card)."""
    y, x, g = (t.cpu().numpy().astype(np.float64)
               for t in plain_estimate(cfg, counters_a, counters_b,
                                       torch.as_tensor(n, dtype=torch.float32,
                                                       device=counters_a.device), join))
    for name, a, b in (("y", got.y, y), ("x", got.x, x), ("g", got.g, g)):
        require(np.array_equal(a, b), f"{what}: {name} differs from the plain path")
        require(bool(np.isfinite(a).all()), f"{what}: {name} not finite")


def exact_join_g(a: np.ndarray, b: np.ndarray, s: int) -> np.ndarray:
    """Exact similarity join sizes at thresholds s..d: level-k cross
    join sizes by grouping, then the Eq. 7 inversion at r = 1."""
    d = a.shape[1]
    y = np.zeros(d + 1)
    for k in range(s, d + 1):
        for cols in itertools.combinations(range(d), k):
            both = np.ascontiguousarray(np.concatenate([a[:, list(cols)], b[:, list(cols)]]))
            _, inv = np.unique(both.view([("", both.dtype)] * k).ravel(), return_inverse=True)
            ca = np.bincount(inv[:len(a)], minlength=inv.max() + 1)
            cb = np.bincount(inv[len(a):], minlength=inv.max() + 1)
            y[k] += float((ca.astype(np.int64) * cb).sum())
    x = np.zeros(d + 1)
    for k in range(d, s - 1, -1):
        x[k] = y[k] - sum(math.comb(j, k) * x[j] for j in range(k + 1, d + 1))
    return np.array([x[k:].sum() for k in range(s, d + 1)])


def phase_stream(device, records):
    """The paper-default stream through the main path, held against the
    plain path on the card; returns the per-batch delta sketches."""
    cfg = PAPER_DEFAULTS
    params, state = sjpc.init(cfg, device=device)
    plain, per_level = state, state
    n_batches = len(records) // BATCH
    deltas, ns = [], []
    ingest_s = 0.0
    half = None
    for j in range(n_batches):
        batch = records[j * BATCH:(j + 1) * BATCH]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = sjpc.update_fused(cfg, params, state, batch)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        deltas.append(new.counters - state.counters)
        ns.append(float(new.n - state.n))
        state = new
        plain = plain_update_fused(cfg, params, plain, batch)
        per_level = sjpc.update(cfg, params, per_level, batch)
        if j == n_batches // 2 - 1:
            half = state
    require(equal(state.counters, plain.counters), "stream counters: kernel != plain path")
    require(equal(state.counters, per_level.counters),
            "stream counters: update_fused != per-level update")
    require(float(state.n) == len(records) and int(state.step) == n_batches, "stream n/step")
    log(f"stream: {len(records)} records in {n_batches} batches of {BATCH}; counters "
        f"bit-equal to the plain path and to the per-level update")
    log(f"ingest: {len(records) / ingest_s:.0f} records/s through update_fused "
        f"({ingest_s / n_batches * 1e3:.3f} ms per batch of {BATCH}, host clock)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = sjpc.estimate_batch(cfg, state.counters[None], [float(state.n)])
    query_ms = (time.perf_counter() - t0) * 1e3
    check_batch_estimate(cfg, est, state.counters[None], state.counters[None],
                         [float(state.n)], False, "stream estimate_batch")
    log(f"query: estimate_batch of 1 stream {query_ms:.3f} ms (host clock, first call)")
    second = sjpc.subtract(state, half)
    ca, cb = half.counters[None], second.counters[None]
    join = sjpc.estimate_join_batch(cfg, ca, cb, [float(half.n)], [float(second.n)])
    check_batch_estimate(cfg, join, ca, cb, [float(half.n)], True, "stream join")

    x_true = exact.exact_pair_counts(records)
    n = len(records)
    for i, s in enumerate(range(cfg.s, cfg.d + 1)):
        g_true = float(x_true[s:].sum() + n)
        log(f"self-join s={s}: estimate {est.g[0, i]:.0f} exact {g_true:.0f} "
            f"rel err {abs(est.g[0, i] - g_true) / g_true:.4f} "
            f"(stderr {est.stderr[0, i]:.0f})")
    split = len(records) // 2
    j_true = exact_join_g(records[:split], records[split:], cfg.s)
    for i, s in enumerate(range(cfg.s, cfg.d + 1)):
        log(f"join s={s}: estimate {join.g[0, i]:.0f} exact {j_true[i]:.0f} "
            f"rel err {abs(join.g[0, i] - j_true[i]) / max(j_true[i], 1.0):.4f}")
    return cfg, params, deltas, ns


def tenant_stack(deltas, ns):
    """1,024 distinct real sketches: tenant i holds the union of the stream
    batches whose bit is set in i + 1 (sketches add)."""
    device = deltas[0].device
    bits = torch.tensor([[(i + 1) >> j & 1 for j in range(len(deltas))]
                         for i in range(TENANTS)], dtype=torch.int32, device=device)
    counters = torch.zeros((TENANTS,) + tuple(deltas[0].shape), dtype=torch.int32,
                           device=device)
    for j, delta in enumerate(deltas):
        counters += bits[:, j, None, None, None] * delta[None]
    n = (bits.double().cpu().numpy() @ np.array(ns)).astype(np.float32)
    return counters, n


def phase_tenants(cfg, deltas, ns):
    counters, n = tenant_stack(deltas, ns)
    log(f"tenants: {TENANTS} sketches, {counters.numel() * 4 / 2**20:.1f} MiB of counters")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = sjpc.estimate_batch(cfg, counters, n)
    self_ms = (time.perf_counter() - t0) * 1e3
    check_batch_estimate(cfg, est, counters, counters, n, False, "tenants estimate_batch")
    other = torch.roll(counters, 1, dims=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    join = sjpc.estimate_join_batch(cfg, counters, other, n, np.roll(n, 1))
    join_ms = (time.perf_counter() - t0) * 1e3
    check_batch_estimate(cfg, join, counters, other, n, True, "tenants estimate_join_batch")
    log(f"query: estimate_batch of {TENANTS} sketches {self_ms:.3f} ms, "
        f"estimate_join_batch {join_ms:.3f} ms (host clock, with host-side bounds)")
    return counters


# ---------------------------------------------------------------------------
# the equal-space estimators
# ---------------------------------------------------------------------------

def estimator_records():
    """(R, S, B, d) uint32 rounds and (R, S, B) row masks.  Stream s holds
    ``shingle_records`` of seed 1 + s; its last round is padded with
    64 * (s % 4) masked rows, so the masked path runs.  Also returns each
    stream's valid records."""
    R, S, B, d = EST_ROUNDS, EST_STREAMS, EST_ROWS, 6
    per_stream = np.zeros((S, R * B, d), np.uint32)
    mask = np.ones((R, S, B), np.int32)
    streams = []
    for s in range(S):
        pad = 64 * (s % 4)
        recs = shingle_records(R * B - pad, d=d, seed=1 + s, group=6,
                               dup_profile=QUICKSTART_DUPS)
        per_stream[s, :R * B - pad] = recs
        mask[-1, s, B - pad:] = 0
        streams.append(recs)
    values = np.ascontiguousarray(per_stream.reshape(S, R, B, d).transpose(1, 0, 2, 3))
    return values, mask, streams


def tile_states(states, copies: int):
    """A stack of ``copies`` copies of every stream's state (tenants)."""
    return type(states)(*(leaf.repeat((copies,) + (1,) * (leaf.ndim - 1)) for leaf in states))


def ingest_halves(est, values, mask, keys):
    """The window algebra's inputs: A = rounds [0, R/2) from init (sid 1),
    full = A continued over the rest, B = the rest from init (sid 2);
    then merge(A, B) and subtract(merge, B).  Returns the states and the
    host seconds of the full stream's ingest."""
    S, h = values.shape[1], values.shape[0] // 2
    fresh_a = E.stack_states([est.init(sid=1) for _ in range(S)])
    fresh_b = E.stack_states([est.init(sid=2) for _ in range(S)])
    t_a, a = synced_s(lambda: est.ingest_rounds(fresh_a, values[:h], mask[:h], keys[:h]))
    t_f, full = synced_s(lambda: est.ingest_rounds(a, values[h:], mask[h:], keys[h:]))
    b = est.ingest_rounds(fresh_b, values[h:], mask[h:], keys[h:])
    merged = est.merge(a, b)
    return {"a": a, "full": full, "b": b, "merged": merged,
            "back": est.subtract(merged, b)}, t_a + t_f


def phase_estimators(device, cfg):
    """Every kind at its own factory's equal-space size over 64 streams:
    ingest, the window algebra, queries over 64 streams and 1,024 tenants,
    each held against the same computation through the plain versions."""
    values, mask, streams = estimator_records()
    S, R, B = EST_STREAMS, EST_ROUNDS, EST_ROWS
    n_valid = int(mask.sum())
    dev_values = as_field_tensor(values, device)
    dev_mask = torch.from_numpy(mask).to(device)
    out = {"records": streams}
    ests = {kind: E.make(kind, cfg, device=device) for kind in KINDS}
    for kind, est in ests.items():
        log(f"estimators: {kind} state {est.memory_bytes()} B per stream "
            f"(SJPC counters {cfg.counters_bytes} B)")
    keys = ingest_key_grid(ests["sjpc"].ingest_seed, np.arange(S),
                           np.broadcast_to(np.arange(R)[:, None], (R, S)))
    out["keys"] = keys
    for kind, est in ests.items():
        got, seconds = ingest_halves(est, dev_values, dev_mask, keys)
        if kind in KERNEL_KINDS:
            with oracle_calls():
                plain, _ = ingest_halves(E.make(kind, cfg, device=device,
                                                opts={"impl": "torch_ref"}),
                                         dev_values, dev_mask, keys)
            for name in got:
                require(same_state(got[name], plain[name]),
                        f"{kind} {name} state != plain path")
        full, a, b = got["full"], got["a"], got["b"]
        require(int(full.n.sum()) == n_valid and bool((full.step == R).all()),
                f"{kind}: n / step after {R} rounds")
        require(bool((got["back"].n == a.n).all()), f"{kind}: subtract(merge(A, B), B).n")
        if est.linear:
            require(same_state(got["merged"], full), f"{kind}: merge(A, B) != the full stream")
            require(equal(got["back"].counters, a.counters), f"{kind}: subtract != A")
        else:
            for field in got["back"]._fields:
                if field.endswith("tags"):
                    require(not bool((getattr(got["back"], field) == 2).any()),
                            f"{kind}: {field} keeps the subtracted epoch")
        log(f"ingest {kind}: {n_valid / seconds:.0f} records/s ({n_valid} records, "
            f"{R} rounds x {S} streams x {B} rows, host clock)")
        out[kind] = full

    # the unfused SJPC path (fingerprint + sketch_update kernels) on 8 streams
    u = slice(0, UNFUSED_STREAMS)
    unfused = E.make("sjpc", cfg, device=device, opts={"use_fused": False})
    fresh = E.stack_states([unfused.init() for _ in range(UNFUSED_STREAMS)])
    seconds, got = synced_s(lambda: unfused.ingest_rounds(fresh, dev_values[:, u],
                                                          dev_mask[:, u], keys[:, u]))
    with oracle_calls():
        plain = E.make("sjpc", cfg, device=device,
                       opts={"use_fused": False, "impl": "torch_ref"}).ingest_rounds(
            fresh, dev_values[:, u], dev_mask[:, u], keys[:, u])
    require(same_state(got, plain), "unfused SJPC states != plain path")
    require(same_state(got, E.index_state(out["sjpc"], u)),
            "unfused SJPC counters != fused counters")
    log(f"ingest sjpc unfused: {int(mask[:, u].sum()) / seconds:.0f} records/s on "
        f"{UNFUSED_STREAMS} streams; counters bit-equal to the fused path")

    # queries: 64 streams, then 1,024 tenants (the 64 states x 16)
    tables = {}
    for kind, est in ests.items():
        for label, states in ((f"{S} streams", out[kind]),
                              (f"{TENANTS} tenants", tile_states(out[kind], TENANTS // S))):
            seconds, table = synced_s(lambda: est.estimate_batch(states))
            if kind in KERNEL_KINDS:
                with oracle_calls():
                    plain = est.estimate_batch(states, impl="torch_ref")
                require(same_table(table, plain), f"{kind} {label}: table != plain path")
            require(bool(np.isfinite(table.g).all() and np.isfinite(table.stderr).all()),
                    f"{kind} {label}: table not finite")
            log(f"query {kind} {label}: estimate_batch {seconds * 1e3:.3f} ms "
                f"(host clock, {table.stderr_kind} error bars)")
            tables.setdefault(kind, table)
        if kind != "sjpc":
            for i in range(REF_STREAMS):
                want = est.estimate_ref(E.index_state(out[kind], i))
                for field in ("x", "g", "n", "stderr"):
                    np.testing.assert_allclose(getattr(tables[kind], field)[i:i + 1],
                                               getattr(want, field), rtol=1e-6, atol=1e-6,
                                               err_msg=f"{kind} stream {i} {field} vs ref")
    log(f"estimators: reservoir and lsh_ss tables within 1e-6 of estimate_ref on "
        f"{REF_STREAMS} streams")

    # per-stream level F2 through sketch_moments, against fused_query's rows
    counters = out["sjpc"].counters
    f2 = torch.stack([torch.stack([ops.sketch_moments(counters[s, lvl])
                                   for lvl in range(counters.shape[1])]) for s in range(S)])
    require(equal(f2, ops.fused_query(counters)), "sketch_moments F2 != fused_query rows")
    log(f"level F2: {S * counters.shape[1]} sketch_moments calls equal fused_query's rows")

    # the paper's comparison, printed, not gated
    for i in range(EXACT_STREAMS):
        x = exact.exact_pair_counts(streams[i])
        n = streams[i].shape[0]
        g_true = np.array([x[s:].sum() + n for s in range(cfg.s, cfg.d + 1)])
        errs = {kind: np.abs(tables[kind].g[i] - g_true) / g_true for kind in KINDS}
        log(f"paper comparison stream {i} (g_s, s={cfg.s}..{cfg.d}: "
            f"{' '.join(f'{v:.0f}' for v in g_true)}): rel err "
            + "; ".join(f"{kind} {' '.join(f'{e:.4f}' for e in err)}"
                        for kind, err in errs.items()))
    out["tables"] = tables
    return out


def estimator_kernel_args(device, cfg, params, est_out):
    """The estimator path's shapes for the three kernels it adds:
    fused_pairs over the 1,024-tenant reservoir query, sketch_update of one
    level of one unfused round (stream 0, round 0, level k = s), and
    sketch_moments of one stream's level."""
    tenants = tile_states(est_out["reservoir"], TENANTS // EST_STREAMS)
    valid = (tenants.tags >= 0).to(torch.int32)
    m = valid.sum(dim=1).to(torch.int64)
    N, R, d = tenants.items.shape
    # the histogram is symmetric: d compares per unordered valid pair
    pairs = ((tenants.items, valid), N * R * d * FIELD_BYTES + N * R * 4 + N * (d + 1) * 4,
             d * int((m * (m - 1) // 2).sum()))

    level = proj.lattice(cfg.d, cfg.s)[0]
    values = as_field_tensor(est_out["records"][0][:EST_ROWS], device)
    key = est_out["keys"][0, 0]
    weights = sjpc.sample_level_weights(cfg, key, EST_ROWS, None, device)[0].reshape(-1)
    fp1, fp2 = ref.fingerprint_ref(values, torch.from_numpy(level.masks.astype(np.int64))
                                   .to(device),
                                   torch.from_numpy(level.ids.astype(np.int64)).to(device),
                                   params.fp_bases)
    counters = est_out["sjpc"].counters[0, 0]
    t, w = counters.shape
    n = fp1.numel()
    update = ((counters, fp1.reshape(-1), fp2.reshape(-1), params.bucket_coeffs[0],
               params.sign_coeffs[0], weights.to(torch.int32).contiguous()),
              n * (2 * FIELD_BYTES + 4) + 2 * params.bucket_coeffs[0].numel() * FIELD_BYTES
              + 2 * counters.numel() * 4, 12 * t * int((weights != 0).sum()))
    moments = ((counters, counters), counters.numel() * 4 + t * 4, counters.numel())
    return pairs, update, moments


def phase_numbers(device, cfg, params, records, tenants, by_path, est_out):
    """Kernel, plain-version and library times at the main path's shapes,
    with the bound of each; ``by_path`` holds each path's launches."""
    _, state = sjpc.init(cfg, device=device)
    iargs, B, _ = sjpc.fused_ingest_args(cfg, params, state, records[:BATCH])
    _, values, masks, ids, _, _, _, wpad = iargs
    batch = records[:BATCH]
    update_ms, args_ms = wall_ms(lambda: sjpc.update_fused(cfg, params, state, batch),
                                 lambda: sjpc.fused_ingest_args(cfg, params, state, batch))
    log(f"update_fused per batch of {BATCH}: {update_ms:.3f} ms, of which "
        f"{args_ms:.3f} ms builds the kernel's arguments (record upload, threefry "
        f"sampling, ranks, padding; CUDA events around host and device work)")
    L, t, w = state.counters.shape
    ks = [cfg.level_k(i) for i in range(L)]
    live = (wpad != 0).sum(dim=(0, 2)).tolist()
    ingest_ops = sum(n_live * (2 * k + 12 * t) for n_live, k in zip(live, ks))
    # the bytes of the function, field data at its uint32 width (the
    # kernel's int64 words carry twice that; see PERF.md)
    ingest_bytes = ((values.numel() + masks.numel() + ids.numel() + 2
                     + 2 * params.bucket_coeffs.numel()) * FIELD_BYTES
                    + wpad.numel() * 4 + 2 * state.counters.numel() * 4)

    level0 = proj.lattice(cfg.d, cfg.s)[0]
    fmasks = masks[0, :level0.num].contiguous()
    fids = ids[0, :level0.num].contiguous()
    fargs = (values, fmasks, fids, params.fp_bases)
    fp_ops = 2 * level0.k * B * level0.num
    fp_bytes = (values.numel() + fmasks.numel() + fids.numel() + 2
                + 2 * B * level0.num) * FIELD_BYTES

    q_rows = tenants.shape[0] * L * t
    q_ops = q_rows * w
    q_bytes = tenants.numel() * 4 + q_rows * 4
    tenants_f32 = tenants.float()
    pairs, update, moments = estimator_kernel_args(device, cfg, params, est_out)
    moments_f32 = moments[0][0].float()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)

    no_call = "no single PyTorch call computes it"
    vecdot = "torch.linalg.vecdot on float32 copies"
    rows = []
    for name, fn, plain, (args, nbytes, ops), library, library_note in (
            ("fused_ingest", kfi.fused_ingest, ref.fused_ingest_ref,
             (iargs, ingest_bytes, ingest_ops), None, no_call),
            ("fingerprint", kfp.fingerprint, ref.fingerprint_ref, (fargs, fp_bytes, fp_ops),
             None, no_call),
            ("fused_query", kfq.fused_query, ref.fused_query_ref,
             ((tenants, tenants), q_bytes, q_ops),
             lambda: torch.linalg.vecdot(tenants_f32, tenants_f32, dim=-1), vecdot),
            ("fused_pairs", kpairs.fused_pairs, ref.fused_pairs_ref, pairs, None, no_call),
            ("sketch_update", ksu.sketch_update, ref.sketch_update_ref, update, None, no_call),
            ("sketch_moments", ksm.sketch_moments, ref.sketch_moments_ref, moments,
             lambda: torch.linalg.vecdot(moments_f32, moments_f32, dim=-1), vecdot)):
        p1, _ = device_ms(lambda: plain(*args), 10, flush)
        k1, host1 = device_ms(lambda: fn(*args), 100, flush)
        k2, host2 = device_ms(lambda: fn(*args), 100, flush)
        p2, _ = device_ms(lambda: plain(*args), 10, flush)
        lib = device_ms(library, 100, flush)[0] if library is not None else None
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((g.double() - h.double()).abs().max()) for g, h in zip(got, want))
        require(err == 0.0, f"{name}: timed output differs from the plain version")
        b_ms, b_by = bound_ms(nbytes, ops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": sum(counts[name] for counts in by_path.values()),
                     "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                     "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "library": library_note})
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms (host {host1:.4f}/{host2:.4f} ms "
            f"per call), plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {ops} int ops)"
            + (f", library {lib:.4f} ms" if lib is not None else ""))
    return rows


def reset_counts() -> None:
    """Zero every kernel's launch count and the dispatch counters, just
    before a path runs."""
    for module in KERNELS.values():
        module.launches = 0
    metrics.default_registry().clear()


def read_counts(path: str, kernels) -> dict[str, int]:
    """The launches of the path just run.  Raises unless each of its
    ``kernels`` launched, and unless every dispatch of the path resolved to
    the hand-written kernel."""
    torch.cuda.synchronize()
    launches = {name: module.launches for name, module in KERNELS.items()}
    dispatch: dict[str, float] = {}
    for labels, count in metrics.default_registry().series("kernel_dispatch_total").items():
        label = dict(labels)
        require(label["impl"] == registry.CUDA_SM90,
                f"{path}: {label['kernel']} resolved to {label['impl']}")
        dispatch[label["kernel"]] = dispatch.get(label["kernel"], 0.0) + count
    log(f"{path} path launches: {launches}")
    log(f"{path} path dispatches (all {registry.CUDA_SM90}): {dispatch}")
    for name in kernels:
        require(launches[name] > 0, f"{name} was not launched on the {path} path")
    for name, count in launches.items():
        require(dispatch.get(name, 0) >= count, f"{path}: {name} launched without a dispatch")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()
    phase_kernels(device)

    records = shingle_records(RECORDS, d=6, seed=1, group=6, dup_profile=QUICKSTART_DUPS)
    reset_counts()
    cfg, params, deltas, ns = phase_stream(device, records)
    tenants = phase_tenants(cfg, deltas, ns)
    by_path = {"stream": read_counts("stream", ("fused_ingest", "fingerprint", "fused_query"))}
    reset_counts()
    est_out = phase_estimators(device, cfg)
    by_path["estimators"] = read_counts("estimators", tuple(KERNELS))

    rows = phase_numbers(device, cfg, params, records, tenants, by_path, est_out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
