#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a, holds each against its plain PyTorch version on the card, then
drives the SJPC main path at the paper's defaults (d=6, s=3, r=0.5,
w=1024, t=3): 2^20 records in 16 batches through ``update_fused`` and the
per-level ``update``, ``estimate_batch`` and ``estimate_join_batch`` on
the stream, and both queries over 1,024 stacked sketches.  Every result of
the main path is compared with the same computation through the plain
versions on the card.  Prints a ``{"kernels": [...]}`` line with each
kernel's launches, times and bound, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero, and
without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

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

from repro_torch.configs.sjpc_paper import PAPER_DEFAULTS  # noqa: E402
from repro_torch.core import exact, sjpc  # noqa: E402
from repro_torch.core import projections as proj  # noqa: E402
from repro_torch.data.synthetic import shingle_records  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import fingerprint as kfp  # noqa: E402
from repro_torch.kernels import fused_ingest as kfi  # noqa: E402
from repro_torch.kernels import fused_query as kfq  # noqa: E402

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


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


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
    log(f"kernels: {n_checks + 1} kernel-vs-plain checks bit-exact")


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


def phase_numbers(device, cfg, params, records, tenants, launches):
    """Kernel, plain-version and library times at the main path's shapes,
    with the bound of each."""
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
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)

    rows = []
    for name, fn, plain, args, nbytes, ops, library, replaces in (
            ("fused_ingest", kfi.fused_ingest, ref.fused_ingest_ref, iargs,
             ingest_bytes, ingest_ops, None, "src/repro/kernels/fused_ingest.py:85"),
            ("fingerprint", kfp.fingerprint, ref.fingerprint_ref, fargs,
             fp_bytes, fp_ops, None, "src/repro/kernels/fingerprint.py:41"),
            ("fused_query", kfq.fused_query, ref.fused_query_ref, (tenants, tenants),
             q_bytes, q_ops, lambda: torch.linalg.vecdot(tenants_f32, tenants_f32, dim=-1),
             "src/repro/kernels/fused_query.py:54")):
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
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms (host {host1:.4f}/{host2:.4f} ms "
            f"per call), plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {ops} int ops)"
            + (f", library {lib:.4f} ms" if lib is not None else ""))
    return rows


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
    modules = {"fused_ingest": kfi, "fingerprint": kfp, "fused_query": kfq}
    for module in modules.values():
        module.launches = 0
    cfg, params, deltas, ns = phase_stream(device, records)
    tenants = phase_tenants(cfg, deltas, ns)
    torch.cuda.synchronize()
    launches = {name: module.launches for name, module in modules.items()}
    log(f"main path launches: {launches}")
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched on the main path")

    rows = phase_numbers(device, cfg, params, records, tenants, launches)
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
