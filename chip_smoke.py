#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a and holds each against its plain PyTorch version on the card.  Then
it drives the port's paths at the paper's defaults (d=6, s=3, r=0.5,
w=1024, t=3):

* the SJPC stream: 2^20 records in 16 batches through ``update_fused`` and
  the per-level ``update`` (each drawing its sampling weights with the
  ``sample_weights`` kernel), ``estimate_batch`` and ``estimate_join_batch``
  on the stream, and both queries over 1,024 stacked sketches; one more
  ``update_fused``, of a batch already on the card, under
  ``torch.cuda.set_sync_debug_mode("error")``: it reads nothing back to the
  host;
* the equal-space estimators (``estimators`` phase): SJPC, reservoir and
  LSH-SS, each at its own factory's size, over 64 streams of 16 rounds of
  4,096 records (the unfused SJPC path on 8 of them), the window algebra,
  ``estimate_batch`` with bootstrap error bars over the 64 streams and over
  1,024 tenants, and the per-stream level F2 through ``sketch_moments``;
* the multi-tenant estimation service (``service`` phase): 288 tenants in
  two hash groups of the paper's config (``dblp/a``, ``dblp/b``; 128 SJPC
  tenants each, and in ``dblp/b`` 16 reservoir tenants with two backing
  epochs and 16 LSH-SS tenants), 4,096 ``shingle_records`` per tenant per
  epoch in rounds of 512, 6 epochs over a window of 4, 928 standing
  queries (1,024 result cells) polled twice per epoch, the second poll all
  cache hits.  Held against a plain twin (``impl="torch_ref"``) of a
  pinned-uid subset of every kind and both groups and an unfused service
  over 16 SJPC tenants, bit for bit; windows W1-W3; planner and
  observability off give the same results; every service span's total
  covers its dispatch and the card's time for its flush.  The kernel
  service's own calls count as path ``service``, the unfused service's as
  ``service_unfused``;
* the distributed service (``distributed`` phase): the paper's group over
  64 tenants (48 SJPC, 8 reservoir, 8 LSH-SS) hashed onto workers, 4,096
  ``shingle_records`` per tenant per cycle, 6 cycles over a window of 4,
  one ``all_thresholds`` standing query per tenant polled on the
  coordinator after each cycle: (a) two in-process workers and a
  coordinator on the card held against the single-process oracle on the
  card (replica counters, ``n`` and sample windows bit for bit, every
  estimate within 1e-6; the cluster's calls count as path
  ``distributed``, the oracle's as ``distributed_oracle``); (b) 1, 2 and
  4 worker processes on the card, each held against that oracle, with
  records/s, merge and freshness-lag quantiles; (c) every bundle (a)
  exported decodes and encodes to the same bytes, each leaf in the JAX
  package's dtype;
* the accuracy cell (``accuracy`` phase, path ``accuracy``): 262,144
  planted-cluster records (g_4 ~ 18 n), SJPC at s = 4, r = 1 against
  random sampling at its bytes, the served reservoir and LSH-SS; the
  errors are printed, only finiteness is gated;
* the dense serving path (``serve`` phase): qwen2.5-3b at full width and
  depth (36 layers, d_model 2048, GQA 16:2, head_dim 128, vocab 151,936),
  random f32 weights from a seeded ``torch.Generator`` on the card, 4
  prompts of 10,240 tokens (prompt 2 repeats prompt 0) through
  ``greedy_generate`` for 16 tokens -- every layer's prefill attention runs
  the f32 ``flash_attention`` kernel (``csrc/flash_attention_f32.cu``, f32
  precision on the tensor cores from split bf16 operands) -- and the SJPC
  request monitor over the prompts (``fingerprint`` kernel); then the same
  prompts through a bf16 prefill (``make_prefill`` at its default compute
  dtype), whose attention runs the bf16 kernel
  (``csrc/flash_attention_tc.cu``).

Every result of a kernel path is compared with the same computation
through the plain versions on the card (``impl="torch_ref"``); LSH-SS,
which launches no kernel, is held against its ``estimate_ref``.  The flash
kernel agrees with its plain version within 2e-5 in f32 (with q scaled 8x,
where f32's rounding of the scores moves the plain version itself that far,
with a float64 answer instead), and in bf16 within one bf16 ulp of the
plain value plus 2e-5 (and 2e-2 anywhere); the other kernels bit for bit.  The serve phase also holds the prefill's K/V
cache of every layer against the plain path's, and the request monitor's
fingerprints and counters against the plain versions; the bf16 prefill's
last-token logits are no further from the f32 prefill's than the plain
bf16 path's (within 1.25 times).  The launch counts and
``kernel_dispatch_total`` show that every kernel call of those paths ran
the hand-written kernel.  Prints a ``{"kernels": [...]}`` line with each
kernel's launches, times and bound (``fused_pairs`` also at the 64-stream
query and at the 1,024-tenant query's bootstrap replicates;
``sketch_moments`` also on a join's two sketches and, at (3, 65536), its
kept design beside the one not kept; beside the
three shortest kernels the per-launch floor, an empty kernel between the
same events), the card's name and power limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero; it exits 2 and prints no result without a CUDA device.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import io
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch import estimators as E  # noqa: E402
from repro_torch.configs.sjpc_paper import PAPER_DEFAULTS  # noqa: E402
from repro_torch.core import baselines, exact, prng, sjpc  # noqa: E402
from repro_torch.core import projections as proj  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.hashing import P31, as_field_tensor  # noqa: E402
from repro_torch.data.recordize import np_records_from_tokens, records_from_tokens  # noqa: E402
from repro_torch.data.synthetic import planted_cluster_records, shingle_records  # noqa: E402
from repro_torch.distributed import harness, wire  # noqa: E402
from repro_torch.distributed.coordinator import Coordinator, LocalWorker  # noqa: E402
from repro_torch.distributed.transport import OP_EXPORT  # noqa: E402
from repro_torch.estimators import uncertainty  # noqa: E402
from repro_torch.kernels import _build, ops, ref, registry  # noqa: E402
from repro_torch.kernels import fingerprint as kfp  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import fused_ingest as kfi  # noqa: E402
from repro_torch.kernels import fused_pairs as kpairs  # noqa: E402
from repro_torch.kernels import fused_query as kfq  # noqa: E402
from repro_torch.kernels import sample_weights as ksw  # noqa: E402
from repro_torch.kernels import sketch_moments as ksm  # noqa: E402
from repro_torch.kernels import sketch_update as ksu  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch import service as svc_mod  # noqa: E402
from repro_torch.obs import Observability, Tracer, metrics  # noqa: E402
from repro_torch.service.ingest import ingest_key, ingest_key_grid  # noqa: E402
from repro_torch.sketchstream import monitor as mon  # noqa: E402

# Peak rates of one H100 SXM (NVIDIA data sheet and Hopper white paper):
# HBM3 bandwidth, and 32-bit integer operations on the CUDA cores
# (132 SMs x 64 INT32 lanes x 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 FMA on the CUDA cores (132 SMs x 128 FP32 lanes x 2 flops x
# 1.98 GHz), the rate of f32 attention without TF32; and the dense bf16
# tensor-core rate, the least time of a bf16-input function that
# accumulates in f32.
F32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9
BF16_TENSOR_FLOPS_PER_S = 989e12
# The f32 flash kernel does each matrix product as this many bf16 products
# of split operands (three parts each, the pairs whose indices add up to at
# most 2): at the bf16 tensor-core rate, its floor at f32 precision.
F32_SPLIT_PRODUCTS = 6
# A field element (record column, mask, id, base, hash coefficient,
# fingerprint) is a uint32 in the functions the kernels compute.
FIELD_BYTES = 4
# int32 operations of one threefry2x32 block: 20 rounds of add, rotate and
# xor, and 12 key additions.
THREEFRY_OPS = 72
# (d, s, r) of the sample_weights checks: the paper's defaults, the request
# monitor's all-ones level, a fractional sample size, and levels of 126
# combinations (the plain version's argsort branch, the kernel's
# large-level path); and the steps of the default keys.
SAMPLE_CONFIGS = ((6, 3, 0.5), (4, 4, 1.0), (5, 2, 0.75), (9, 4, 0.3))
SAMPLE_STEPS = (0, 1, 2**31 - 1)
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

# The service phase: the multi-tenant service at the paper's DBLPtitles
# group (configs/sjpc_paper: d=6, s=3, r=0.5, w=1000 -> 1024, t=3) in two
# hash groups of that config, so that the planner fuses across them: 128
# SJPC tenants in each, and in dblp/b also 16 reservoir tenants with
# backing_epochs=2 and 16 LSH-SS tenants at their factories' equal-space
# sizes.  Each tenant gets 4,096 shingle_records per epoch, seeded by
# (tenant, epoch): 1,179,648 records in 8 rounds of 512 per flush; 6
# epochs over a window of 4, so every window expires twice.
SVC_GROUPS = ("dblp/a", "dblp/b")
SVC_SJPC = 128
SVC_SAMPLE = 16
SVC_BACKING = 2
SVC_ROWS = 4096
SVC_BATCH_ROWS = 512
SVC_WINDOW = 4
SVC_EPOCHS = 6
SVC_SEED = 2020
SVC_TWIN_SJPC = 2      # SJPC tenants per group in the two small twins
SVC_TWIN_SAMPLE = 2    # tenants per sample kind in the two small twins
SVC_UNFUSED = 16       # SJPC tenants of dblp/a in the unfused service
SVC_SPIN_S = 1.0       # the spin ahead of epoch 0's flush (the span gate)
SVC_PROBE_S = 0.2      # the spin inside the Span.sync probe

# The distributed phase: distributed/harness.py's scale-out workload (the
# paper's DBLPtitles group over 64 tenants, 48 SJPC, 8 reservoir and 8
# LSH-SS; 4,096 shingle_records per tenant per cycle, rounds of 512, 6
# cycles over a 4-epoch window), names salted to balance over 1, 2 and 4
# workers, one all_thresholds standing query per tenant polled on the
# coordinator after each cycle.
DIST_WORKERS = (1, 2, 4)
# each leaf's dtype in the JAX package's frames (every other leaf: <i4)
WIRE_DTYPES = {"sjpc": {"counters": "<i4", "n": "<f4", "step": "<i4"},
               "reservoir": {"items": "<u4"}, "lsh_ss": {"rec_items": "<u4"}}

# The accuracy phase: the paper's Fig. 4/8 regime, uniform noise with
# planted near-duplicate clusters (g_4 ~ 18 n, g_5 ~ 6 n), SJPC at s = 4,
# r = 1 against its equal-space competitors.
ACC_N = 262144
ACC_D = 6
ACC_SEED = 17
ACC_CLUSTERS = ((4, 1024, 3), (5, 768, 2), (6, 384, 1))
ACC_CFG = dict(d=ACC_D, s=4, ratio=1.0, width=2048, depth=3)
ACC_BAND = (4, 5)
ACC_BASE_SEED = 900
ACC_TRIALS = 5
ACC_SERVE_BATCH = 2048
ACC_LSH_TRIALS = 3
ACC_LSH_PAIRS = 4096

# The serve phase: qwen2.5-3b, 4 prompts of 10,240 tokens (5 x the 2048
# attention chunk, above the 8192-token threshold of the flash branch; the
# repo's prefill_32k shape is 32,768 tokens x 32, cut to fit the script's
# time), 16 greedy tokens, f32 (greedy_generate's compute dtype).
SERVE_ARCH = "qwen2.5-3b"
SERVE_BATCH = 4
SERVE_PROMPT = 10240
SERVE_STEPS = 16
SERVE_SEED = 0
SERVE_CHUNK = 2048             # prefill's attention tiles (the plain version's)
LOGITS_RTOL = 1e-4             # kernel vs plain prefill logits, relative to max |logit|
KV_RTOL = 1e-4                 # kernel vs plain prefill K/V cache, relative to max |x|
# flash_attention against its plain version.  Both compute in f32, in their
# own tiles and order, and agree within FLASH_F32_TOL there (the JAX
# package's flash-kernel tolerance).  A bf16 output is that f32 value
# rounded, so in bf16 the two may differ by one bf16 ulp of the plain value
# on top; and by no more than FLASH_BF16_TOL anywhere (the JAX package's
# bf16 limit).
FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2
MONITOR = mon.SketchMonitorConfig(d=4, s=4, ratio=1.0, width=1024, depth=3, shards=1)

# The bf16 prefill's last-token logits, as max |x - f32 prefill's| / max
# |f32 prefill's|: the kernel's may be at most this many times the plain
# bf16 path's.
BF16_PREFILL_RATIO = 1.25

KERNELS = {"fused_ingest": kfi, "sample_weights": ksw, "fingerprint": kfp,
           "fused_query": kfq, "fused_pairs": kpairs, "sketch_update": ksu,
           "sketch_moments": ksm, "flash_attention": kfa}
# Every launch count: (module, attribute, the op whose dispatches it counts).
# The flash_attention op has two kernels, f32 (split operands) and bf16.
COUNTS = {name: (module, "launches", name) for name, module in KERNELS.items()}
COUNTS["flash_attention_tc"] = (kfa, "tc_launches", "flash_attention")
# Each kernel's source under src/repro_torch/kernels/csrc (the f32 flash
# kernel's row keeps the op's name).
SOURCES = {name: f"{name}.cu" for name in COUNTS}
SOURCES["flash_attention"] = "flash_attention_f32.cu"
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:87",
            "fused_ingest": "src/repro/kernels/fused_ingest.py:85",
            "sample_weights": "src/repro/core/sjpc.py:145 _sample_level_weights (XLA; no "
                              "Pallas kernel)",
            "fingerprint": "src/repro/kernels/fingerprint.py:41",
            "fused_query": "src/repro/kernels/fused_query.py:54",
            "fused_pairs": "src/repro/kernels/fused_pairs.py:85",
            "sketch_update": "src/repro/kernels/sketch_update.py:60",
            "sketch_moments": "src/repro/kernels/sketch_moments.py:34"}
# Kernels that no path of either package calls: their launches are this
# script's own cross-check, which the row's launches_by_path says.
CROSS_CHECK_ONLY = {"sketch_moments": "all this script's F2 cross-check against "
                                      "fused_query's rows; no path of either package calls "
                                      "sketch_moments"}
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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth or operations
    over their peak rate (default the INT32 one), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_work(q, k, causal: bool) -> tuple[int, int]:
    """(bytes, flops) of attention over q (B, Sq, H, hd), k/v (B, Skv, KV,
    hd): q, k and v read once and the output written once; 4 * hd flops
    (two multiply-adds per dimension) per visible (query, key) pair."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * hd * b * h * pairs


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
    # the request monitor's lattice (d=4, s=4: one level, one combination)
    mrng = np.random.default_rng(2025)
    mlevel = proj.lattice(MONITOR.d, MONITOR.s)[0]
    for batch in (1, SERVE_BATCH, 1000, BATCH):
        args = ingest_case(mrng, device, batch, MONITOR.d, MONITOR.s, 1024, 3)
        fargs = (args[1], args[2][0, :mlevel.num].contiguous(),
                 args[3][0, :mlevel.num].contiguous(), args[4])
        got, want = kfp.fingerprint(*fargs), ref.fingerprint_ref(*fargs)
        require(equal(got[0], want[0]) and equal(got[1], want[1]),
                f"fingerprint d={MONITOR.d} s={MONITOR.s} B={batch}")
        n_checks += 1
    ingest_shapes = [(b, w, t) for b in (1, 777) for w in (64, 1024, 65536)
                     for t in (1, 2, 3, 5)]
    # w = 2^14 and 2^16: planes beyond shared memory, global atomics
    ingest_shapes += [(BATCH, 1024, 3), (BATCH, 65536, 5), (4099, 1024, 2), (BATCH, 1 << 14, 3)]
    for batch, width, depth in ingest_shapes:
        args = ingest_case(rng, device, batch, 6, 3, width, depth)
        want = ref.fused_ingest_ref(*args)
        require(equal(kfi.fused_ingest(*args), want),
                f"fused_ingest B={batch} w={width} t={depth}")
        # the kernel's own form, the field data as int32 words
        words = (args[0],) + tuple(kfi.words32(a) for a in args[1:7]) + (args[7],)
        require(equal(kfi.fused_ingest(*words), want),
                f"fused_ingest int32 words B={batch} w={width} t={depth}")
        n_checks += 2
    for d, s in ((4, 4), (5, 2), (9, 4)):
        args = ingest_case(rng, device, 4099, d, s, 1024, 3)
        require(equal(kfi.fused_ingest(*args), ref.fused_ingest_ref(*args)),
                f"fused_ingest d={d} s={s}")
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
    n_checks += check_sample_weights_grid(device)
    n_checks += check_pairs_grid(rng, device)
    n_checks += check_sketch_update_grid(rng, device)
    n_checks += check_sketch_moments_grid(rng, device)
    log(f"kernels: {n_checks} kernel-vs-plain checks bit-exact")
    check_flash_grid(rng, device)


def attention_case(rng, device, b, sq, skv, h, kv, hd, dtype=torch.float32):
    """q, k, v of standard normal values (numpy draws) in ``dtype``."""
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))


def flash_limit(want: torch.Tensor) -> torch.Tensor:
    """Per element, the most the kernel's output may differ from its plain
    version's ``want``: FLASH_F32_TOL, plus in bf16 one bf16 ulp of want
    (2^(e-8) for |want| in [2^(e-1), 2^e))."""
    w = want.float()
    if want.dtype == torch.float32:
        return torch.full_like(w, FLASH_F32_TOL)
    _, e = torch.frexp(w)
    return torch.ldexp(torch.ones_like(w), e - 8) * (w != 0) + FLASH_F32_TOL


def check_flash(q, k, v, causal, block_q, block_k, what) -> float:
    """The kernel against its plain version (in the given blocks), element
    by element within :func:`flash_limit`; returns the max abs difference.
    f32 must launch the f32 kernel, bf16 the bf16 kernel."""
    before = (kfa.launches, kfa.tc_launches)
    got = kfa.flash_attention(q, k, v, causal=causal)
    rose = (1, 0) if q.dtype == torch.float32 else (0, 1)
    require((kfa.launches - before[0], kfa.tc_launches - before[1]) == rose,
            f"{what}: launched {kfa.launches - before[0]} f32 / "
            f"{kfa.tc_launches - before[1]} bf16 kernels, expected {rose}")
    want = ref.flash_attention_ref(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    require(got.dtype == want.dtype == q.dtype and got.shape == q.shape, f"{what}: dtype/shape")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    over = int((diff > flash_limit(want)).sum())
    cap = FLASH_F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
    require(over == 0 and err <= cap,
            f"{what}: {over} elements beyond the limit, max abs err {err} (cap {cap})")
    return err


def exact_attention(q, k, v) -> torch.Tensor:
    """Causal attention in float64, KV heads repeated: the exact answer to
    the f32 inputs, up to float64 rounding."""
    b, sq, h, hd = q.shape
    kd, vd = (x.double().repeat_interleave(h // k.shape[2], 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / math.sqrt(hd)
    above = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device).triu(1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(above, -math.inf), -1),
                        vd)


def check_flash_grid(rng, device) -> None:
    """flash_attention against its plain version: the JAX kernel tests'
    grid (shapes x causality, block shapes, bf16, the first token) and
    ragged tiles.  The serve phase's layer shape is checked in
    :func:`flash_row`, in f32 and bf16."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0
    cases = [((b, sq, skv, h, kv, hd), torch.float32, causal, 32, 32)
             for b, sq, skv, h, kv, hd in ((2, 64, 64, 4, 2, 16), (1, 128, 128, 8, 8, 32),
                                           (2, 64, 128, 4, 1, 16), (1, 96, 96, 6, 3, 64))
             for causal in (True, False)]
    cases += [((2, 128, 128, 4, 2, 32), torch.float32, True, bq, bk)
              for bq, bk in ((16, 16), (32, 64), (64, 32), (128, 128))]
    cases += [((1, 64, 64, 4, 2, 32), torch.bfloat16, True, 32, 32)]
    cases += [((1, sq, skv, 16, 2, 128), dtype, causal, sq, skv)
              for sq, skv in ((200, 200), (1000, 1000), (64, 300))
              for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)]
    # both kernels: every head dim, GQA groups 1, 2 and 8, single rows and
    # ragged 128-row query tiles and 32-, 64- or 128-key tiles with Sq <
    # Skv and Sq > Skv, causal or not
    lengths = ((1, 1), (1, 63), (63, 129), (129, 63), (200, 200), (200, 1000), (1000, 200),
               (1000, 1000))
    cases += [((2, sq, skv, 8, (8, 4, 1)[(i + hd // 16) % 3], hd), dtype, causal, sq, skv)
              for dtype in (torch.float32, torch.bfloat16)
              for hd in kfa.HEAD_DIMS for i, (sq, skv) in enumerate(lengths)
              for causal in (True, False)]
    for shape, dtype, causal, bq, bk in cases:
        q, k, v = attention_case(rng, device, *shape, dtype=dtype)
        err = check_flash(q, k, v, causal, bq, bk, f"flash_attention {shape} {dtype} "
                                                    f"causal={causal}")
        errs[dtype] = max(errs[dtype], err)
        n_checks += 1
    # q scaled up: scores of tens, large steps of the running max (8x in
    # bf16; 4x in f32, and 8x in f32 against the float64 answer, since
    # f32's own rounding of scores that large moves the plain version about
    # FLASH_F32_TOL from it)
    for dtype, scale in ((torch.float32, 4), (torch.bfloat16, 8)):
        q, k, v = attention_case(rng, device, 1, 1000, 1000, 16, 2, 128, dtype=dtype)
        q = (q.float() * scale).to(dtype)
        errs[dtype] = max(errs[dtype], check_flash(q, k, v, True, 1000, 1000,
                                                   f"flash_attention {dtype} x{scale}"))
    q, k, v = attention_case(rng, device, 1, 1000, 1000, 16, 2, 128)
    q = q * 8
    exact = exact_attention(q, k, v)
    e_kernel = float((kfa.flash_attention(q, k, v, causal=True).double() - exact).abs().max())
    e_plain = float((ref.flash_attention_ref(q, k, v, causal=True, block_q=1000, block_k=1000)
                     .double() - exact).abs().max())
    require(e_kernel <= min(FLASH_F32_TOL, e_plain),
            f"flash_attention f32 x8: {e_kernel} from the float64 answer (plain version "
            f"{e_plain}, limit {FLASH_F32_TOL})")
    log(f"kernels: flash_attention f32 with q x8, max abs distance from the float64 answer: "
        f"kernel {e_kernel:.3g}, plain version {e_plain:.3g} (limit: {FLASH_F32_TOL} and "
        f"the plain version's)")
    for dtype, hd in itertools.product((torch.float32, torch.bfloat16), kfa.HEAD_DIMS):
        q, k, v = attention_case(rng, device, 1, 32, 32, 2, 2, hd, dtype=dtype)
        first = kfa.flash_attention(q, k, v, causal=True)[:, 0]
        require(float((first.float() - v[:, 0].float()).abs().max()) <= 1e-5,
                f"flash_attention {dtype} hd {hd}: first token != v[0]")
    n_checks += 3 + 2 * len(kfa.HEAD_DIMS)
    log(f"kernels: {n_checks} flash_attention checks against the plain version, max abs "
        f"err {errs[torch.float32]:.3g} (f32, limit {FLASH_F32_TOL}) and "
        f"{errs[torch.bfloat16]:.3g} (bf16, limit one bf16 ulp + {FLASH_F32_TOL}, cap "
        f"{FLASH_BF16_TOL})")


def check_sample_weights_grid(device) -> int:
    """sample_weights against its plain version, bit for bit: every (d, s,
    r) of SAMPLE_CONFIGS, B = 1, 4,095 and 65,536, with and without a row
    mask, under the host's default keys of SAMPLE_STEPS, an ingest key, and
    the default keys derived on the card from a step tensor (which must
    equal the host keys' weights)."""
    n_checks = 0
    for d, s, r in SAMPLE_CONFIGS:
        cfg = sjpc.SJPCConfig(d=d, s=s, ratio=r)
        base = prng.PRNGKey(cfg.seed ^ 0xC0FFEE).to(device)
        keys = [(f"default_key step {step}", sjpc.default_key(cfg, step).to(device), None)
                for step in SAMPLE_STEPS]
        keys.append(("ingest_key", ingest_key(cfg, 3, 5).to(device), None))
        keys += [(f"step {step} on the card", base,
                  torch.tensor(step, dtype=torch.int32, device=device)) for step in SAMPLE_STEPS]
        for batch in (1, 4095, BATCH):
            mrng = np.random.default_rng(batch + d)
            mask = torch.from_numpy((mrng.random(batch) < 0.7).astype(np.int32)).to(device)
            for row_mask in (None, mask):
                host = {}
                for name, key, step in keys:
                    got = ksw.sample_weights(key, step, row_mask, batch, d, s, r)
                    want = ref.sample_weights_ref(key, step, row_mask, batch, d, s, r)
                    what = f"sample_weights d={d} s={s} r={r} B={batch} {name} " \
                           f"mask={row_mask is not None}"
                    require(equal(got, want), what)
                    if step is None and name.startswith("default_key"):
                        host[name.split()[-1]] = got
                    elif step is not None:
                        require(equal(got, host[name.split()[1]]),
                                f"{what}: != the host default key's weights")
                    n_checks += 1
    return n_checks


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
    """Bit-exact against the plain version, at the paper's width before
    and after padding (1000, 1024), narrow and wide rows, counters up to
    the whole int32 range, and rows that are views at element offset 0
    and 1 of a larger buffer (the latter takes the kernel's 4-byte loads);
    F2 also against fused_query's rows; against the int64 oracle exact
    below 2^24 and within 1e-6 (relative) above it."""
    n_checks = 0
    for t in (1, 3, 5):
        for w in (1, 3, 64, 1000, 1024, 65536):
            for magnitude in (60, 1 << 20, 1 << 31):
                for offset in (0, 1):
                    a, b = (counter_stack(rng, device, (t * w + offset,), magnitude)[offset:]
                            .view(t, w) for _ in range(2))
                    what = f"sketch_moments t={t} w={w} |c|<={magnitude} offset={offset}"
                    for x, y in ((a, b), (a, a)):
                        got = ksm.sketch_moments(x, y)
                        require(equal(got, ref.sketch_moments_ref(x, y)), what)
                        oracle = (x.to(torch.int64) * y.to(torch.int64)).sum(dim=-1).double()
                        err = ((got.double() - oracle).abs() / oracle.abs().clamp_min(1.0)).max()
                        require(float(err) <= 1e-6, f"{what} vs int64 oracle: {err}")
                        small = oracle.abs() < 2**24
                        require(bool((got.double() == oracle)[small].all()),
                                f"{what}: below 2^24 is exact")
                        n_checks += 1
                    require(equal(ksm.sketch_moments(a, a),
                                  kfq.fused_query(a[None, None], a[None, None])[0, 0]),
                            f"{what}: F2 != fused_query's rows")
                    n_checks += 1
    return n_checks


def plain_update_fused(cfg, params, state, values):
    """``update_fused`` with both kernels replaced by their plain versions,
    the same keys: the reference the stream is held against."""
    with oracle_calls():
        return sjpc.update_fused(cfg, params, state, values, impl=registry.TORCH_REF)


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
        f"bit-equal to the plain path (plain sampling and ingest) and to the per-level "
        f"update")
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


def check_no_host_reads(cfg, params, device, records) -> None:
    """One ``update_fused`` of a batch already on the card, under the
    default key, with ``torch.cuda.set_sync_debug_mode("error")``: any
    device-to-host read or blocking copy on the path raises.  Its counters
    equal the plain path's."""
    _, state = sjpc.init(cfg, device=device)
    batch = as_field_tensor(records[:BATCH], device)
    state = sjpc.update_fused(cfg, params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sjpc.update_fused(cfg, params, state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = plain_update_fused(cfg, params, state, records[:BATCH])
    require(same_state(got, want), "update_fused under sync debug mode != the plain path")
    log("sync: one update_fused of a batch on the card ran under "
        "set_sync_debug_mode(\"error\") (no host read, no blocking copy); state equal to "
        "the plain path's")


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


# ---------------------------------------------------------------------------
# the dense serving path
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int) -> np.ndarray:
    """(4, 10240) token ids from the seed; prompt 2 repeats prompt 0 (a
    duplicate request, as in examples/serve_decode.py)."""
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int64)
    prompts[2] = prompts[0]
    return prompts


def profiled(fn, host_ops: bool = True):
    """``fn()`` under ``torch.profiler``: (host seconds from a synchronised
    start to a synchronised end, device seconds summed over its kernels,
    the five kernels with the most device time as (name, ms), the result,
    the device-to-host copies).  One stream, so the device seconds over the
    host seconds is the card's busy share.  ``host_ops=False`` records the
    card's activity alone, which is all these numbers read, and spares the
    profiler the processing of every host op of a call that makes
    thousands of launches."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        seconds, out = synced_s(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(((e.key[:60], e.self_device_time_total / 1e3) for e in kernels),
                 key=lambda t: -t[1])[:5]
    dtoh = sum(1 for e in prof.events() if "DtoH" in e.name or "Device -> Pageable" in e.name)
    return seconds, busy, top, out, dtoh


def log_profile(what: str, seconds: float, busy: float, top) -> None:
    share = f"{1 - busy / seconds:.3f}" if busy > 0 else "not measured (no device events)"
    log(f"profile {what}: {seconds * 1e3:.1f} ms host, {busy * 1e3:.1f} ms of kernels, device "
        f"idle share {share}; top kernels (ms): "
        + "; ".join(f"{name} {ms:.1f}" for name, ms in top))


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def phase_serve(device) -> dict:
    """qwen2.5-3b at full width and depth: greedy_generate over four
    10,240-token prompts and the SJPC request monitor (the main path, with
    the launch counts around it), then the same prefill and decode timed
    step by step, then the plain path on the card (``impl="torch_ref"``);
    then the bf16 prefill (the tensor-core kernel's path, with its own
    launch counts) and its plain path.  Returns the numbers the kernel
    table needs."""
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are enabled")
    cfg = configs.get(SERVE_ARCH)
    dims = compute_dims(cfg)
    generator = torch.Generator(device=device).manual_seed(SERVE_SEED)
    init_s, params = synced_s(lambda: M.init_params(generator, cfg, dims, device=device))
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"serve: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}: "
        f"{n_params} f32 parameters ({n_params * 4 / 1e9:.2f} GB) drawn in {init_s:.1f} s")
    prompts_np = serve_prompts(cfg.vocab_size)
    prompts = torch.from_numpy(prompts_np).to(device)
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS

    # the main path: greedy generation, then the request monitor
    reset_counts()
    gen_s, tokens = synced_s(lambda: serve.greedy_generate(params, cfg, dims, prompts, steps))
    mparams, mstate = mon.init_monitor(MONITOR, device=device)
    counters, n = mon.monitor_update_local(MONITOR, mparams, mstate.counters[0], mstate.n[0],
                                           prompts, mstate.step)
    est = mon.monitor_estimate(MONITOR, mon.MonitorState(counters[None], n[None], mstate.step))
    registry_now = metrics.default_registry()
    flash_kernel = registry_now.counter("kernel_dispatch_total", kernel="flash_attention",
                                        impl=registry.CUDA_SM90)
    flash_plain = registry_now.counter("kernel_dispatch_total", kernel="flash_attention",
                                       impl=registry.TORCH_REF)
    counts = read_counts("serve", ("flash_attention", "fingerprint", "sample_weights"),
                         sampling_calls=1)
    require(flash_kernel == cfg.num_layers and flash_plain == 0 and
            counts["flash_attention"] == cfg.num_layers and counts["flash_attention_tc"] == 0,
            f"serve: flash_attention dispatches {flash_kernel} cuda_sm90 / {flash_plain} "
            f"torch_ref, {counts['flash_attention']} f32 and {counts['flash_attention_tc']} "
            f"bf16 kernel launches; expected {cfg.num_layers} / 0, {cfg.num_layers} and 0")
    require(tuple(tokens.shape) == (B, steps) and tokens.dtype == torch.int32, "serve: tokens")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "serve: token ids")
    require(torch.equal(tokens[0], tokens[2]), "serve: duplicate prompts generated differently")
    log(f"serve: greedy_generate of {B} x {S} prompt tokens + {steps} tokens in {gen_s:.3f} s "
        f"(host clock); {counts['flash_attention']} flash_attention launches, all "
        f"{registry.CUDA_SM90} and all of the f32 kernel ({SOURCES['flash_attention']}); "
        f"tokens row 0 {tokens[0].tolist()}")

    records = records_from_tokens(prompts, MONITOR.d)
    require(np.array_equal(records.cpu().numpy(),
                           np_records_from_tokens(prompts_np, MONITOR.d).astype(np.int64)),
            "serve: monitor records != np_records_from_tokens")
    require(float(n) == B, "serve: monitor n")
    # the monitor's fingerprint launch, on its own records, lattice and
    # bases, against the plain version; and the whole monitor update against
    # the same one run on the CPU, where the plain versions run
    values = as_field_tensor(records, device)
    for level in proj.lattice(MONITOR.d, MONITOR.s):
        fargs = (values, torch.from_numpy(level.masks.astype(np.int64)).to(device),
                 torch.from_numpy(level.ids.astype(np.int64)).to(device), mparams.fp_bases)
        got, want = kfp.fingerprint(*fargs), ref.fingerprint_ref(*fargs)
        require(equal(got[0], want[0]) and equal(got[1], want[1]),
                f"serve: monitor fingerprints at level {level.k} != the plain version")
    cparams, cstate = mon.init_monitor(MONITOR, device="cpu")
    require(all(equal(x.cpu(), y) for x, y in zip(mparams, cparams)),
            "serve: monitor hash parameters differ between the card and the CPU")
    ccounters, cn = mon.monitor_update_local(MONITOR, cparams, cstate.counters[0], cstate.n[0],
                                             prompts_np, cstate.step)
    cest = mon.monitor_estimate(MONITOR, mon.MonitorState(ccounters[None], cn[None],
                                                          cstate.step))
    require(equal(counters.cpu(), ccounters) and equal(n.cpu(), cn),
            "serve: monitor counters or n differ from the CPU run")
    require(all(math.isclose(est["g"][k], cest["g"][k], rel_tol=1e-6, abs_tol=1e-6)
                for k in est["g"]), f"serve: monitor g {est['g']} != the CPU run's {cest['g']}")
    dup_pairs = (est["g"][MONITOR.d] - B) / 2
    true_pairs = sum(int(np.array_equal(prompts_np[i], prompts_np[j]))
                     for i in range(B) for j in range(i + 1, B))
    log(f"serve: SJPC request monitor ~{dup_pairs:.2f} duplicate prompt pairs (true: "
        f"{true_pairs}); records equal np_records_from_tokens, fingerprints equal the plain "
        f"version, counters and n equal the CPU run's, g within 1e-6 of it ({cest['g']})")

    # the same serving, timed step by step
    prefill = serve.make_prefill(cfg, dims, compute_dtype=torch.float32)
    decode = serve.make_decode_step(cfg, dims, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(device)
    prefill_s, (logits, pcache) = synced_s(lambda: prefill(params, prompts))
    log_profile("prefill (a second one)", *profiled(lambda: prefill(params, prompts))[:3])
    cache = serve._rebase_cache(M.init_cache(cfg, dims, B, S + steps, dtype=torch.float32,
                                             device=device), pcache, S)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out, step_s = [tok], []
    for _ in range(steps - 1):
        seconds, (step_logits, cache) = synced_s(lambda: decode(params, tok, cache))
        step_s.append(seconds)
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log_profile("one more decode step", *profiled(lambda: decode(params, tok, cache))[:3])
    del cache
    require(torch.equal(torch.cat(out, dim=1), tokens), "serve: stepwise tokens != greedy_generate")
    require(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (B, 1, dims.vocab),
            "serve: prefill logits")
    decode_ms = float(np.median(step_s)) * 1e3
    log(f"serve: prefill {prefill_s * 1e3:.1f} ms ({B * S / prefill_s:.0f} prompt tokens/s); "
        f"decode {decode_ms:.3f} ms per step, median of {len(step_s)} "
        f"({B / (decode_ms / 1e3):.1f} tokens/s); host clock around synchronised work; "
        f"peak device memory {peak_gb:.1f} GB")

    # the plain path on the card
    with oracle_calls():
        ref_s, ref_tokens = synced_s(lambda: serve.greedy_generate(params, cfg, dims, prompts,
                                                                   steps, impl="torch_ref"))
        ref_prefill_s, (ref_logits, ref_cache) = synced_s(
            lambda: M.prefill(params, cfg, dims, prompts, compute_dtype=torch.float32,
                              impl="torch_ref"))
    rel = float((logits - ref_logits).abs().max() / ref_logits.abs().max())
    require(torch.equal(tokens, ref_tokens), "serve: tokens != the torch_ref call's")
    require(rel <= LOGITS_RTOL, f"serve: prefill logits differ by {rel} of max |logit|")
    # every layer's K and V of every prompt position: layer l's come from
    # the attention outputs of layers < l at every query row, which the
    # last-token logits alone do not see
    kv_rel = []
    for got, want in zip(tree_leaves(pcache.groups), tree_leaves(ref_cache.groups)):
        require(got.shape == want.shape, "serve: prefill cache shapes")
        kv_rel += ((got - want).abs().amax(dim=(1, 2, 3, 4))
                   / want.abs().amax(dim=(1, 2, 3, 4))).tolist()
    del pcache, ref_cache
    require(max(kv_rel) <= KV_RTOL, f"serve: prefill K/V differ by {max(kv_rel)} of max |x|")
    log(f"serve: tokens equal the impl=\"torch_ref\" call's; prefill last-token logits within "
        f"{rel:.3g} of max |logit| (limit {LOGITS_RTOL}); the {len(kv_rel)} per-layer K and V "
        f"caches within {max(kv_rel):.3g} of max |x| (limit {KV_RTOL}; the last layer's V "
        f"{kv_rel[-1]:.3g}); plain path greedy_generate {ref_s:.3f} s, prefill "
        f"{ref_prefill_s * 1e3:.1f} ms")
    del ref_logits

    # the same prompts through a bf16 prefill (serving's default compute
    # dtype): the kernel path, then the plain path on the card, each held
    # against the f32 prefill's last-token logits
    reset_counts()
    bf16_s, (bf16_logits, bf16_cache) = synced_s(lambda: serve.make_prefill(cfg, dims)(params,
                                                                                      prompts))
    del bf16_cache
    bf16_counts = read_counts("serve_bf16", ("flash_attention_tc",))
    require(bf16_counts["flash_attention_tc"] == cfg.num_layers
            and bf16_counts["flash_attention"] == 0,
            f"serve_bf16: {bf16_counts['flash_attention_tc']} tensor-core and "
            f"{bf16_counts['flash_attention']} f32 flash_attention launches; expected "
            f"{cfg.num_layers} and 0")
    with oracle_calls():
        bf16_ref_s, (bf16_ref_logits, bf16_ref_cache) = synced_s(
            lambda: serve.make_prefill(cfg, dims, impl="torch_ref")(params, prompts))
    del bf16_ref_cache
    require(all(bool(torch.isfinite(x).all()) and x.shape == logits.shape
                for x in (bf16_logits, bf16_ref_logits)), "serve_bf16: prefill logits")
    top = logits.abs().max()
    e_k = float((bf16_logits - logits).abs().max() / top)
    e_p = float((bf16_ref_logits - logits).abs().max() / top)
    e_kp = float((bf16_logits - bf16_ref_logits).abs().max() / top)
    require(e_k <= BF16_PREFILL_RATIO * e_p,
            f"serve_bf16: kernel prefill's logits {e_k} of max |logit| from the f32 prefill's, "
            f"more than {BF16_PREFILL_RATIO} x the plain bf16 path's {e_p}")
    log(f"serve_bf16: prefill {bf16_s * 1e3:.1f} ms ({B * S / bf16_s:.0f} prompt tokens/s; "
        f"host clock around synchronised work), {bf16_counts['flash_attention_tc']} "
        f"tensor-core flash_attention launches; last-token logits against the f32 prefill's, "
        f"max |d| / max |logit|: kernel e_k {e_k:.4g}, plain bf16 path e_p {e_p:.4g} (gate "
        f"e_k <= {BF16_PREFILL_RATIO} e_p), kernel to plain {e_kp:.4g}; plain bf16 prefill "
        f"{bf16_ref_s * 1e3:.1f} ms")
    return {"prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms, "launches": counts,
            "prefill_bf16_ms": bf16_s * 1e3, "launches_bf16": bf16_counts}


def flash_rows(device, by_path, flush) -> list[dict]:
    """flash_attention at the serve phase's layer shape: the f32 kernel's
    row (f32 is the main path's dtype), carrying the bf16 kernel's numbers
    as its bf16_* fields, and that kernel's own row.  The f32 row's bound
    is that of its split (F32_SPLIT_PRODUCTS bf16 products per matrix
    product on the tensor cores), the CUDA cores' f32 bound beside it."""
    rng = np.random.default_rng(SERVE_SEED + 1)
    shape = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 2, 128)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_case(rng, device, *shape, dtype=dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def kernel():
            return kfa.flash_attention(q, k, v, causal=True)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=True, block_q=SERVE_CHUNK,
                                           block_k=SERVE_CHUNK)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                    enable_gqa=True)

        def library_expanded():
            # the memory-efficient backend takes f32, but not grouped heads
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return torch.nn.functional.scaled_dot_product_attention(qt, ke, ve,
                                                                        is_causal=True)

        p1, _ = device_ms(plain, 2, flush)
        k1, _ = device_ms(kernel, 3, flush)
        k2, _ = device_ms(kernel, 3, flush)
        p2, _ = device_ms(plain, 2, flush)
        lib = device_ms(library, 3, flush)[0]
        ke, ve = (x.repeat_interleave(16 // 2, dim=1) for x in (kt, vt))
        lib_expanded = device_ms(library_expanded, 3, flush)[0]
        del ke, ve
        err = check_flash(q, k, v, True, SERVE_CHUNK, SERVE_CHUNK, f"flash_attention {dtype}")
        want = plain()
        lib_diff = (library().transpose(1, 2).float() - want.float()).abs()
        lib_err = float(lib_diff.max())
        lib_over = int((lib_diff > flash_limit(want)).sum())
        del want, lib_diff
        nbytes, flops = attention_work(q, k, causal=True)
        # tensor-core flops per useful flop: the f32 kernel's split, or the
        # bf16 kernel's hi/lo P (S once, P V twice)
        work = F32_SPLIT_PRODUCTS if dtype == torch.float32 else 1.5
        if dtype == torch.float32:
            b_ms, b_by = bound_ms(nbytes, work * flops, BF16_TENSOR_FLOPS_PER_S)
            cc_ms, _ = bound_ms(nbytes, flops, F32_FLOPS_PER_S)
            bounds = (f"bound {b_ms:.3f} ms ({b_by}: {nbytes} B, {work} x {flops} flops of "
                      f"the split at {BF16_TENSOR_FLOPS_PER_S / 1e12:.1f} TFLOP/s), the "
                      f"CUDA cores' f32 bound {cc_ms:.3f} ms ({flops} flops at "
                      f"{F32_FLOPS_PER_S / 1e12:.1f} TFLOP/s)")
        else:
            b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
            bounds = (f"bound {b_ms:.3f} ms ({b_by}: {nbytes} B, {flops} flops at "
                      f"{BF16_TENSOR_FLOPS_PER_S / 1e12:.1f} TFLOP/s)")
        ms = min(k1, k2)
        tflops = flops / (ms / 1e3) / 1e12
        log(f"time flash_attention {dtype} {shape}: kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms, library (scaled_dot_product_attention, enable_gqa) "
            f"{lib:.3f} ms (its max abs err {lib_err:.3g}, {lib_over} elements beyond the "
            f"kernel's limit), the memory-efficient backend on KV heads repeated 8x "
            f"{lib_expanded:.3f} ms, {bounds}; kernel at {tflops:.2f} TFLOP/s of useful "
            f"work, {work * tflops:.2f} TFLOP/s of tensor-core work")
        name = "flash_attention" if dtype == torch.float32 else "flash_attention_tc"
        out[dtype] = {"name": name, "route": "cuda",
                      "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
                      "replaces": REPLACES["flash_attention"],
                      "launches": sum(counts[name] for counts in by_path.values()),
                      "launches_by_path": {path: counts[name]
                                           for path, counts in by_path.items()},
                      "max_abs_err": err, "ms": ms, "plain_ms": min(p1, p2),
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                      "library": "scaled_dot_product_attention(is_causal=True, "
                                 "enable_gqa=True), same dtype",
                      "library_max_abs_err": lib_err, "library_over_limit": lib_over,
                      "library_best_ms": lib_expanded,
                      "library_best": "scaled_dot_product_attention, memory-efficient "
                                      "backend, on K/V heads repeated 8x beforehand (the "
                                      "repeat not timed)",
                      "tflops": tflops, "tensor_tflops": work * tflops}
        if dtype == torch.float32:
            out[dtype]["bound_cuda_core_ms"] = cc_ms
        del q, k, v, qt, kt, vt
    row, tc = out[torch.float32], out[torch.bfloat16]
    row.update({"bf16_ms": tc["ms"], "bf16_bound_ms": tc["bound_ms"],
                "bf16_library_ms": tc["library_ms"], "bf16_max_abs_err": tc["max_abs_err"],
                "tc_launches": tc["launches"], "bf16_tflops": tc["tflops"]})
    return [row, tc]


def pairs_work(items, valid):
    """(args, bytes, int32 operations) of one fused_pairs call: the
    histogram is symmetric, so d compares per unordered valid pair."""
    N, R, d = items.shape
    m = (valid != 0).sum(dim=1).to(torch.int64)
    return ((items, valid), N * R * d * FIELD_BYTES + N * R * 4 + N * (d + 1) * 4,
            d * int((m * (m - 1) // 2).sum()))


def estimator_kernel_args(device, cfg, params, est_out):
    """The estimator path's shapes for the three kernels it adds:
    fused_pairs over the 1,024-tenant reservoir query, sketch_update of one
    level of one unfused round (stream 0, round 0, level k = s), and
    sketch_moments of one stream's level."""
    tenants = tile_states(est_out["reservoir"], TENANTS // EST_STREAMS)
    pairs = pairs_work(tenants.items, (tenants.tags >= 0).to(torch.int32))

    level = proj.lattice(cfg.d, cfg.s)[0]
    values = as_field_tensor(est_out["records"][0][:EST_ROWS], device)
    key = est_out["keys"][0, 0].to(device)
    weights = ref.sample_weights_ref(key, None, None, EST_ROWS, cfg.d, cfg.s,
                                     cfg.ratio)[:, 0, :level.num].reshape(-1)
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


def bootstrap_pairs_args(device, cfg, est_out):
    """fused_pairs' arguments at the bootstrap of the 1,024-tenant
    reservoir query (estimators/uncertainty.py): B replicates of each
    tenant's sample, stacked on N."""
    tenants = tile_states(est_out["reservoir"], TENANTS // EST_STREAMS)
    valid = (tenants.tags >= 0).to(torch.int32)
    est = E.make("reservoir", cfg, device=device)
    keys = uncertainty.bootstrap_key(est.cfg.seed, tenants.n, tenants.step)
    idx, rep_valid, _ = uncertainty.resample_valid_slots(keys, valid, est.bootstrap,
                                                         est.bootstrap_cap)
    N = valid.shape[0]
    rep_items = tenants.items[torch.arange(N, device=device)[:, None, None], idx]
    return (rep_items.reshape((-1,) + rep_items.shape[2:]).contiguous(),
            rep_valid.reshape(-1, rep_valid.shape[-1]).contiguous())


def time_pairs_shape(row, key, items, valid, flush) -> None:
    """fused_pairs at another of the main path's shapes: held bit for bit
    against the plain version, and ``key``_shape, _ms, _plain_ms,
    _bound_ms and _bound_by added to its row."""
    (args, nbytes, ops) = pairs_work(items, valid)
    k1, _ = device_ms(lambda: kpairs.fused_pairs(*args), 20, flush)
    k2, _ = device_ms(lambda: kpairs.fused_pairs(*args), 20, flush)
    p1, _ = device_ms(lambda: ref.fused_pairs_ref(*args), 3, flush)
    p2, _ = device_ms(lambda: ref.fused_pairs_ref(*args), 3, flush)
    require(equal(kpairs.fused_pairs(*args), ref.fused_pairs_ref(*args)),
            f"fused_pairs at the {key} shape: timed output differs from the plain version")
    b_ms, b_by = bound_ms(nbytes, ops)
    row.update({f"{key}_shape": list(items.shape), f"{key}_ms": min(k1, k2),
                f"{key}_plain_ms": min(p1, p2), f"{key}_bound_ms": b_ms,
                f"{key}_bound_by": b_by})
    log(f"time fused_pairs at the {key} shape {tuple(items.shape)}: kernel "
        f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes} B, {ops} int ops)")


def moments_capped(max_cluster: int):
    """``sjpc_sketch_moments_capped`` of the built kernel: the same launch
    with at most ``max_cluster`` CTAs per row, a function of (a, b) for
    the A/B of the wide-row design not kept.  Its launches are not the
    path's and are not counted."""
    fn = ctypes.CDLL(str(_build.build_all()["sketch_moments"])).sjpc_sketch_moments_capped
    fn.argtypes = [_build.P, _build.P, _build.P, _build.I32, _build.I32, _build.I32,
                   _build.I32, _build.P]
    fn.restype = ctypes.c_int

    def call(a, b):
        t, w = a.shape
        out = torch.empty((t,), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.check("sketch_moments_capped", fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                 t, w, max_cluster, a.device.index, stream))
        return out
    return call


def time_moments_shapes(row, est_out, flush, device) -> None:
    """sketch_moments beyond the row's F2 at (3, 1024): the join
    estimator's case (two distinct sketches, streams 0 and 1 at level 0),
    ``join_*``; and F2 at (3, 65536), ``wide_*``, the kept design (a
    cluster of CTAs per row) beside the one not kept (one CTA per row).
    Each held bit for bit against the plain version."""
    counters = est_out["sjpc"].counters
    a, b = counters[0, 0], counters[1, 0]
    t, w = a.shape
    j1, _ = device_ms(lambda: ksm.sketch_moments(a, b), 100, flush)
    j2, _ = device_ms(lambda: ksm.sketch_moments(a, b), 100, flush)
    jp, _ = device_ms(lambda: ref.sketch_moments_ref(a, b), 10, flush)
    require(equal(ksm.sketch_moments(a, b), ref.sketch_moments_ref(a, b)),
            "sketch_moments join: timed output differs from the plain version")
    jb, jby = bound_ms(2 * a.numel() * 4 + t * 4, a.numel())
    row.update({"join_ms": min(j1, j2), "join_plain_ms": jp, "join_bound_ms": jb,
                "join_bound_by": jby})
    log(f"time sketch_moments join ({t}, {w}) x 2: kernel {j1:.4f}/{j2:.4f} ms, plain "
        f"{jp:.4f} ms, bound {jb:.7f} ms ({jby})")
    wide = counter_stack(np.random.default_rng(65536), device, (3, 65536), 1 << 20)
    want = ref.sketch_moments_ref(wide, wide)
    one_cta = moments_capped(1)
    require(equal(ksm.sketch_moments(wide, wide), want) and equal(one_cta(wide, wide), want),
            "sketch_moments (3, 65536): a design differs from the plain version")
    k1, _ = device_ms(lambda: ksm.sketch_moments(wide, wide), 100, flush)
    o1, _ = device_ms(lambda: one_cta(wide, wide), 100, flush)
    o2, _ = device_ms(lambda: one_cta(wide, wide), 100, flush)
    k2, _ = device_ms(lambda: ksm.sketch_moments(wide, wide), 100, flush)
    wp, _ = device_ms(lambda: ref.sketch_moments_ref(wide, wide), 10, flush)
    wb, wby = bound_ms(wide.numel() * 4 + 3 * 4, wide.numel())
    row.update({"wide_shape": list(wide.shape), "wide_ms": min(k1, k2),
                "wide_design": "a cluster of up to 8 CTAs per row",
                "wide_not_kept_ms": min(o1, o2), "wide_not_kept": "one CTA per row",
                "wide_plain_ms": wp, "wide_bound_ms": wb, "wide_bound_by": wby})
    log(f"time sketch_moments F2 (3, 65536): cluster {k1:.4f}/{k2:.4f} ms, one CTA per row "
        f"{o1:.4f}/{o2:.4f} ms (turns K O O K), plain {wp:.4f} ms, bound {wb:.7f} ms ({wby})")


def sampling_work(cfg, weights: torch.Tensor) -> tuple[int, int]:
    """(bytes, int32 operations) of one round's sampling weights
    ``weights`` (B, L, m_max), drawn with no row mask: the output written
    once (and 12 bytes of key and step); THREEFRY_OPS per threefry block
    that any implementation of these draws must run -- per record, a
    level's Bernoulli when frac > 0 and its M scores when the record keeps
    neither none nor all of them (0 < l_b < M, read from ``weights``), and
    1 + 3L blocks for the keys.  The selection's compares are not counted:
    how many there are depends on the implementation (a sorting network
    needs fewer than one per pair of combinations)."""
    parts = proj.level_sample_parts(cfg.d, cfg.s, cfg.ratio)
    B, L, m_max = weights.shape
    kept = weights.sum(dim=2)
    blocks = 1 + 3 * L
    for idx, (m, lo, frac) in enumerate(parts):
        if lo >= m and frac == 0.0:
            continue
        blocks += B * (frac > 0.0) + m * int(((kept[:, idx] > 0) & (kept[:, idx] < m)).sum())
    return B * L * m_max * 4 + 12, THREEFRY_OPS * blocks


# ---------------------------------------------------------------------------
# the multi-tenant estimation service
# ---------------------------------------------------------------------------

def service_tenants():
    """(name, group, kind, uid, index): 128 SJPC tenants in each group, and
    in dblp/b 16 reservoir and 16 LSH-SS tenants; uids dense in this
    order, pinned in every service of the phase."""
    tenants = []
    for group in SVC_GROUPS:
        tenants += [(f"{group}/sjpc{i:03d}", group, "sjpc", 0, i) for i in range(SVC_SJPC)]
    for kind in ("reservoir", "lsh_ss"):
        tenants += [(f"dblp/b/{kind}{i:02d}", "dblp/b", kind, 0, i) for i in range(SVC_SAMPLE)]
    return [(name, group, kind, uid, i) for uid, (name, group, kind, _, i) in enumerate(tenants)]


def service_queries(tenants):
    """768 self-joins (three per SJPC tenant, s spread over 3..6), 128
    joins of tenant pairs within a group, and all_thresholds on each of the
    32 sample-kind tenants: 928 standing queries, 1,024 result cells."""
    sjpc_tenants = [t for t in tenants if t[2] == "sjpc"]
    queries = [(f"self/{name}/{j}", "self_join", (name,), 3 + (i + j) % 4)
               for i, (name, *_) in enumerate(sjpc_tenants) for j in range(3)]
    for group in SVC_GROUPS:
        members = [t[0] for t in sjpc_tenants if t[1] == group]
        queries += [(f"join/{members[i]}", "join", (members[i], members[i + 1]), 3 + i // 2 % 4)
                    for i in range(0, len(members), 2)]
    queries += [(f"all/{name}", "all_thresholds", (name,), None)
                for name, _, kind, _, _ in tenants if kind != "sjpc"]
    return queries


def private_obs(sink=None):
    """An observability bundle of its own: ``reset_counts`` clears the
    default registry, which the kernels' dispatch counters use."""
    registry = metrics.MetricsRegistry()
    return Observability(metrics=registry, tracer=Tracer(sink=sink, registry=registry))


def make_service(tenants, queries, obs=None, **cfg_kw):
    """A service of ``tenants`` (uids pinned) with the queries whose streams
    it holds."""
    svc = svc_mod.EstimationService(svc_mod.ServiceConfig(
        batch_rows=SVC_BATCH_ROWS, window_epochs=SVC_WINDOW, **cfg_kw), obs=obs)
    for group in SVC_GROUPS:
        if any(t[1] == group for t in tenants):
            svc.create_group(group, PAPER_DEFAULTS)
    for name, group, kind, uid, _ in tenants:
        svc.create_stream(name, group, estimator=kind, uid=uid,
                          backing_epochs=SVC_BACKING if kind == "reservoir" else 0)
    held = {t[0] for t in tenants}
    for name, kind, streams, s in queries:
        if held.issuperset(streams):
            svc.register_continuous(svc_mod.ContinuousQuery(name, kind, streams, s))
    return svc


def service_records(tenants, epoch):
    """Each tenant's 4,096 shingle_records of this epoch, seeded by (tenant,
    epoch)."""
    return {name: shingle_records(SVC_ROWS, d=6, seed=(SVC_SEED, uid, epoch), group=6,
                                  dup_profile=QUICKSTART_DUPS)
            for name, _, _, uid, _ in tenants}


def same_result(a, b) -> bool:
    """Two served results (a QueryResult or an all-thresholds dict) equal
    in every field, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_result(a[k], b[k]) for k in a)
    return (a._replace(per_level=None) == b._replace(per_level=None)
            and np.array_equal(a.per_level, b.per_level))


def same_results(a: dict, b: dict, names) -> bool:
    return all(same_result(a[name], b[name]) for name in names)


def result_cells(out: dict):
    for res in out.values():
        yield from (res.values() if isinstance(res, dict) else (res,))


class SyncMarks:
    """Records a CUDA event just before every ``torch.cuda.synchronize``
    inside the block: the last one marks the end of the work enqueued by
    then."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        self._real = torch.cuda.synchronize

        def marked(device=None):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
            self._real(device)

        torch.cuda.synchronize = marked
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize = self._real
        return False


def flush_events(buf: io.StringIO, start: int):
    """The tracer's JSON-lines events written since character ``start``."""
    return [json.loads(line) for line in buf.getvalue()[start:].splitlines()]


def check_spans(buf, mark, t_rec, start, marks, spin_ms=None) -> dict:
    """Gate 6 on one flush of the kernel service: every service.flush and
    ingest.flush_cohort span has total >= dispatch; the card's time from a
    start event (recorded at host time ``t_rec``) to the flush's last
    synchronize lies inside the host interval from ``t_rec`` to the end of
    the last service.flush span.  That much holds whether or not
    ``Span.sync`` waits, since ``_flush_group`` synchronises inside its
    span.  What tests ``Span.sync`` is the spin: with a spin ahead of the
    flush, the first cohort span (whose own ``Span.sync`` is its only
    wait) lasts at least as long as the spin had left to run when the span
    opened; and ``check_span_sync``'s probe."""
    events = flush_events(buf, mark)
    flushes = [e for e in events if e["name"] == "service.flush"]
    cohorts = [e for e in events if e["name"] == "ingest.flush_cohort"]
    require(len(flushes) == len(SVC_GROUPS) and cohorts, f"spans of the flush: {len(flushes)}")
    for e in flushes + cohorts:
        require(e["total_ms"] >= e["dispatch_ms"], f"span {e['path']}: total < dispatch")
    require(bool(marks.events), "the flush never synchronised")
    device_ms = start.elapsed_time(marks.events[-1])
    end = max(e["ts"] + e["total_ms"] / 1e3 for e in flushes)
    host_ms = (end - t_rec) * 1e3
    require(device_ms <= host_ms + 0.01,
            f"flush: device {device_ms:.3f} ms outlasts its spans ({host_ms:.3f} ms)")
    out = {"device_ms": device_ms, "host_ms": host_ms,
           "flush_total_ms": sum(e["total_ms"] for e in flushes),
           "flush_dispatch_ms": sum(e["dispatch_ms"] for e in flushes)}
    if spin_ms is not None:
        first = min(cohorts, key=lambda e: e["ts"])
        left = spin_ms - (first["ts"] - t_rec) * 1e3
        require(first["total_ms"] >= left,
                f"cohort span {first['total_ms']:.3f} ms ended before the spin "
                f"({left:.3f} ms left): Span.sync did not wait for the card")
        out.update(spin_ms=spin_ms, spin_left_ms=left, cohort_total_ms=first["total_ms"],
                   cohort_dispatch_ms=first["dispatch_ms"])
    return out


def check_span_sync(device) -> dict:
    """``Span.sync`` alone: a span around a spin of the card and one small
    launch whose output it registers.  The body returns at once (dispatch
    shorter than the spin); the span's total covers the spin, timed by
    CUDA events recorded inside the span."""
    tracer = Tracer()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with tracer.span("probe") as sp:
        start.record()
        torch.cuda._sleep(int(SVC_PROBE_S * SLEEP_CYCLES_PER_S))
        stop.record()
        sp.sync(torch.ones(1, device=device) + 1)
    spin_ms = start.elapsed_time(stop)
    require(sp.dispatch_s * 1e3 < spin_ms <= sp.total_s * 1e3,
            f"Span.sync: dispatch {sp.dispatch_s * 1e3:.3f} ms, spin {spin_ms:.3f} ms, "
            f"total {sp.total_s * 1e3:.3f} ms")
    return {"probe_dispatch_ms": sp.dispatch_s * 1e3, "probe_spin_ms": spin_ms,
            "probe_total_ms": sp.total_s * 1e3}


def check_windows_w1_w3(svc, out) -> None:
    """W1: every SJPC total equals the sum of its live ring slots; W3: every
    window's n >= 0 and every clamped served estimate >= 0."""
    for e in svc.registry.streams():
        require(float(e.window.total.n) >= 0, f"W3: {e.name} n < 0")
        if e.estimator_kind == "sjpc":
            require(same_state(e.window.ring_sum(), e.window.total),
                    f"W1: {e.name} total != ring sum")
    for r in result_cells(out):
        require(r.estimate >= 0 and bool((np.asarray(r.per_level) >= 0).all()),
                f"W3: {r.streams} s={r.s} estimate {r.estimate}")


def check_window_w2(svc, tenants, history) -> None:
    """W2: each SJPC total equals a sketch rebuilt from only the live
    epochs' records under ``ingest_key(cfg, uid, round)``: one multi-round
    ingest per group from empty states."""
    live = list(range(SVC_EPOCHS - SVC_WINDOW + 1, SVC_EPOCHS))
    per_epoch = SVC_ROWS // SVC_BATCH_ROWS
    for group in SVC_GROUPS:
        members = [t for t in tenants if t[1] == group and t[2] == "sjpc"]
        est = svc.registry.group(group).estimator("sjpc")
        values = np.stack([np.concatenate([history[ep][name] for ep in live])
                           .reshape(len(live) * per_epoch, SVC_BATCH_ROWS, 6)
                           for name, *_ in members], axis=1)
        mask = np.ones(values.shape[:3], np.int32)
        rounds = np.broadcast_to(np.arange(live[0] * per_epoch, (live[-1] + 1) * per_epoch)
                                 [:, None], values.shape[:2])
        keys = ingest_key_grid(est.ingest_seed, [t[3] for t in members], rounds)
        rebuilt = est.ingest_rounds(E.stack_states([est.init() for _ in members]), values,
                                    mask, keys)
        for i, (name, *_) in enumerate(members):
            total = svc.registry.stream(name).window.total
            require(equal(rebuilt.counters[i], total.counters)
                    and equal(rebuilt.n[i], total.n), f"W2: {name} != the live epochs' rebuild")
    log(f"service W2: {len(SVC_GROUPS) * SVC_SJPC} SJPC windows equal a rebuild from only "
        f"the live epochs {live} under ingest_key")


@contextlib.contextmanager
def timed_stage(stages: dict, name: str):
    """Adds the host seconds of the block to ``stages[name]``."""
    t0 = time.perf_counter()
    yield
    stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0


def phase_service(device) -> dict:
    """The multi-tenant service at the DBLPtitles group: 288 tenants in two
    hash groups of the paper config, 4,096 records each per epoch, 6
    epochs over a 4-epoch window, 928 standing queries polled twice per
    epoch.  Gates: a plain twin (``impl="torch_ref"``) of a pinned-uid
    subset of every kind and both groups, bit for bit; an unfused service
    over 16 SJPC tenants, bit for bit; W1-W3; a twin of the subset with
    planner and observability off, and the planner alone off at the end,
    giving the same results; every dispatch on the kernels; the spans'
    device-inclusive totals.  The kernel service's calls alone count as
    path ``service``, the unfused service's as ``service_unfused``.
    Returns both paths' launch counts."""
    stages: dict[str, float] = {}

    stage = functools.partial(timed_stage, stages)
    t_phase = time.perf_counter()
    tenants = service_tenants()
    queries = service_queries(tenants)
    subset = [t for t in tenants if t[4] < (SVC_TWIN_SJPC if t[2] == "sjpc" else SVC_TWIN_SAMPLE)]
    unfused_tenants = [t for t in tenants if t[1] == SVC_GROUPS[0]][:SVC_UNFUSED]
    trace = io.StringIO()
    with stage("construction"):
        main = make_service(tenants, queries, obs=private_obs(sink=trace))
        quiet = make_service(subset, queries, observe=False, use_planner=False)
        plain = make_service(subset, queries, obs=private_obs(), impl="torch_ref")
        unfused = make_service(unfused_tenants, (), obs=private_obs(), use_fused=False)
    require(main.device.type == "cuda" and main.cfg.impl is None, "service device")
    log(f"service: {len(tenants)} tenants ({2 * SVC_SJPC} sjpc in {len(SVC_GROUPS)} groups, "
        f"{SVC_SAMPLE} reservoir with backing_epochs={SVC_BACKING}, {SVC_SAMPLE} lsh_ss), "
        f"{len(queries)} standing queries; plain twin and planner/observability-off twin "
        f"{len(subset)} tenants each, unfused {len(unfused_tenants)}")
    history = []
    timing = {"flush": [], "poll": [], "poll_cached": [], "snapshot": [], "advance": []}
    with stage("span probe"):
        spans = [check_span_sync(device)]
    counted, unfused_counted = PathCounts(), PathCounts()
    metrics_main = main.obs.metrics
    for epoch in range(SVC_EPOCHS):
        with stage("records"):
            recs = service_records(tenants, epoch)
        history.append({t[0]: recs[t[0]] for t in tenants if t[2] == "sjpc"})
        with stage("ingest (buffering)"):
            with counted.run():
                for name, *_ in tenants:
                    main.ingest(name, recs[name])
            with unfused_counted.run():
                for name, *_ in unfused_tenants:
                    unfused.ingest(name, recs[name])
            for svc, held in ((quiet, subset), (plain, subset)):
                for name, *_ in held:
                    svc.ingest(name, recs[name])
        # the kernel service's flush, timed and traced; epoch 0 behind a spin
        mark = len(trace.getvalue())
        torch.cuda.synchronize()
        start, spin_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_rec = time.time()
        start.record()
        if epoch == 0:
            torch.cuda._sleep(int(SVC_SPIN_S * SLEEP_CYCLES_PER_S))
        spin_end.record()
        with counted.run(), SyncMarks() as marks:
            t0 = time.perf_counter()
            main.flush()
        torch.cuda.synchronize()
        timing["flush"].append(time.perf_counter() - t0)
        spin_ms = start.elapsed_time(spin_end) if epoch == 0 else None
        spans.append(check_spans(trace, mark, t_rec, start, marks, spin_ms))
        with counted.run():
            seconds, _ = synced_s(main.advance_epoch)
        timing["advance"].append(seconds)
        with counted.run():
            seconds, out = synced_s(main.poll)
        timing["poll"].append(seconds)
        # a second poll with no new data: all cache hits, no launch
        before = (metrics_main.counter_total("query_cache_misses_total"),
                  metrics_main.counter_total("query_cache_hits_total"))
        with counted.run():
            seconds, again = synced_s(main.poll)
            cached_launches = (kfq.launches, kpairs.launches)
        timing["poll_cached"].append(seconds)
        require(metrics_main.counter_total("query_cache_misses_total") == before[0]
                and metrics_main.counter_total("query_cache_hits_total") > before[1]
                and cached_launches == (0, 0) and same_results(out, again, out),
                f"service epoch {epoch}: the second poll was not all cache hits")
        with counted.run():
            seconds, _ = synced_s(main.snapshot)
        timing["snapshot"].append(seconds)
        with stage("unfused"), unfused_counted.run():
            unfused.flush()
            unfused.advance_epoch()
            torch.cuda.synchronize()
        with stage("planner/observability-off twin"):
            quiet.flush()
            quiet.advance_epoch()
            quiet_out = quiet.poll()
        with stage("plain twin"), oracle_calls():
            plain.flush()
            plain.advance_epoch()
            plain_out = plain.poll()
        with stage("gates"):
            # gate 1: the plain twin, bit for bit
            for name, *_ in subset:
                require(same_state(main.registry.stream(name).window.total,
                                   plain.registry.stream(name).window.total),
                        f"service epoch {epoch}: {name} window != the plain twin's")
            require(same_results(out, plain_out, plain_out),
                    f"service epoch {epoch}: results != the plain twin's")
            # gate 2: unfused counters
            for name, *_ in unfused_tenants:
                require(same_state(main.registry.stream(name).window.total,
                                   unfused.registry.stream(name).window.total),
                        f"service epoch {epoch}: {name} unfused window != fused")
            # gate 4: planner and observability off
            require(same_results(out, quiet_out, quiet_out),
                    f"service epoch {epoch}: results with planner and obs off differ")
            check_windows_w1_w3(main, out)
    for name in ("flush", "advance", "poll", "poll_cached", "snapshot"):
        stages[f"main {name}"] = sum(timing[name])
    per_epoch = SVC_ROWS // SVC_BATCH_ROWS
    main_calls = SVC_EPOCHS * per_epoch * len(SVC_GROUPS) * SVC_SJPC
    launches = read_counts("service", ("fused_ingest", "sample_weights", "fused_query",
                                       "fused_pairs"), sampling_calls=main_calls, counts=counted)
    require(launches["fused_ingest"] == main_calls
            and launches["fingerprint"] == launches["sketch_update"] == 0,
            f"service: {launches['fused_ingest']} fused_ingest launches for {main_calls} SJPC "
            f"update calls, {launches['fingerprint']} fingerprint and "
            f"{launches['sketch_update']} sketch_update on the fused path")
    unfused_calls = SVC_EPOCHS * per_epoch * SVC_UNFUSED
    unfused_launches = read_counts("service_unfused", ("sample_weights", "fingerprint",
                                                       "sketch_update"),
                                   sampling_calls=unfused_calls, counts=unfused_counted)
    require(unfused_launches["fused_ingest"] == 0,
            f"service_unfused: {unfused_launches['fused_ingest']} fused_ingest launches")
    with stage("W2 rebuild"):
        check_window_w2(main, tenants, history)
    with stage("planner-off check"):
        # the planner alone off, at the last state
        snap = svc_mod.QueryEngine(main.registry).snapshot()
        snap.prefetch(main._continuous.values())
        off = {name: q.evaluate(snap) for name, q in main._continuous.items()}
        require(same_results(out, off, out), "service: planner-off results differ")
    log(f"service gates: plain twin ({len(subset)} tenants, every kind, both groups) and "
        f"unfused ({len(unfused_tenants)} tenants) bit-equal at every epoch; W1, W3 at every "
        f"epoch; planner and observability off ({len(quiet_out)} queries) at every epoch and "
        f"the planner alone off at the end equal; {len(out)} queries, "
        f"{sum(1 for _ in result_cells(out))} result cells")
    stages["unstaged"] = time.perf_counter() - t_phase - sum(stages.values())
    return {"launches": launches, "launches_unfused": unfused_launches, "timing": timing,
            "spans": spans, "stages": stages, "main": main, "tenants": tenants}


def service_numbers(svc_out, smi: str) -> None:
    """Printed, not gated: flush throughput, poll / snapshot /
    advance_epoch latencies, the flush time with observability on over
    off, and one torch.profiler capture of a flush and of a poll.  All of
    it after the gated run, so not counted."""
    timing, main, tenants = svc_out["timing"], svc_out["main"], svc_out["tenants"]
    stages = svc_out["stages"]
    steady = slice(1, None)            # epoch 0's flush ran behind the spin
    per_flush = len(tenants) * SVC_ROWS
    flush_med = float(np.median(timing["flush"][steady]))
    p50 = {k: float(np.median(v[steady])) * 1e3 for k, v in timing.items()}
    log(f"service ({smi}): flush {per_flush} records in {flush_med * 1e3:.1f} ms median "
        f"(epochs 1-{SVC_EPOCHS - 1}, host clock to a synchronise): {per_flush / flush_med:.0f} "
        f"records/s; all flushes (s): {' '.join(f'{x:.4f}' for x in timing['flush'])}")
    log(f"service ({smi}): p50 poll {p50['poll']:.2f} ms, cached poll {p50['poll_cached']:.2f} "
        f"ms, snapshot {p50['snapshot']:.2f} ms, advance_epoch {p50['advance']:.2f} ms "
        f"(epochs 1-{SVC_EPOCHS - 1})")
    log("service span probe: " + ", ".join(f"{k} {v:.3f}" for k, v in svc_out["spans"][0].items()))
    for i, sp in enumerate(svc_out["spans"][1:]):
        log(f"service spans epoch {i}: " + ", ".join(f"{k} {v:.3f}" for k, v in sp.items()))

    stage = functools.partial(timed_stage, stages)
    # observability on over off: two fresh services of the same tenants and
    # age (no queries), one observed as the kernel service is, one with
    # observe=False, given one more epoch's records and flushed in the
    # order on, off (each one's first flush, not timed), then on, off,
    # off, on, the same records again before each flush
    with stage("numbers: records"):
        recs = service_records(tenants, SVC_EPOCHS)
    with stage("numbers: observability on/off"):
        lit = make_service(tenants, (), obs=private_obs(sink=io.StringIO()))
        dark = make_service(tenants, (), observe=False)
        flush_s = {True: [], False: []}
        for i, svc in enumerate((lit, dark, lit, dark, dark, lit)):
            for name, *_ in tenants:
                svc.ingest(name, recs[name])
            seconds, _ = synced_s(svc.flush)
            if i >= 2:
                flush_s[svc is lit].append(seconds)
        del lit, dark
    on, off = flush_s[True], flush_s[False]
    log(f"service ({smi}): observability on/off flush time {sum(on) / sum(off):.4f} (on "
        f"{' '.join(f'{x * 1e3:.1f}' for x in on)} ms, off "
        f"{' '.join(f'{x * 1e3:.1f}' for x in off)} ms; two fresh services of the "
        f"{len(tenants)} tenants given one more epoch's records, after one untimed flush "
        f"each)")
    with stage("numbers: profiled flush"):
        for name, *_ in tenants:
            main.ingest(name, recs[name])
        seconds, busy, top, _, dtoh = profiled(main.flush, host_ops=False)
    log_profile(f"service flush ({per_flush} records, {smi})", seconds, busy, top)
    log(f"service flush: {dtoh} device-to-host copies")
    with stage("numbers: profiled polls"):
        seconds, busy, top, _, dtoh = profiled(main.poll, host_ops=False)
        log_profile(f"service poll (fresh, {len(main._continuous)} queries, {smi})", seconds,
                    busy, top)
        log(f"service poll: {dtoh} device-to-host copies (synchronising reads) per fresh poll")
        seconds, _, _, _, dtoh = profiled(main.poll, host_ops=False)
        log(f"service poll (cached): {seconds * 1e3:.2f} ms host, {dtoh} device-to-host copies")
    with stage("numbers: describe, metrics report"):
        groups, lines = len(main.describe()["groups"]), len(main.metrics_report().splitlines())
    log(f"service describe: {groups} groups; metrics report {lines} lines")
    log("service phase host seconds by stage: " + "; ".join(
        f"{k} {v:.2f}" for k, v in sorted(stages.items(), key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# the distributed service
# ---------------------------------------------------------------------------

class RecordingWorker(LocalWorker):
    """An in-process worker handle that keeps every export payload it
    returns to the coordinator."""

    def __init__(self):
        super().__init__()
        self.exports: list[bytes] = []
        self._op = None

    def send(self, op: int, body: bytes = b"") -> None:
        self._op = op
        super().send(op, body)

    def recv(self) -> bytes:
        payload = super().recv()
        if self._op == OP_EXPORT:
            self.exports.append(payload)
        return payload


def check_frames(workers) -> int:
    """Every bundle the workers exported: decoded by the port and encoded
    again, the same bytes; every leaf's dtype the JAX package's.  Returns
    the number of delta frames checked."""
    frames = 0
    for w, handle in enumerate(workers):
        for cycle, payload in enumerate(handle.exports):
            msgs = wire.decode_bundle(payload)
            require(msgs is not wire.HEARTBEAT and len(msgs) == len(handle.runtime.service
                                                                   .registry.streams()),
                    f"distributed: worker {w} cycle {cycle} did not export every tenant")
            again = wire.encode_bundle([wire.encode_delta(m) for m in msgs])
            require(again == payload,
                    f"distributed: worker {w} cycle {cycle}: decode + encode changed the bundle")
            # the bytes re-encode exactly, so each leaf's dtype on the wire is
            # the one the encoder gives the decoded leaf
            for m in msgs:
                want = WIRE_DTYPES.get(m.kind, {})
                for name in m.state._fields:
                    dt = wire._leaf_bytes(getattr(m.state, name), name)[0]
                    require(dt == want.get(name, "<i4"),
                            f"distributed: {m.kind} leaf {name} is {dt} on the wire, "
                            f"not {want.get(name, '<i4')}")
                frames += 1
    return frames


def sync_breakdown(coord, spec, smi: str) -> None:
    """One more cycle of (a)'s cluster with its sync taken apart, host
    clock to a synchronise: each worker's flush, its export (deltas and
    encoding), the coordinator's decode, and the apply of each message
    into the replica by kind; then the apply of the whole cycle under the
    profiler (the card's busy share).  Printed, not gated, after the
    gates; not counted."""
    names = [st["name"] for st in spec.streams]
    kinds = {st["name"]: st["estimator"] for st in spec.streams}
    for uid, name in enumerate(names):
        coord.ingest(name, harness.scaleout_records(uid, harness.SCALEOUT_CYCLES))
    stages = dict.fromkeys(("worker flush", "worker export + encode", "decode"), 0.0)
    apply_ms = {kind: [] for kind in set(kinds.values())}
    bundles = []
    for h in coord.workers:
        runtime = h.runtime
        seconds, _ = synced_s(runtime.service.flush)
        stages["worker flush"] += seconds
        seconds, payload = synced_s(runtime.export)
        stages["worker export + encode"] += seconds
        seconds, msgs = synced_s(lambda: wire.decode_bundle(payload))
        stages["decode"] += seconds
        bundles.append(msgs)
    replica = coord.replicas[0]

    def apply(msg):
        replica.apply_remote_delta(msg.stream, wire.mode_name(msg.mode),
                                   wire.state_to(msg.state, replica.device))

    for msgs in bundles[:1]:
        for msg in msgs:
            seconds, _ = synced_s(lambda: apply(msg))
            apply_ms[msg.kind].append(seconds * 1e3)
    seconds, busy, top, _, dtoh = profiled(
        lambda: [apply(msg) for msgs in bundles[1:] for msg in msgs], host_ops=False)
    log(f"distributed sync breakdown ({smi}; one more cycle of (a), {len(bundles)} workers, "
        f"host clock to a synchronise): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()) + "; apply per message "
        f"(worker 0's bundle), median ms: " + ", ".join(
            f"{k} {float(np.median(v)):.3f} ({len(v)} messages, {sum(v):.1f} ms in all)"
            for k, v in sorted(apply_ms.items()) if v))
    log_profile(f"distributed apply of worker 1's bundle ({len(bundles[1])} messages, {smi})",
                seconds, busy, top)
    log(f"distributed apply: {dtoh} device-to-host copies")


def phase_distributed(smi: str) -> dict:
    """The multi-host service on one card: (a) two in-process workers and
    a coordinator, held against the single-process oracle on the card;
    (b) 1, 2 and 4 worker processes on the card over the same records,
    each held against (a)'s oracle; (c) every bundle (a) exported decoded
    and encoded again to the same bytes, each leaf in the JAX package's
    dtype.  Returns the launches of paths ``distributed`` (the cluster of
    (a), its standing-query polls included) and ``distributed_oracle``."""
    t_phase = time.perf_counter()
    tenants, cycles = harness.SCALEOUT_TENANTS, harness.SCALEOUT_CYCLES
    spec = harness.scaleout_spec()
    require(spec.groups[0][1] == PAPER_DEFAULTS and "device" not in spec.service,
            "distributed: the spec is not the paper group on the card")
    names = [st["name"] for st in spec.streams]
    kinds = [st["estimator"] for st in spec.streams]
    n_sjpc = kinds.count("sjpc")
    batches = harness.scaleout_batches(spec)
    per_cycle = tenants * harness.SCALEOUT_ROWS
    log(f"distributed: {tenants} tenants ({n_sjpc} sjpc, {kinds.count('reservoir')} "
        f"reservoir, {kinds.count('lsh_ss')} lsh_ss, sample kinds with backing_epochs="
        f"{harness.SCALEOUT_BACKING}), {per_cycle} records a cycle, {cycles} cycles, "
        f"window {harness.SCALEOUT_WINDOW}, rounds of {harness.SCALEOUT_BATCH_ROWS}; "
        f"records made in {time.perf_counter() - t_phase:.1f} s")

    # (a) two in-process workers, the coordinator and its replica on the card
    counted, oracle_counted = PathCounts(), PathCounts()
    workers = [RecordingWorker() for _ in range(2)]
    cycle_s, sync_s, poll_s = [], [], []
    with counted.run():
        coord = Coordinator(spec, workers)
        for name in names:
            coord.register_continuous(svc_mod.ContinuousQuery(f"all/{name}", "all_thresholds",
                                                              (name,)))
        for c in range(cycles):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for name in names:
                coord.ingest(name, batches[name][c])
            ts = time.perf_counter()
            stats = coord.sync()
            cycle_s.append(time.perf_counter() - t0)
            sync_s.append(time.perf_counter() - ts)
            require(stats["deltas"] == tenants and stats["heartbeats"] == 0,
                    f"distributed cycle {c}: {stats}")
            seconds, out = synced_s(coord.poll)
            poll_s.append(seconds)
            require(len(out) == tenants and all(
                math.isfinite(r.estimate) and r.estimate >= 0 and not r.stale
                for r in result_cells(out)), f"distributed cycle {c}: poll results")
            coord.advance_epoch()
        torch.cuda.synchronize()
    require(all(h.runtime.service.device.type == "cuda" for h in workers)
            and coord.replicas[0].device.type == "cuda", "distributed: a service is off the card")
    calls = cycles * (harness.SCALEOUT_ROWS // harness.SCALEOUT_BATCH_ROWS) * n_sjpc
    launches = read_counts("distributed", ("fused_ingest", "sample_weights", "fused_query",
                                           "fused_pairs"), sampling_calls=calls, counts=counted)
    require(launches["fused_ingest"] == calls,
            f"distributed: {launches['fused_ingest']} fused_ingest launches, predicted {calls}")
    with oracle_counted.run():
        oracle = harness.run_oracle(spec, batches, cycles=cycles)
        torch.cuda.synchronize()
    oracle_launches = read_counts("distributed_oracle", ("fused_ingest", "sample_weights"),
                                  sampling_calls=calls, counts=oracle_counted)
    require(oracle_launches["fused_ingest"] == calls,
            f"distributed_oracle: {oracle_launches['fused_ingest']} fused_ingest launches")
    agree = harness.compare_to_oracle(coord, oracle, spec)
    require(agree["linear_exact"] and agree["worst_rel_err"] <= 1e-6,
            f"distributed: the in-process cluster diverged from the oracle: {agree}")
    m = coord.obs.metrics
    steady = float(np.median(cycle_s[1:]))
    log(f"distributed (a) ({smi}): 2 in-process workers match the oracle on the card "
        f"(linear counters and n, sample windows bit for bit; worst estimate rel err "
        f"{agree['worst_rel_err']:.3e}); cycle (route + flush + export + merge) "
        f"{' '.join(f'{x:.3f}' for x in cycle_s)} s, of which sync (flush + export + merge) "
        f"{' '.join(f'{x:.3f}' for x in sync_s)} s; {per_cycle / steady:.0f} records/s "
        f"median of cycles 1-{cycles - 1}; poll of {tenants} standing "
        f"queries p50 {float(np.median(poll_s)) * 1e3:.2f} ms; merge p50/p95 "
        f"{harness._hist_quantile(m, 'coordinator_merge_seconds', 0.5) * 1e3:.1f}/"
        f"{harness._hist_quantile(m, 'coordinator_merge_seconds', 0.95) * 1e3:.1f} ms "
        f"(histogram bucket bounds)")

    # (c) the frames (a) exported
    frames = check_frames(workers)
    log(f"distributed (c): {sum(len(h.exports) for h in workers)} bundles, {frames} delta "
        f"frames decode and encode to the same bytes; leaf dtypes as the JAX package writes "
        f"them ({WIRE_DTYPES}, every other leaf <i4)")
    sync_breakdown(coord, spec, smi)
    coord.close()
    del coord, workers
    torch.cuda.empty_cache()

    # (b) worker processes on the card, each run against (a)'s oracle
    log("distributed (b): the worker processes' kernel launches are not counted (each child "
        "has its own counts); each run is held against the oracle above")
    scale = harness.run_scaleout(spec, batches, oracle, DIST_WORKERS, cycles=cycles)
    for key, row in scale.items():
        log(f"distributed (b) {key} ({smi}): {row['rec_per_s']:.0f} records/s "
            f"({row['records']} records in {row['ingest_s']:.3f} s), speedup over 1 worker "
            f"{row['speedup_vs_1w']:.3f}, merge p50/p95 {row['merge_p50_s'] * 1e3:.1f}/"
            f"{row['merge_p95_s'] * 1e3:.1f} ms, freshness lag p50/p95 "
            f"{row['freshness_p50_s'] * 1e3:.1f}/{row['freshness_p95_s'] * 1e3:.1f} ms "
            f"(histogram bucket bounds); sync (flush + export + merge) per cycle "
            f"{' '.join(f'{x:.4f}' for x in row['sync_s'])} s; oracle: linear_exact "
            f"{row['linear_exact']}, worst rel err {row['worst_rel_err']:.3e}")
    del oracle
    torch.cuda.empty_cache()
    log(f"distributed phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "launches_oracle": oracle_launches}


# ---------------------------------------------------------------------------
# the accuracy cell
# ---------------------------------------------------------------------------

def phase_accuracy(device, smi: str) -> dict[str, int]:
    """SJPC against its equal-space competitors on the planted-cluster
    workload: five hash draws of SJPC through ``update_fused`` and
    ``estimate_batch`` (the first held against its ``impl="torch_ref"``
    twin on the card), random sampling at the sketch's bytes, the served
    reservoir beside a served SJPC stream, and LSH-SS.  Only finiteness and
    non-negativity are gated; the errors are printed.  Returns the
    launches of path ``accuracy``."""
    t_phase = time.perf_counter()
    vals = planted_cluster_records(ACC_N, ACC_D, np.random.default_rng(ACC_SEED),
                                   list(ACC_CLUSTERS))
    t0 = time.perf_counter()
    x_exact = exact.exact_pair_counts(vals)
    exact_s = time.perf_counter() - t0
    g_true = {s: float(x_exact[s:].sum() + ACC_N) for s in ACC_BAND}
    require(all(g > 3 * ACC_N for g in g_true.values()),
            f"accuracy: not the g_s >> n regime: {g_true}")
    log(f"accuracy: n = {ACC_N}, d = {ACC_D}, clusters {ACC_CLUSTERS}; exact g_4 = "
        f"{g_true[4]:.0f} ({g_true[4] / ACC_N:.2f} n), g_5 = {g_true[5]:.0f} "
        f"({g_true[5] / ACC_N:.2f} n), exact_pair_counts on the host in {exact_s:.1f} s")
    budget = sjpc.SJPCConfig(**ACC_CFG).counters_bytes
    sample = baselines.sample_size_for_bytes(budget, ACC_D * 4)
    counted = PathCounts()
    ests = {k: {s: [] for s in ACC_BAND}
            for k in ("sjpc", "random_sampling", "served_sjpc", "served_reservoir", "lsh_ss")}
    for i in range(ACC_TRIALS):
        cfg = sjpc.SJPCConfig(**ACC_CFG, seed=ACC_BASE_SEED + i)
        params, state = sjpc.init(cfg, device=device)
        key = prng.PRNGKey(40 + i)
        with counted.run():
            st = sjpc.update_fused(cfg, params, state, vals, key=key)
            be = sjpc.estimate_batch(cfg, st.counters[None], st.n[None])
        if i == 0:
            with oracle_calls():
                st_p = sjpc.update_fused(cfg, params, state, vals, key=key, impl="torch_ref")
                be_p = sjpc.estimate_batch(cfg, st_p.counters[None], st_p.n[None],
                                           impl="torch_ref")
            require(equal(st.counters, st_p.counters) and equal(st.n, st_p.n),
                    "accuracy: SJPC counters differ from the plain twin's")
            require(np.allclose(be.g, be_p.g, rtol=1e-6, atol=0),
                    f"accuracy: SJPC g {be.g} differs from the plain twin's {be_p.g}")
        for s in ACC_BAND:
            ests["sjpc"][s].append(float(be.g[0, s - cfg.s]))
        rng = np.random.default_rng(1000 + i)
        for s in ACC_BAND:
            ests["random_sampling"][s].append(baselines.random_sampling_g(vals, s, sample, rng))
    for t in range(ACC_TRIALS):
        cfg = sjpc.SJPCConfig(**ACC_CFG, seed=ACC_BASE_SEED + 50 + t)
        svc = svc_mod.EstimationService(svc_mod.ServiceConfig(
            batch_rows=ACC_SERVE_BATCH, window_epochs=None), obs=private_obs())
        svc.create_group("g", cfg)
        svc.create_stream("sjpc", "g")
        svc.create_stream("res", "g", estimator="reservoir")
        res_est = svc.registry.stream("res").estimator
        require(res_est.memory_bytes() <= budget and res_est.cfg.capacity < ACC_N // 8,
                "accuracy: the served reservoir is not equal-space and sublinear")
        for nm in ("sjpc", "res"):
            svc.ingest(nm, vals)
        with counted.run():
            snap = svc.snapshot()
            for nm, k in (("sjpc", "served_sjpc"), ("res", "served_reservoir")):
                for s in ACC_BAND:
                    ests[k][s].append(snap.self_join(nm, s).estimate)
        del svc, snap
    for t in range(ACC_LSH_TRIALS):
        rng = np.random.default_rng(4000 + t)
        for s in ACC_BAND:
            ests["lsh_ss"][s].append(baselines.lsh_ss_g(vals, s, rng, m_h=ACC_LSH_PAIRS,
                                                        m_l=ACC_LSH_PAIRS))
    require(all(math.isfinite(e) and e >= 0 for k in ests.values() for v in k.values()
                for e in v), "accuracy: an estimate is not finite and non-negative")
    med = {k: {s: float(np.median([abs(e - g_true[s]) / g_true[s] for e in v[s]]))
               for s in ACC_BAND} for k, v in ests.items()}
    calls = ACC_TRIALS + ACC_TRIALS * -(-ACC_N // ACC_SERVE_BATCH)
    launches = read_counts("accuracy", ("fused_ingest", "sample_weights", "fused_query",
                                        "fused_pairs"), sampling_calls=calls, counts=counted)
    log(f"accuracy ({smi}): median relative error of g_s, SJPC at {budget} counter bytes "
        f"(d={ACC_D}, s={ACC_CFG['s']}, r={ACC_CFG['ratio']}, w={ACC_CFG['width']}, "
        f"t={ACC_CFG['depth']}), random sampling of {sample} records, the served reservoir "
        f"of {res_est.cfg.capacity} records, LSH-SS with m_h = m_l = {ACC_LSH_PAIRS}:")
    for k, per_s in med.items():
        trials = len(ests[k][ACC_BAND[0]])
        log(f"  {k:17s} ({trials} draws): " + ", ".join(
            f"s={s} {per_s[s]:.4f}" for s in ACC_BAND))
    for k in ("random_sampling", "served_reservoir", "lsh_ss"):
        ref_k = "served_sjpc" if k == "served_reservoir" else "sjpc"
        log(f"  {ref_k} beats {k}: " + ", ".join(
            f"s={s} {med[ref_k][s] < med[k][s]}" for s in ACC_BAND))
    log(f"accuracy phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_numbers(device, cfg, params, records, tenants, by_path, est_out):
    """Kernel, plain-version and library times at the main path's shapes,
    with the bound of each; ``by_path`` holds each path's launches."""
    _, state = sjpc.init(cfg, device=device)
    iargs, B, _ = sjpc.fused_ingest_args(cfg, params, state, records[:BATCH])
    _, values, masks, ids, _, _, _, wpad = iargs
    batch = records[:BATCH]
    dev_batch = as_field_tensor(batch, device)
    update_ms, args_ms, dev_update_ms = wall_ms(
        lambda: sjpc.update_fused(cfg, params, state, batch),
        lambda: sjpc.fused_ingest_args(cfg, params, state, batch),
        lambda: sjpc.update_fused(cfg, params, state, dev_batch))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    busy_ms, host_ms = device_ms(lambda: sjpc.update_fused(cfg, params, state, dev_batch), 100,
                                 flush)
    log(f"update_fused per batch of {BATCH}: {update_ms:.3f} ms, of which "
        f"{args_ms:.3f} ms builds the kernel's arguments (record upload, the "
        f"sample_weights launch; CUDA events around host and device work); "
        f"{dev_update_ms:.3f} ms with the batch already on the card, of which the card works "
        f"{busy_ms:.4f} ms (device time of all its launches, L2 flushed) and the host "
        f"{host_ms:.4f} ms per call: device idle share {1 - busy_ms / dev_update_ms:.3f}")
    L, t, w = state.counters.shape
    ks = [cfg.level_k(i) for i in range(L)]
    live = (wpad != 0).sum(dim=(0, 2)).tolist()
    ingest_ops = sum(n_live * (2 * k + 12 * t) for n_live, k in zip(live, ks))
    # the bytes of the function, field data at its uint32 width: the
    # records, each level's C(d, k) live combinations of the tables and of
    # the weights (the padded slots carry weight 0 by the op's contract and
    # are never read), the coefficients, the counters read and written
    n_live = sum(proj.padded_lattice(cfg.d, cfg.s).nums)
    ingest_bytes = ((values.numel() + n_live * (cfg.d + 1) + 2
                     + 2 * params.bucket_coeffs.numel()) * FIELD_BYTES
                    + B * n_live * 4 + 2 * state.counters.numel() * 4)
    sargs = (prng.PRNGKey(cfg.seed ^ 0xC0FFEE).to(device), state.step, None, B, cfg.d, cfg.s,
             cfg.ratio)
    sample_bytes, sample_ops = sampling_work(cfg, ref.sample_weights_ref(*sargs))

    level0 = proj.lattice(cfg.d, cfg.s)[0]
    fmasks = torch.from_numpy(level0.masks.astype(np.int64)).to(device)
    fids = torch.from_numpy(level0.ids.astype(np.int64)).to(device)
    fargs = (dev_batch, fmasks, fids, params.fp_bases)
    fp_ops = 2 * level0.k * B * level0.num
    fp_bytes = (dev_batch.numel() + fmasks.numel() + fids.numel() + 2
                + 2 * B * level0.num) * FIELD_BYTES

    q_rows = tenants.shape[0] * L * t
    q_ops = q_rows * w
    q_bytes = tenants.numel() * 4 + q_rows * 4
    tenants_f32 = tenants.float()
    pairs, update, moments = estimator_kernel_args(device, cfg, params, est_out)
    moments_f32 = moments[0][0].float()

    no_call = "no single PyTorch call computes it"
    vecdot = "torch.linalg.vecdot on float32 copies"
    rows = []
    for name, fn, plain, (args, nbytes, ops), library, library_note in (
            ("fused_ingest", kfi.fused_ingest, ref.fused_ingest_ref,
             (iargs, ingest_bytes, ingest_ops), None, no_call),
            ("sample_weights", ksw.sample_weights, ref.sample_weights_ref,
             (sargs, sample_bytes, sample_ops), None,
             "no single PyTorch call replays threefry2x32"),
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
        launches_by_path = {path: counts[name] for path, counts in by_path.items()}
        if name in CROSS_CHECK_ONLY:
            launches_by_path = {(f"{path}: {CROSS_CHECK_ONLY[name]}" if n else path): n
                                for path, n in launches_by_path.items()}
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
                     "replaces": REPLACES[name],
                     "launches": sum(counts[name] for counts in by_path.values()),
                     "launches_by_path": launches_by_path,
                     "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "library": library_note})
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms (host {host1:.4f}/{host2:.4f} ms "
            f"per call), plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {ops} int ops)"
            + (f", library {lib:.4f} ms" if lib is not None else ""))
    # fused_pairs at the path's other shapes: the 64-stream query, and the
    # 1,024-tenant query's bootstrap, whose 400 MB of stacked replicates
    # are made only now (after the other rows' timings) and freed at once
    pairs_row = next(row for row in rows if row["name"] == "fused_pairs")
    streams = est_out["reservoir"]
    time_pairs_shape(pairs_row, "streams", streams.items, (streams.tags >= 0).to(torch.int32),
                     flush)
    time_pairs_shape(pairs_row, "bootstrap", *bootstrap_pairs_args(device, cfg, est_out), flush)
    torch.cuda.empty_cache()
    time_moments_shapes(next(row for row in rows if row["name"] == "sketch_moments"), est_out,
                        flush, device)
    # the per-launch floor: an empty kernel between the same CUDA events
    f1, _ = device_ms(lambda: torch.cuda._sleep(0), 100, flush)
    f2, _ = device_ms(lambda: torch.cuda._sleep(0), 100, flush)
    for row in rows:
        if row["name"] in ("fused_query", "sketch_update", "sketch_moments"):
            row["launch_floor_ms"] = min(f1, f2)
    log(f"per-launch floor (torch.cuda._sleep(0) between the events): {f1:.4f}/{f2:.4f} ms, "
        f"beside fused_query, sketch_update and sketch_moments")
    # fused_ingest on the field data it reads, int32 words, without the
    # wrapper's narrowing of the records, which the row's ms includes
    words = iargs[:1] + tuple(kfi.words32(a) for a in iargs[1:7]) + iargs[7:]
    w1, _ = device_ms(lambda: kfi.fused_ingest(*words), 100, flush)
    w2, _ = device_ms(lambda: kfi.fused_ingest(*words), 100, flush)
    require(equal(kfi.fused_ingest(*words), ref.fused_ingest_ref(*iargs)),
            "fused_ingest on int32 words: timed output differs from the plain version")
    next(row for row in rows if row["name"] == "fused_ingest")["words_ms"] = min(w1, w2)
    log(f"time fused_ingest on int32 words (the kernel alone): {w1:.4f}/{w2:.4f} ms")
    rows += flash_rows(device, by_path, flush)
    return rows


def reset_counts() -> None:
    """Zero every kernel's launch count and the dispatch counters, just
    before a path runs."""
    for module, attr, _ in COUNTS.values():
        setattr(module, attr, 0)
    metrics.default_registry().clear()


def current_counts() -> tuple[dict[str, int], dict[tuple, float]]:
    """Every kernel's launch count and the ``kernel_dispatch_total`` series
    since the last ``reset_counts``."""
    launches = {name: getattr(module, attr) for name, (module, attr, _) in COUNTS.items()}
    return launches, dict(metrics.default_registry().series("kernel_dispatch_total"))


class PathCounts:
    """The counts of a path whose calls interleave with other work: each
    call runs inside ``run()``, which zeroes every count just before it
    and adds them up just after."""

    def __init__(self):
        self.launches = dict.fromkeys(COUNTS, 0)
        self.dispatch: dict[tuple, float] = {}

    @contextlib.contextmanager
    def run(self):
        reset_counts()
        yield
        launches, dispatch = current_counts()
        for name, n in launches.items():
            self.launches[name] += n
        for labels, n in dispatch.items():
            self.dispatch[labels] = self.dispatch.get(labels, 0.0) + n


def read_counts(path: str, kernels, sampling_calls: int | None = None,
                counts: PathCounts | None = None) -> dict[str, int]:
    """The launches of the path just run (or those ``counts`` added up).
    Raises unless each of its ``kernels`` launched, and unless every
    dispatch of the path resolved to the hand-written kernel; with
    ``sampling_calls``, unless the path's ``sample_weights`` dispatches and
    launches were exactly that many (one per SJPC update call)."""
    torch.cuda.synchronize()
    launches, series = ((counts.launches, counts.dispatch) if counts is not None
                        else current_counts())
    dispatch: dict[str, float] = {}
    for labels, count in series.items():
        label = dict(labels)
        require(label["impl"] == registry.CUDA_SM90,
                f"{path}: {label['kernel']} resolved to {label['impl']}")
        dispatch[label["kernel"]] = dispatch.get(label["kernel"], 0.0) + count
    log(f"{path} path launches: {launches}")
    log(f"{path} path dispatches (all {registry.CUDA_SM90}): {dispatch}")
    for name in kernels:
        require(launches[name] > 0, f"{name} was not launched on the {path} path")
    for op in KERNELS:
        count = sum(launches[name] for name, (_, _, of) in COUNTS.items() if of == op)
        require(dispatch.get(op, 0) >= count, f"{path}: {op} launched without a dispatch")
    if sampling_calls is not None:
        require(dispatch.get("sample_weights", 0) == launches["sample_weights"]
                == sampling_calls,
                f"{path}: {dispatch.get('sample_weights', 0)} sample_weights dispatches and "
                f"{launches['sample_weights']} launches for {sampling_calls} SJPC update calls")
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
    n_batches = RECORDS // BATCH
    by_path = {"stream": read_counts("stream", ("fused_ingest", "sample_weights", "fingerprint",
                                                "fused_query"),
                                     # update_fused and the per-level update per batch
                                     sampling_calls=2 * n_batches)}
    check_no_host_reads(cfg, params, device, records)
    reset_counts()
    est_out = phase_estimators(device, cfg)
    # every SJPC ingest call: the fused path's rounds of A, the rest of the
    # full stream and B over every stream, and the unfused path's rounds
    sjpc_calls = (EST_ROUNDS + EST_ROUNDS // 2) * EST_STREAMS + EST_ROUNDS * UNFUSED_STREAMS
    by_path["estimators"] = read_counts("estimators", tuple(k for k in KERNELS
                                                             if k != "flash_attention"),
                                        sampling_calls=sjpc_calls)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    t_service = time.perf_counter()
    svc_out = phase_service(device)
    by_path["service"] = svc_out["launches"]
    by_path["service_unfused"] = svc_out["launches_unfused"]
    service_numbers(svc_out, smi)
    del svc_out
    torch.cuda.empty_cache()
    log(f"service phase: {time.perf_counter() - t_service:.1f} s")
    dist_out = phase_distributed(smi)
    by_path["distributed"] = dist_out["launches"]
    by_path["distributed_oracle"] = dist_out["launches_oracle"]
    by_path["accuracy"] = phase_accuracy(device, smi)
    torch.cuda.empty_cache()
    serve_out = phase_serve(device)
    by_path["serve"] = serve_out["launches"]
    by_path["serve_bf16"] = serve_out["launches_bf16"]

    rows = phase_numbers(device, cfg, params, records, tenants, by_path, est_out)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
