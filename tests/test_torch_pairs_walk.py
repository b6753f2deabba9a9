"""numpy emulations of the CUDA kernels ``csrc/fused_pairs.cu`` and
``csrc/sketch_update.cu``, held against the JAX package's Pallas kernels in
interpret mode, the way its own tests run them.

The fused_pairs emulation replays the kernel's walk: chunks of kChunk slots
staged with their live rows only, kRows i-rows per thread (the limits read
from the kernel's source), the balanced pairing of i-tile T-1-y with y, the triangle as loop bounds, and
8-bit bins in 64-bit registers widened after each chunk.  It records every
(i, j) it compares, so each test also shows that every unordered live pair
is met exactly once.  The sketch_update emulation replays the kernel's
reduction: the counters copied into the output, each CTA's own plane of
its keys, every plane's non-zero entries added into the output after the
grid barrier, all in uint32 that wraps as int32."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_cases import PAIRS_SHAPES, pairs_case, sketch_update_case
from repro.kernels.fused_pairs import fused_pairs_pallas
from repro.kernels.sketch_update import sketch_update_pallas
from repro_torch.core.hashing import cw_hash_pair, hash_bucket, hash_sign
from repro_torch.kernels import fused_pairs as kpairs

MASK64 = (1 << 64) - 1
CSRC = Path(kpairs.__file__).parent / "csrc"


def _kernel_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of one of the kernels' sources."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CHUNK = _kernel_constant("fused_pairs.cu", "kChunk")
ROWS = _kernel_constant("fused_pairs.cu", "kRows")
SMALL_CHUNKS = _kernel_constant("fused_pairs.cu", "kSmallChunks")
MAX_BLOCKED_D = _kernel_constant("fused_pairs.cu", "kMaxBlockedD")


# ---------------------------------------------------------------------------
# fused_pairs
# ---------------------------------------------------------------------------

class _Bins:
    """One i-row's packed bins for one chunk, as the kernel keeps them:
    bins 0-7 in 8-bit fields of a 64-bit word (lo), 8-15 in another (hi),
    16 alone (top); added per pair as 1 << (8 x matches)."""

    def __init__(self):
        self.lo = self.hi = self.top = self.pairs = 0

    def add(self, m: np.ndarray) -> None:
        # the sum of the pairs' 1 << (8 m), mod 2^64, in any order
        counts = np.bincount(m, minlength=17)
        self.lo = (self.lo + sum(int(c) << (8 * k) for k, c in enumerate(counts[:8]))) & MASK64
        self.hi = (self.hi + sum(int(c) << (8 * k) for k, c in enumerate(counts[8:16]))) & MASK64
        self.top += int(counts[16])
        self.pairs += m.size

    def widen(self, hist: np.ndarray, live: bool, chunk: int) -> None:
        assert self.pairs <= chunk < 256          # no 8-bit field can overflow
        for k in range(hist.shape[0]):
            word, shift = (self.lo, 8 * k) if k < 8 else (self.hi, 8 * (k - 8))
            field = self.top if k == 16 else (word >> shift) & 0xFF
            hist[k] += field if live else 0
        self.lo = self.hi = self.top = self.pairs = 0


def rows_per_thread(R: int, d: int) -> int:
    """The C entry's i-rows per thread for samples of R slots of d columns."""
    return 1 if -(-R // CHUNK) <= SMALL_CHUNKS or d > MAX_BLOCKED_D else ROWS


def emulate_fused_pairs(items, valid, chunk=CHUNK, rows=None):
    """The kernel's histograms (N, d+1), and the (N, R, R) count of how
    often each (i, j) slot pair was compared by a live i-row; ``rows``
    i-rows per thread (None: the kernel's choice for R and d)."""
    items = np.asarray(items, np.uint32)
    valid = np.asarray(valid) != 0
    N, R, d = items.shape
    rows = rows_per_thread(R, d) if rows is None else rows
    n_chunks = -(-R // chunk)
    n_tiles = -(-R // (rows * chunk))
    out = np.zeros((N, d + 1), np.int64)
    met = np.zeros((N, R, R), np.int64)
    for n in range(N):
        for y in range((n_tiles + 1) // 2):           # one CTA per y
            hist = np.zeros((chunk, d + 1), np.int64)  # each thread's histogram
            for tile in dict.fromkeys((n_tiles - 1 - y, y)):
                c0 = tile * rows
                own = [None] * rows                   # each i-row's slots, a chunk's live rows
                for c in range(c0, n_chunks):
                    slots = np.arange(c * chunk, min((c + 1) * chunk, R))
                    live_slots = slots[valid[n, slots]]           # the staged, compacted rows
                    live = live_slots.size
                    staged = items[n, live_slots]
                    q = c - c0
                    if q < rows:
                        own[q] = live_slots
                    for t in range(chunk):
                        # (begin, end, rows compared) of thread t in this chunk
                        if q < rows:
                            walks = [(0, min(t + 1, live), q), (t + 1, live, q + 1)]
                        else:
                            walks = [(0, live, rows)]
                        bins = [_Bins() for _ in range(rows)]
                        for begin, end, active in walks:
                            if end <= begin:
                                continue
                            for k in range(active):
                                mine = own[k]
                                if t < mine.size:
                                    row, slot = items[n, mine[t]], mine[t]
                                else:                     # a dead row: compared, dropped
                                    row, slot = np.zeros(d, np.uint32), None
                                bins[k].add((staged[begin:end] == row[None]).sum(axis=1))
                                if slot is not None:
                                    met[n, slot, live_slots[begin:end]] += 1
                        for k in range(rows):
                            bins[k].widen(hist[t], own[k] is not None and t < own[k].size,
                                          chunk)
            out[n] += 2 * hist.sum(axis=0)
    return out, met


def _check_walk(items, valid, **tiling):
    got, met = emulate_fused_pairs(items, valid, **tiling)
    live = np.asarray(valid) != 0
    # every unordered live pair exactly once, in one of its two orders
    pairs = live[:, :, None] & live[:, None, :]
    pairs &= ~np.eye(live.shape[1], dtype=bool)[None]
    assert met.max(initial=0) <= 1
    np.testing.assert_array_equal(met + met.transpose(0, 2, 1), pairs.astype(np.int64))
    want = np.asarray(fused_pairs_pallas(items, valid, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_walk_constants_are_the_kernels():
    """The emulation's choice of i-rows per thread is the C entry's rule,
    on the limits read from the source."""
    text = (CSRC / "fused_pairs.cu").read_text()
    assert "const int rows = n_chunks <= kSmallChunks || D > kMaxBlockedD ? 1 : kRows;" in text
    assert (CHUNK, ROWS, SMALL_CHUNKS, MAX_BLOCKED_D) == (128, 2, 2, 12)
    assert [rows_per_thread(R, 6) for R in (1, 256, 257, 1755)] == [1, 1, 2, 2]
    assert [rows_per_thread(1755, d) for d in (12, 13, 16)] == [2, 1, 1]


@pytest.mark.parametrize("N,R,d", PAIRS_SHAPES)
def test_fused_pairs_walk_on_the_jax_shapes(N, R, d):
    rng = np.random.default_rng(N * 1000 + R * 10 + d)
    _check_walk(*pairs_case(rng, N, R, d))


TILE = CHUNK * ROWS
SMALL = CHUNK * SMALL_CHUNKS


@pytest.mark.parametrize("R", sorted({CHUNK - 1, CHUNK, CHUNK + 1,
                                      SMALL, SMALL + 1, TILE - 1, TILE, TILE + 1,
                                      2 * TILE + 1}))
def test_fused_pairs_walk_around_the_tile(R):
    rng = np.random.default_rng(R)
    _check_walk(*pairs_case(rng, 1, R, 3))


@pytest.mark.parametrize("case", ["R=1", "all-invalid", "d=1", "d=14", "d=16", "duplicates"])
def test_fused_pairs_walk_edges(case):
    rng = np.random.default_rng(17)
    if case == "R=1":
        items, valid = pairs_case(rng, 2, 1, 4, p_valid=1.0)
    elif case == "all-invalid":
        items, valid = pairs_case(rng, 2, 140, 6)
        valid[:] = 0
    elif case == "d=1":
        items, valid = pairs_case(rng, 2, 150, 1)
    elif case == "d=14":                         # one i-row a thread over three chunks
        items, valid = pairs_case(rng, 1, 300, 14, vocab=2)
    elif case == "d=16":
        items, valid = pairs_case(rng, 1, 140, 16, vocab=2)
    else:
        items, valid = pairs_case(rng, 2, 140, 6)
        items[:] = 7
    _check_walk(items, valid)


@pytest.mark.parametrize("R,rows", [(37, 1), (37, 2), (53, 4), (64, 4), (29, 3)])
def test_fused_pairs_walk_balanced_over_many_tiles(R, rows):
    """A small chunk (4 slots) gives many i-tiles, so the pairing of tile
    T-1-y with y, the diagonal chunks and the compaction of holes all run
    many times."""
    rng = np.random.default_rng(R * rows)
    items, valid = pairs_case(rng, 2, R, 3, vocab=3, p_valid=0.7)
    _check_walk(items, valid, chunk=4, rows=rows)


# ---------------------------------------------------------------------------
# sketch_update
# ---------------------------------------------------------------------------

def _key_rows(fp1, fp2, bucket_coeffs, sign_coeffs, weights, w):
    """Per depth row: each key's bucket, and sign * weight as int64."""
    f1 = torch.from_numpy(np.asarray(fp1).astype(np.int64))
    f2 = torch.from_numpy(np.asarray(fp2).astype(np.int64))
    weights = np.asarray(weights, np.int64)
    for bc, sc in zip(np.asarray(bucket_coeffs), np.asarray(sign_coeffs)):
        bucket = hash_bucket(cw_hash_pair(f1, f2, torch.from_numpy(bc.astype(np.int64))), w)
        sign = hash_sign(cw_hash_pair(f1, f2, torch.from_numpy(sc.astype(np.int64))))
        yield bucket.numpy(), sign.numpy().astype(np.int64) * weights


def emulate_sketch_update(counters, fp1, fp2, bucket_coeffs, sign_coeffs, weights, *,
                          ctas: int, threads: int, arrival_seed: int = 0):
    """The kernel's tile path: the grid copies the counters into out; key
    i goes to thread i of ctas x threads (grid-stride) and into its CTA's
    own plane (weight-0 keys leave first); after the grid barrier every
    CTA adds its plane's non-zero entries into out, in an order the
    emulation draws at random.  All in uint32, which wraps as int32."""
    counters = np.asarray(counters, np.int32)
    t, w = counters.shape
    weights = np.asarray(weights, np.int32)
    n = weights.shape[0]
    cta_of = (np.arange(n) % (ctas * threads)) // threads
    tiles = np.zeros((ctas, t, w), np.uint32)
    live = weights != 0
    for row, (bucket, delta) in enumerate(_key_rows(fp1, fp2, bucket_coeffs, sign_coeffs,
                                                    weights, w)):
        np.add.at(tiles[:, row], (cta_of[live], bucket[live]),
                  delta[live].astype(np.int32).view(np.uint32))
    out = counters.view(np.uint32).copy()
    for cta in np.random.default_rng(arrival_seed).permutation(ctas):
        nonzero = tiles[cta] != 0
        out[nonzero] += tiles[cta][nonzero]
    return out.view(np.int32)


UPDATE_SHAPES = [(1, 3, 128), (257, 3, 256), (1024, 5, 512), (300, 1, 64)]
UPDATE_GRIDS = [(1, 512), (3, 32), (16, 8), (80, 4), (80, 512)]


def test_sketch_update_grid_is_the_kernels():
    """The emulation's grid rule is the kernel's: one CTA per kThreads
    keys, at most kMaxCtas (and what is resident)."""
    assert _kernel_constant("sketch_update.cu", "kThreads") == 512
    assert _kernel_constant("sketch_update.cu", "kMaxCtas") == 80


@pytest.mark.parametrize("ctas,threads", UPDATE_GRIDS)
@pytest.mark.parametrize("n,t,w", UPDATE_SHAPES)
def test_sketch_update_tile_reduction_equals_pallas(n, t, w, ctas, threads):
    args = sketch_update_case(np.random.default_rng(n + t + w), n, t, w)
    want = np.asarray(sketch_update_pallas(*args, interpret=True))
    got = emulate_sketch_update(*args, ctas=ctas, threads=threads, arrival_seed=n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctas", [1, 4])
def test_sketch_update_reduction_wraps_near_2_31(ctas):
    """Counters within 3 of +-2^31 and small weights: the uint32 sums wrap
    exactly as the int32 adds of the Pallas kernel (whose float32 tile
    sums are exact below 2^24, so the weights stay small)."""
    rng = np.random.default_rng(31)
    counters, fp1, fp2, bc, sc, _ = sketch_update_case(rng, 700, 3, 256)
    counters = np.array(counters)
    counters[0] = rng.integers(2**31 - 4, 2**31, size=256)
    counters[1] = -(2**31) + rng.integers(0, 4, size=256)
    weights = rng.integers(-3, 4, size=700).astype(np.int32)
    args = (counters, fp1, fp2, bc, sc, weights)
    want = np.asarray(sketch_update_pallas(*args, interpret=True))
    got = emulate_sketch_update(*args, ctas=ctas, threads=32)
    np.testing.assert_array_equal(got, want)
    # the int64 sums leave int32's range: the wrap is what is compared
    exact = counters.astype(np.int64)
    for row, (bucket, delta) in enumerate(_key_rows(fp1, fp2, bc, sc, weights, 256)):
        np.add.at(exact[row], bucket, delta)
    assert (exact > 2**31 - 1).any() and (exact < -(2**31)).any()
    np.testing.assert_array_equal(want, exact.astype(np.uint32).view(np.int32))
