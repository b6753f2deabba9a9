"""numpy emulation of the CUDA kernel ``csrc/sketch_moments.cu``, held
against the JAX package's Pallas kernel in interpret mode, the way its own
tests run it, and against the int64 oracle.

The emulation replays the kernel's plan and walk: the C entry's choice of
threads per CTA, CTAs per row (a thread-block cluster) and int4 or 4-byte
loads from the width and the row starts' alignment (the constants read
from the kernel's source); each thread's kVec loads per pass, units g,
g + G, ... of the row; one load stream when A and B are one pointer (F2);
int64 products and uint64 sums; then the warp shuffles, the warps'
partials in shared memory and the cluster's partials read by rank 0, all
in uint64, which wraps as int64; one float32 cast.  It counts every
element's loads, so each test also shows that a row is read exactly once
per stream."""
import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sketch_moments import sketch_moments_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import sketch_moments as ksm

CSRC = Path(ksm.__file__).parent / "csrc"


def _kernel_constant(name: str) -> int:
    """A ``constexpr int`` of ``sketch_moments.cu``."""
    text = (CSRC / "sketch_moments.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


THREADS = _kernel_constant("kThreads")
VEC = _kernel_constant("kVec")
MAX_CLUSTER = _kernel_constant("kMaxCluster")
WIDTHS = [1, 3, 1000, 1024, 2048, 4096, 65536]
CASES = ["join", "f2_same", "f2_copy"]


def plan(w: int, a_byte: int, b_byte: int, max_cluster: int = MAX_CLUSTER):
    """The C entry's plan for rows of w counters whose first row starts at
    byte addresses ``a_byte`` and ``b_byte``: (threads per CTA, CTAs per
    row, int4 loads)."""
    vector = w % 4 == 0 and a_byte % 16 == 0 and b_byte % 16 == 0
    units = w // 4 if vector else w
    threads = min(THREADS, max(32, -(-units // 32) * 32))
    cluster = min(max_cluster, max(1, -(-units // (THREADS * VEC))))
    return threads, cluster, vector


def _shuffle_down_sum(lanes: np.ndarray) -> np.uint64:
    """Lane 0 of ``__shfl_down_sync`` adds over offsets 16, 8, 4, 2, 1
    (lanes past the warp keep their own value)."""
    v = lanes.copy()
    for off in (16, 8, 4, 2, 1):
        shifted = v.copy()
        shifted[:32 - off] = v[off:]
        v = v + shifted
    return v[0]


def emulate_row(a_row, b_row, threads, cluster, vector, loads_a, loads_b):
    """One row's moment as the kernel sums it; ``b_row`` None is F2 from
    one pointer.  Adds each element's loads into ``loads_a``/``loads_b``."""
    size = 4 if vector else 1
    units = a_row.size // size
    G = threads * cluster
    acc = np.zeros(G, np.uint64)
    for base in range(0, max(units, 1), G * VEC):      # a pass: kVec loads per thread
        for k in range(VEC):
            u = base + k * G + np.arange(G)
            live = u < units
            idx = (u[live, None] * size + np.arange(size)).reshape(-1)
            x = a_row[idx].astype(np.int64)
            loads_a[idx] += 1
            if b_row is None:
                y = x
            else:
                y = b_row[idx].astype(np.int64)
                loads_b[idx] += 1
            prods = (x * y).view(np.uint64).reshape(-1, size)
            acc[live] += prods.sum(axis=1, dtype=np.uint64)
    partials = []
    for rank in range(cluster):
        cta = acc[rank * threads:(rank + 1) * threads].reshape(threads // 32, 32)
        warp_sums = np.array([_shuffle_down_sum(w) for w in cta], np.uint64)
        lanes = np.zeros(32, np.uint64)
        lanes[:warp_sums.size] = warp_sums
        partials.append(_shuffle_down_sum(lanes))
    lanes = np.zeros(32, np.uint64)
    lanes[:cluster] = partials
    return _shuffle_down_sum(lanes)


def emulate(a, b, *, a_byte=0, b_byte=0, max_cluster=MAX_CLUSTER):
    """The kernel's (t,) float32 output for (t, w) int32 rows ``a`` and
    ``b`` (``b`` None: F2 from one pointer); checks that every element of
    each stream was loaded exactly once."""
    t, w = a.shape
    threads, cluster, vector = plan(w, a_byte, a_byte if b is None else b_byte, max_cluster)
    out = np.zeros(t, np.uint64)
    for row in range(t):
        loads_a, loads_b = np.zeros(w, np.int64), np.zeros(w, np.int64)
        out[row] = emulate_row(a[row], None if b is None else b[row], threads, cluster,
                               vector, loads_a, loads_b)
        assert (loads_a == 1).all()
        assert (loads_b == (0 if b is None else 1)).all()
    return out.view(np.int64).astype(np.float32)


def oracle(a, b):
    """int64 products summed with int64 wrap, cast once."""
    return (a.astype(np.int64) * b.astype(np.int64)).sum(axis=-1).astype(np.float32)


def _rows(t, w, magnitude, seed, offset):
    """(t, w) int32 counters in [-magnitude, magnitude], as the view at
    element ``offset`` of a buffer (its byte address 4 * offset)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros(t * w + offset, np.int32)
    buf[offset:] = rng.integers(-magnitude, magnitude + 1, size=t * w)
    return buf[offset:].reshape(t, w)


def _small_magnitude(w: int) -> int:
    """The largest m with w * m^2 < 2^24: every partial sum of the Pallas
    kernel's float32 reduction is then an exact integer."""
    return math.isqrt((2**24 - 1) // w)


def _operands(t, w, case, offset, magnitude):
    """(a, b or None, a's byte address, b's) for a case."""
    a = _rows(t, w, magnitude, t * 1_000_003 + w, offset)
    if case == "join":
        b = _rows(t, w, magnitude, t * 1_000_003 + w + 1, offset)
    elif case == "f2_copy":
        b = _rows(t, w, 0, 0, offset)
        b[:] = a
    else:
        b = None
    return a, b, 4 * offset


@functools.lru_cache(maxsize=None)
def _pallas(t, w, join):
    a, b, _ = _operands(t, w, "join" if join else "f2_same", 0, _small_magnitude(w))
    return np.asarray(sketch_moments_pallas(a, a if b is None else b, interpret=True))


def test_plan_is_the_kernels():
    """The emulation's plan is the C entry's, on the constants read from
    the source."""
    text = (CSRC / "sketch_moments.cu").read_text()
    for line in ("p.vector = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&",
                 "reinterpret_cast<uintptr_t>(b) % 16 == 0;",
                 "p.same = a == b;",
                 "const int64_t units = p.vector ? w / 4 : w;",
                 "const int64_t threads = (units + 31) / 32 * 32;",
                 "const int64_t ctas = (units + kThreads * kVec - 1) / (kThreads * kVec);",
                 "return run(a, b, out, t, w, kMaxCluster, device, stream);"):
        assert line in text, line
    assert (THREADS, VEC, MAX_CLUSTER) == (256, 8, 8)
    assert plan(1024, 0, 0) == (256, 1, True)         # the paper's row: one int4 a thread
    assert plan(1000, 0, 0) == (256, 1, True)
    assert plan(1024, 4, 4) == (256, 1, False)        # a view at an odd offset
    assert plan(1024, 0, 4) == (256, 1, False)
    assert plan(1, 0, 0) == (32, 1, False)
    assert plan(3, 0, 0) == (32, 1, False)
    assert plan(65536, 0, 0) == (256, 8, True)        # 8 CTAs x 256 threads x 8 int4s
    assert plan(65536, 0, 0, max_cluster=1) == (256, 1, True)
    assert plan(65536, 4, 4) == (256, 8, False)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("t", [1, 3, 5])
def test_walk_equals_pallas(t, w, offset, case):
    """Below 2^24 the emulated walk equals the Pallas kernel (interpret
    mode) and the int64 oracle, bit for bit."""
    a, b, addr = _operands(t, w, case, offset, _small_magnitude(w))
    got = emulate(a, b, a_byte=addr, b_byte=addr)
    want = _pallas(t, w, case == "join")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(a, a if b is None else b))


@pytest.mark.parametrize("case", ["join", "f2_same"])
@pytest.mark.parametrize("w", [2048, 4096, 65536])
def test_one_cta_per_row_equals_pallas(w, case):
    """The design not kept (one CTA per row, more passes) sums the same."""
    a, b, _ = _operands(3, w, case, 0, _small_magnitude(w))
    got = emulate(a, b, max_cluster=1)
    np.testing.assert_array_equal(got, _pallas(3, w, case == "join"))


@pytest.mark.parametrize("case", ["join", "f2_same"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 3, 1000, 1024, 4096, 65536])
def test_walk_at_full_int32_range_equals_the_oracle(w, offset, case):
    """|c| up to 2^31 - 1: above 2^24 the kernel follows the int64 oracle
    (the plain version's sum), not the float32 reduction."""
    a, b, addr = _operands(3, w, case, offset, 2**31 - 1)
    got = emulate(a, b, a_byte=addr, b_byte=addr)
    other = a if b is None else b
    want = ref.sketch_moments_ref(torch.from_numpy(np.ascontiguousarray(a)),
                                  torch.from_numpy(np.ascontiguousarray(other))).numpy()
    np.testing.assert_array_equal(got, oracle(a, other))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_cluster", [1, MAX_CLUSTER])
@pytest.mark.parametrize("case", ["join", "f2_same"])
def test_walk_wraps_as_int64(case, max_cluster):
    """Rows of counters at +-(2^31 - 1): the exact sums leave int64's
    range, and the uint64 partials wrap as the oracle's int64 sum does."""
    w = 65536
    a = np.full((3, w), 2**31 - 1, np.int32)
    a[1] = -(2**31 - 1)
    a[2, ::2] = -(2**31 - 1)
    b = None if case == "f2_same" else -a
    other = a if b is None else b
    exact = [sum(int(x) * int(y) for x, y in zip(a[i, :8], other[i, :8])) * (w // 8)
             for i in range(3)]
    assert any(abs(e) >= 2**63 for e in exact)
    got = emulate(a, b, max_cluster=max_cluster)
    np.testing.assert_array_equal(got, oracle(a, other))
    wrapped = [((e + 2**63) % 2**64) - 2**63 for e in exact]
    np.testing.assert_array_equal(got, np.array(wrapped, np.int64).astype(np.float32))
