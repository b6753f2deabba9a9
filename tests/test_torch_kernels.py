"""The port's kernel entry points against the JAX package's kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those bit-exact against the JAX kernels, run as the JAX package's own tests
run them (``kernels.ops`` with ``impl="pallas_interpret"``, and the
``jnp_ref`` oracle), over the case grids of ``kernel_cases.py``.  The CUDA
kernels themselves are held against these plain versions on the card by
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_cases import (INGEST_BATCHES, INGEST_DEPTHS, QUERY_DEPTHS, QUERY_SHAPES,
                          counter_stack, fingerprint_case, ingest_inputs, oracle_moments)
from repro.core.fingerprint import np_subvalue_fingerprints
from repro.core.hashing import P31, np_cw_hash
from repro.core.sjpc import SJPCConfig
from repro.kernels import ops as jops
from repro_torch.core import projections as proj
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import fused_ingest as kfi
from repro_torch.kernels import fused_query as kfq


def _np(a):
    return np.asarray(a)


def _t(a):
    """A JAX/numpy argument as the port takes it: int64 field data, int32
    counters and weights."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.int64))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(4242)


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,d,s", [(1, 4, 2), (37, 5, 3), (130, 6, 4)])
def test_fingerprint_matches_jax_kernel(rng, B, d, s):
    args = fingerprint_case(rng, B, d, s)
    got = ops.fingerprint(*(_t(a) for a in args))
    oracle = np_subvalue_fingerprints(*(_np(a) for a in args))
    for impl in ("pallas_interpret", "jnp_ref") if B == 37 else ("pallas_interpret",):
        want = jops.fingerprint(*args, impl=impl)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))
    for g, o in zip(got, oracle):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), o)


def test_fingerprint_accepts_numpy_uint32(rng):
    args = [_np(a) for a in fingerprint_case(rng, 9, 5, 2)]
    got = ops.fingerprint(torch.from_numpy(args[0].astype(np.int64)), *args[1:])
    want = np_subvalue_fingerprints(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


THREADS = 256   # fingerprint.cu's CTA
COL_BLOCK = 64  # fingerprint.cu's columns per block (a 64-bit mask)
# (records per tile, combinations per CTA column) of the walk: the tilings
# the kernel picks at the paper lattice's levels (64 records at M = 20, 128
# at M <= 10), one record per tile, and chunks smaller than a level
TILINGS = [(64, 1024), (128, 1024), (1, 1024), (3, 7)]


def np_tiled_fingerprint(values, masks, ids, bases, tile, chunk):
    """csrc/fingerprint.cu's walk in numpy: per chunk of combinations (a
    CTA column), their Horner seeds; per tile of ``tile`` records and
    block of 64 columns, each combination's columns of the block as a
    bitmask and each of the tile's values as its Horner term, taken once;
    each of the CTA's threads steps over the tile's (record, combination)
    items from (tid // mc, tid % mc) by (q, rem) with one wrap, starts from
    the seed (first block) or from what it wrote to the output (later
    blocks), and runs the Horner steps over the block's set bits.  Every
    output is written once per block."""
    values, masks, ids = (np.asarray(a).astype(np.uint64) for a in (values, masks, ids))
    B, d = values.shape
    M = ids.shape[0]
    p = np.uint64(int(P31))
    base1, base2 = (np.uint64(int(x)) for x in np.asarray(bases))
    blocks = max(1, -(-d // COL_BLOCK))
    out = np.zeros((2, B, M), np.uint64)
    written = np.zeros((B, M), np.int64)
    tid = np.arange(THREADS)
    for m0 in range(0, M, chunk):
        mc = min(chunk, M - m0)
        seeds = (ids[m0:m0 + mc] % p + np.uint64(1)) % p
        q, rem = divmod(THREADS, mc)
        for b0 in range(0, B, tile):
            rows = min(tile, B - b0)
            for w in range(blocks):
                c0 = w * COL_BLOCK
                dc = min(COL_BLOCK, d - c0)
                bits = np.uint64(1) << np.arange(dc, dtype=np.uint64)
                cols = (masks[m0:m0 + mc, c0:c0 + dc] != 0).astype(np.uint64) @ bits
                terms = (values[b0:b0 + rows, c0:c0 + dc] % p + np.uint64(1)) % p
                r, m = tid // mc, tid % mc
                while (r < rows).any():
                    live = r < rows
                    ra, ma = r[live], m[live]
                    if w == 0:
                        f1, f2 = seeds[ma], seeds[ma]
                    else:
                        f1, f2 = out[0, b0 + ra, m0 + ma], out[1, b0 + ra, m0 + ma]
                    for c in range(dc):
                        on = ((cols[ma] >> np.uint64(c)) & np.uint64(1)).astype(bool)
                        x = terms[ra, c]
                        f1 = np.where(on, (f1 * base1 + x) % p, f1)
                        f2 = np.where(on, (f2 * base2 + x) % p, f2)
                    out[0, b0 + ra, m0 + ma] = f1
                    out[1, b0 + ra, m0 + ma] = f2
                    np.add.at(written, (b0 + ra, m0 + ma), 1)
                    r, m = r + q, m + rem
                    wrap = m >= mc
                    m[wrap] -= mc
                    r[wrap] += 1
    assert (written == blocks).all()
    return out[0], out[1]


@pytest.mark.parametrize("tile,chunk", TILINGS)
@pytest.mark.parametrize("d,s,levels,B", [
    (6, 3, (0, 1, 2, 3), 130),   # the paper lattice: 64-record tiles and a tail
    (4, 4, (0,), 5),             # the request monitor's one combination
    (4, 2, (0, 1, 2), 1),
    (12, 6, (0, 5, 6), 37),      # 924 combinations: more than a CTA's 256 threads
])
def test_fingerprint_tiled_walk_equals_jax(rng, d, s, levels, B, tile, chunk):
    """The kernel's tiled walk gives the JAX kernel's fingerprints, run in
    interpret mode, level by level."""
    for level in levels:
        args = fingerprint_case(rng, B, d, s, level=level)
        got = np_tiled_fingerprint(*args, tile, chunk)
        want = jops.fingerprint(*args, impl="pallas_interpret")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, _np(w).astype(np.uint64))


@pytest.mark.parametrize("tile,chunk", TILINGS)
def test_fingerprint_tiled_walk_over_wide_records_equals_jax(rng, tile, chunk):
    """Records of 65 and 130 columns go in 64-column blocks, each
    carrying the fingerprints on from the last: the walk equals the JAX
    kernel in interpret mode."""
    for B, M, d in ((9, 5, 65), (4, 3, 130)):
        values = rng.integers(0, 2**32, size=(B, d), dtype=np.uint32)
        masks = rng.integers(0, 2, size=(M, d)).astype(np.uint32)
        ids = rng.integers(0, 2**32, size=M, dtype=np.uint32)
        bases = np.array([98765, 2**31 - 9], np.uint32)
        got = np_tiled_fingerprint(values, masks, ids, bases, tile, chunk)
        want = jops.fingerprint(values, masks, ids, bases, impl="pallas_interpret")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, _np(w).astype(np.uint64))


def test_fingerprint_tiled_walk_over_chunks_and_wide_records(rng):
    """Above 1,024 combinations a launch takes several CTA columns, and
    records of any width go in 64-column blocks: the walk equals the numpy
    oracle."""
    for B, M, d in ((3, 1300, 13), (70, 40, 64), (9, 3, 0), (5, 1100, 200)):
        values = rng.integers(0, 2**32, size=(B, d), dtype=np.uint32)
        masks = rng.integers(0, 2, size=(M, d)).astype(np.uint32)
        ids = rng.integers(0, 2**32, size=M, dtype=np.uint32)
        bases = np.array([123457, 2**31 - 5], np.uint32)
        got = np_tiled_fingerprint(values, masks, ids, bases, 64, 1024)
        want = np_subvalue_fingerprints(values, masks, ids, bases)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w).astype(np.uint64))


# ---------------------------------------------------------------------------
# fused_ingest
# ---------------------------------------------------------------------------

def np_fused_ingest(counters, values, masks, ids, bases, bcoef, scoef, weights):
    """numpy uint64 oracle of the padded-lattice fused ingest."""
    out = counters.astype(np.int64)
    L, t, w = out.shape
    p = np.uint64(int(P31))

    def pair(fp1, fp2, c):
        return (np_cw_hash(fp1, c[0]).astype(np.uint64) + np_cw_hash(fp2, c[1])) % p

    for lvl in range(L):
        fp1, fp2 = np_subvalue_fingerprints(values, masks[lvl], ids[lvl], bases)
        for i in range(t):
            bucket = (pair(fp1, fp2, bcoef[lvl, i]) & np.uint64(w - 1)).astype(np.int64)
            sign = 1 - 2 * (pair(fp1, fp2, scoef[lvl, i]) & np.uint64(1)).astype(np.int64)
            np.add.at(out[lvl, i], bucket.ravel(), (sign * weights[:, lvl, :]).ravel())
    return out.astype(np.int32)


def _ingest_check(args, impls=()):
    got = ops.fused_ingest(*(_t(a) for a in args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np_fused_ingest(*(_np(a) for a in args)))
    for impl in impls:
        np.testing.assert_array_equal(got.numpy(), _np(jops.fused_ingest(*args, impl=impl)))


@pytest.mark.parametrize("batch", INGEST_BATCHES)
def test_fused_ingest_batch_remainders(rng, batch):
    cfg = SJPCConfig(d=5, s=3, width=256, depth=2, seed=3)
    _, _, args = ingest_inputs(rng, cfg, batch)
    _ingest_check(args, ("pallas_interpret",) if batch == 17 else ())


@pytest.mark.parametrize("depth", INGEST_DEPTHS)
def test_fused_ingest_depths(rng, depth):
    cfg = SJPCConfig(d=4, s=2, width=256, depth=depth, seed=4)
    _, _, args = ingest_inputs(rng, cfg, 50)
    _ingest_check(args, ("jnp_ref",) if depth == 3 else ())


def test_fused_ingest_zero_weights_and_padded_slots(rng):
    """All-zero weights leave the counters as they were; garbage in the
    padded table slots (weight 0) changes nothing."""
    cfg = SJPCConfig(d=4, s=2, width=128, depth=2, seed=6)
    _, pad, args = ingest_inputs(rng, cfg, 20)
    targs = [_t(a) for a in args]
    zero = torch.zeros_like(targs[7])
    np.testing.assert_array_equal(ops.fused_ingest(*targs[:7], zero).numpy(), _np(args[0]))
    got = ops.fused_ingest(*targs)
    masks, ids = np.array(pad.masks), np.array(pad.ids)
    masks[pad.valid == 0] = 1
    ids[pad.valid == 0] = 0xDEAD
    got2 = ops.fused_ingest(targs[0], targs[1], _t(masks), _t(ids), *targs[4:])
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def np_slot_walk(counters, values, masks, ids, bases, bcoef, scoef, weights):
    """The CUDA kernel's walk (csrc/fused_ingest.cu) in numpy: a slot table
    over each level's live combinations (the wrapper's live counts of the
    padded lattice), each
    slot's column bitmask and id, and only the (record, slot) items of
    non-zero weight, fingerprinted from the bitmask and scattered."""
    out = counters.astype(np.int64)
    L, t, w = out.shape
    B, d = values.shape
    m_max = ids.shape[1]
    _, _, live = kfi.lattice_table(_t(masks), _t(ids))
    live = list(live)
    p = np.uint64(int(P31))
    slots = [(lvl, m) for lvl in range(L) for m in range(live[lvl])]
    assert len(slots) == sum(live)
    for lvl, m in slots:
        cols = sum(1 << c for c in range(d) if masks[lvl, m, c] != 0)
        rows = np.nonzero(weights[:, lvl, m])[0]
        if not len(rows):
            continue
        mask = np.array([[(cols >> c) & 1 for c in range(d)]], np.uint32)
        fp1, fp2 = np_subvalue_fingerprints(values[rows], mask, ids[lvl, m:m + 1], bases)
        for i in range(t):
            hb = (np_cw_hash(fp1, bcoef[lvl, i, 0]).astype(np.uint64)
                  + np_cw_hash(fp2, bcoef[lvl, i, 1])) % p
            hs = (np_cw_hash(fp1, scoef[lvl, i, 0]).astype(np.uint64)
                  + np_cw_hash(fp2, scoef[lvl, i, 1])) % p
            sign = 1 - 2 * (hs & np.uint64(1)).astype(np.int64)
            np.add.at(out[lvl, i], (hb & np.uint64(w - 1)).astype(np.int64).ravel(),
                      (sign[:, 0] * weights[rows, lvl, m]))
    return out.astype(np.int32)


@pytest.mark.parametrize("d,s", [(4, 2), (5, 3), (6, 3), (4, 4), (7, 2)])
def test_fused_ingest_slot_walk_equals_jax(rng, d, s):
    """The kernel's live-slot walk gives the JAX kernel's counters: the
    padded slots past each level's C(d, k) combinations carry weight 0."""
    cfg = SJPCConfig(d=d, s=s, width=128, depth=3, seed=d * 10 + s)
    _, pad, args = ingest_inputs(rng, cfg, 40)
    got = np_slot_walk(*(_np(a) for a in args))
    np.testing.assert_array_equal(got, _np(jops.fused_ingest(*args, impl="jnp_ref")))
    masks, ids, live = kfi.lattice_table(_t(pad.masks), _t(pad.ids))
    assert list(live) == list(pad.nums)
    assert masks.dtype == ids.dtype == torch.int32
    assert torch.equal(masks, torch.from_numpy(pad.masks.astype(np.int32)))


@pytest.mark.parametrize("case", ["random", "swapped", "level_of_another_lattice",
                                  "wider", "too_many_levels"])
def test_fused_ingest_refuses_a_table_that_is_no_padded_lattice(rng, case):
    """The kernel walks each level's C(d, k) combinations of the padded
    lattice of the table's shape; a table of that shape holding anything
    else raises instead of being summed from the wrong slots."""
    pad = proj.padded_lattice(6, 3)
    masks, ids = pad.masks.astype(np.int64), pad.ids.astype(np.int64)
    if case == "random":
        masks = rng.integers(0, 2, size=masks.shape)
    elif case == "swapped":
        masks, ids = masks.copy(), ids.copy()
        masks[1, [0, 1]] = masks[1, [1, 0]]
        ids[1, [0, 1]] = ids[1, [1, 0]]
    elif case == "level_of_another_lattice":
        ids = ids.copy()
        ids[0, 0] += 1
    elif case == "wider":
        masks = np.concatenate([masks, np.zeros_like(masks[:, :1])], axis=1)
        ids = np.concatenate([ids, np.zeros_like(ids[:, :1])], axis=1)
    else:
        masks = np.concatenate([masks] * 2)[:6]
        ids = np.concatenate([ids] * 2)[:6]
    with pytest.raises(ValueError):
        kfi.lattice_table(torch.from_numpy(masks), torch.from_numpy(ids))


def test_fused_ingest_grid_numbers_items_in_32_bits():
    """A CTA numbers its (record, slot) items in 32 bits: the grid takes
    the largest batch whose CTAs stay below 2^32 items and refuses one
    more record (d=12, s=1: 4,095 live slots, 132 SMs, 264 CTAs)."""
    slots, sms = 4095, 132
    rows = (2**32 - 1) // slots
    assert kfi.launch_grid(264 * rows, slots, sms) == (264, rows)
    with pytest.raises(ValueError):
        kfi.launch_grid(264 * rows + 1, slots, sms)
    assert kfi.launch_grid(1, 42, sms) == (1, 1)
    assert kfi.launch_grid(65536, 42, sms) == (264, 249)
    ctas, rows = kfi.launch_grid(777, 42, sms)
    assert ctas * rows >= 777 > (ctas - 1) * rows and rows * 42 >= kfi.ITEMS_PER_CTA


def test_narrowed_tables_follow_in_place_changes():
    """The wrapper narrows a hash parameter or lattice table once per
    tensor; an in-place change to the tensor narrows it again."""
    coeffs = torch.tensor([[1, 2**32 - 1]], dtype=torch.int64)
    first = kfi._once(kfi.words32, coeffs)
    assert kfi._once(kfi.words32, coeffs) is first
    assert first.tolist() == [[1, -1]]
    coeffs[0, 0] = 7
    assert kfi._once(kfi.words32, coeffs).tolist() == [[7, -1]]
    assert kfi._once(kfi.words32, coeffs.clone()).tolist() == [[7, -1]]
    with torch.inference_mode():
        frozen = torch.tensor([2**32 - 2], dtype=torch.int64)
        assert kfi._once(kfi.words32, frozen).tolist() == [-2]
        frozen[0] = 3
        assert kfi._once(kfi.words32, frozen).tolist() == [3]


def test_fused_ingest_takes_int32_words(rng):
    """Field data as uint32 words in int32 tensors (the form the CUDA
    kernel reads) gives the int64 call's counters."""
    cfg = SJPCConfig(d=6, s=3, width=256, depth=3, seed=12)
    _, _, args = ingest_inputs(rng, cfg, 64)
    targs = [_t(a) for a in args]
    words = [targs[0]] + [kfi.words32(a) for a in targs[1:7]] + [targs[7]]
    assert all(a.dtype == torch.int32 for a in words)
    assert bool((words[1] < 0).any())          # records above 2^31 wrap
    np.testing.assert_array_equal(ops.fused_ingest(*words).numpy(),
                                  ops.fused_ingest(*targs).numpy())


# ---------------------------------------------------------------------------
# fused_query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", QUERY_DEPTHS)
@pytest.mark.parametrize("N,L,w,block_w", QUERY_SHAPES)
def test_fused_query_matches_jax_kernel(rng, depth, N, L, w, block_w):
    a = counter_stack(rng, N, L, depth, w)
    b = counter_stack(rng, N, L, depth, w)
    got = ops.fused_query(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == (N, L, depth)
    np.testing.assert_array_equal(got.numpy(), _np(jops.fused_query(a, b, impl="jnp_ref")))
    if depth == 3:
        want = jops.fused_query(a, b, impl="pallas_interpret", block_w=block_w)
        np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(got.numpy(), oracle_moments(a, b).astype(np.float32))
    f2 = ops.fused_query(_t(a))
    np.testing.assert_array_equal(f2.numpy(), oracle_moments(a, a).astype(np.float32))


def test_fused_query_empty_and_large(rng):
    zeros = torch.zeros((2, 3, 3, 128), dtype=torch.int32)
    np.testing.assert_array_equal(ops.fused_query(zeros).numpy(), np.zeros((2, 3, 3)))
    # beyond 2^24 the int64 sum, cast once, is the int64 oracle rounded once
    big = rng.integers(-(2**20), 2**20, size=(1, 2, 3, 512)).astype(np.int32)
    got = ops.fused_query(torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(got, oracle_moments(big, big).astype(np.float32))


# ---------------------------------------------------------------------------
# wrappers: device dispatch and the build
# ---------------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kfp.fingerprint(meta, meta, meta[:, 0], meta[0, :2])
    c = torch.empty((1, 1, 2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kfq.fused_query(c, c)
    with pytest.raises(ValueError):
        kfi.fused_ingest(c[0], meta, meta, meta, meta, meta, meta, meta)


def test_cpu_calls_launch_nothing(rng):
    before = (kfp.launches, kfi.launches, kfq.launches)
    cfg = SJPCConfig(d=4, s=2, width=128, depth=2, seed=8)
    _, _, args = ingest_inputs(rng, cfg, 5)
    ops.fused_ingest(*(_t(a) for a in args))
    ops.fused_query(torch.zeros((1, 1, 1, 64), dtype=torch.int32))
    ops.fingerprint(*(_t(a) for a in fingerprint_case(rng, 3, 4, 2)))
    assert (kfp.launches, kfi.launches, kfq.launches) == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_build_covers_every_source():
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == sorted(_build.SOURCES) == sorted(_build.SIGNATURES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
