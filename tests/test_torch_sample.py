"""SJPC's projection sampling in the port against the JAX package, on the
CPU: the ``sample_weights`` op's plain version, and a numpy emulation of
its CUDA kernel's own scheme (``kernels/csrc/sample_weights.cu``: uint32
threefry2x32, integer scores ``bits >> 9``, ranks by comparison of
composite keys, the float32 Bernoulli, the on-card key derivation), each
held bit for bit against ``sjpc._sample_level_weights`` padded as
``update_fused`` pads it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import sjpc as jsjpc
from repro.service import ingest as jingest
from repro_torch.core import prng
from repro_torch.core import projections as tproj
from repro_torch.core import sjpc as tsjpc
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sample_weights as ksw
from repro_torch.kernels.registry import TORCH_REF
from repro_torch.obs.metrics import default_registry
from repro_torch.service import ingest as tingest

# (d, s, r): the paper's defaults, the request monitor's all-ones level, a
# fractional sample size, and levels of 126 combinations (above the
# reference's argsort switch at 64, and the kernel's large-level path)
CONFIGS = [(6, 3, 0.5), (4, 4, 1.0), (5, 2, 0.75), (9, 4, 0.3)]
BATCHES = [1, 7, 300]
STEPS = [0, 1, 2**31 - 1]
SEED = 0x5A5A


def _kd(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _jax_weights(d, s, r, key, batch, row_mask):
    """``_sample_level_weights`` stacked and padded with ``jnp.pad``, as
    ``update_fused`` hands them to ``fused_ingest_pallas``."""
    cfg = jsjpc.SJPCConfig(d=d, s=s, ratio=r, seed=SEED)
    mask = None if row_mask is None else jnp.asarray(row_mask)
    levels = jsjpc._sample_level_weights(cfg, key, batch, mask)
    m_max = max(w.shape[1] for w in levels)
    return np.asarray(jnp.stack([jnp.pad(w, ((0, 0), (0, m_max - w.shape[1])))
                                 for w in levels], axis=1))


def _keys():
    """(name, JAX key, port key, port step): the default key of three
    steps, derived from a step tensor as the update functions do; an
    explicit key; and an ingest key of the service."""
    base = jax.random.PRNGKey(SEED ^ 0xC0FFEE)
    tbase = prng.PRNGKey(SEED ^ 0xC0FFEE)
    out = [(f"step {step}", jax.random.fold_in(base, step), tbase,
            torch.tensor(step, dtype=torch.int32)) for step in STEPS]
    key = jax.random.fold_in(jax.random.PRNGKey(77), 4)
    out.append(("explicit", key, _kd(key), None))
    jcfg = jsjpc.SJPCConfig(d=6, s=3, seed=SEED)
    out.append(("ingest", jingest.ingest_key(jcfg, 5, 9),
                tingest.ingest_key(tsjpc.SJPCConfig(d=6, s=3, seed=SEED), 5, 9), None))
    return out


def _masks(batch):
    mask = (np.random.default_rng(batch).random(batch) < 0.6).astype(np.int32)
    return [None, mask]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("d,s,r", CONFIGS)
def test_plain_version_equals_jax(d, s, r, batch):
    for name, jkey, tkey, step in _keys():
        for mask in _masks(batch):
            want = _jax_weights(d, s, r, jkey, batch, mask)
            tmask = None if mask is None else torch.from_numpy(mask)
            got = ref.sample_weights_ref(tkey, step, tmask, batch, d, s, r)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} mask={mask}")


# ---------------------------------------------------------------------------
# the kernel's scheme, emulated in numpy uint32
# ---------------------------------------------------------------------------

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k0, k1, x0, x1):
    """threefry2x32 on numpy uint32 arrays, as csrc/threefry.cuh."""
    u32 = np.uint32
    k0, k1, x0, x1 = (np.asarray(v, dtype=u32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def level_keys(key, step, idx):
    """The kernel's level_keys: (k_sel, k_round) of level idx from the
    round key, folded with ``step`` first when it is given."""
    k = tuple(np.uint32(int(v)) for v in key)
    if step is not None:
        k = threefry(*k, 0, np.uint32(step & 0xFFFFFFFF))
    lk = threefry(*k, 0, idx)
    return threefry(*lk, 0, 0), threefry(*lk, 0, 1)


def bits_of(k, n):
    """Random bits of draw elements n (uint64) under key k."""
    n = np.asarray(n, dtype=np.uint64)
    y0, y1 = threefry(k[0], k[1], (n >> np.uint64(32)).astype(np.uint32),
                      (n & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def uniform_of(bits):
    """float32 uniform from bits: (bits >> 9) | 0x3F800000 viewed, minus 1."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def sort_descending(c):
    """sample_weights.cu's bitonic network on the last axis (a power of
    two) of a uint32 array: descending."""
    c = c.copy()
    n = c.shape[-1]
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            for i in range(n):
                p = i ^ j
                if p > i:
                    hi = np.maximum(c[..., i], c[..., p])
                    lo = np.minimum(c[..., i], c[..., p])
                    c[..., i], c[..., p] = (hi, lo) if i & k == 0 else (lo, hi)
            j >>= 1
        k <<= 1
    return c


def sort_width(M):
    """N of keep_mask_of_width: the power of two at or above M, at least 2."""
    return max(2, 1 << (M - 1).bit_length())


THREADS = 256   # sample_weights.cu's CTA


def row_walk(nl, units, rows):
    """RowWalk: each thread's (record, level, unit) over a tile's rows,
    from unit tid in steps of 256 units carried with no division."""
    tid = np.arange(THREADS)
    row, rows_per_step = tid // units, THREADS // units
    j, r = tid - row * units, row // nl
    li = row - r * nl
    dj, dr = THREADS - rows_per_step * units, rows_per_step // nl
    dli = rows_per_step - dr * nl
    while (r < rows).any():
        live = r < rows
        yield r[live], li[live], j[live]
        j, li, r = j + dj, li + dli, r + dr
        wrap = j >= units
        j[wrap] -= units
        li[wrap] += 1
        wrap = li >= nl
        li[wrap] -= nl
        r[wrap] += 1


def keep_masks(k_sel, k_round, b, M, lo, frac32, index_dtype):
    """keep_mask<N> of records ``b`` at one level of M < 32 combinations:
    the uint32 keep masks and the threefry blocks drawn, (Bernoulli,
    scores).  The Bernoulli is drawn only when frac > 0, the scores only
    for records whose l_b lies strictly between 0 and M; the composite keys
    (score << 5 | 31 - m), padded with 0 to N, are sorted by the bitonic
    network and the top l_b keys' low bits are the kept combinations."""
    l = np.full(len(b), lo, np.int64)
    bernoulli = 0
    if frac32 > 0:
        l += uniform_of(bits_of(k_round, b)) < frac32
        bernoulli = len(b)
    masks = np.where(l >= M, np.uint32((1 << M) - 1), np.uint32(0))
    need = (l > 0) & (l < M)
    if not need.any():
        return masks, bernoulli, 0
    n = sort_width(M)
    m = np.arange(M)
    first = b[need].astype(index_dtype) * index_dtype(M)
    score = bits_of(k_sel, first[:, None] + m.astype(index_dtype)[None, :]) >> np.uint32(9)
    comp = np.zeros((len(first), n), np.uint32)
    comp[:, :M] = (score << np.uint32(5)) | (np.uint32(31) - m.astype(np.uint32))
    comp = sort_descending(comp)
    top = np.arange(n)[None, :] < l[need][:, None]
    bits = np.where(top, np.uint32(1) << (np.uint32(31) - (comp & np.uint32(31))), np.uint32(0))
    masks[need] = np.bitwise_or.reduce(bits, axis=1)
    return masks, bernoulli, score.size


def kernel_scheme(key, step, row_mask, batch, d, s, ratio, blocks=None):
    """(B, L, m_max) weights as sample_weights.cu computes them.  Levels of
    M < 32: tiles of 256 records, one thread per record computing its keep
    mask at every small level in turn into the tile's table (element
    indices in uint32 when B * L * m_max < 2^31), then the CTA's row walk
    writes every unit (4 ints, or 1 when m_max is no multiple of 4) of the
    tile's rows exactly once.  Larger levels: one CTA per
    (record, level), ranks over 64-bit composite keys (score << 32 | ~m).
    ``blocks``, a dict, gets each small level's threefry blocks drawn,
    (Bernoulli, scores)."""
    parts = tproj.level_sample_parts(d, s, ratio)
    L, m_max = len(parts), max(m for m, _, _ in parts)
    out = np.full((batch, L, m_max), -1, np.int32)
    mul = np.ones(batch, np.int32) if row_mask is None else np.asarray(row_mask, np.int32)
    index_dtype = np.uint32 if batch * L * m_max < 2**31 else np.uint64
    small = [idx for idx, (M, _, _) in enumerate(parts) if M < 32]
    if small:
        nl = len(small)
        masks = np.zeros((batch, nl), np.uint32)
        drawn = {li: np.zeros(2, np.int64) for li in range(nl)}
        for b0 in range(0, batch, THREADS):
            rows = min(THREADS, batch - b0)
            for li, idx in enumerate(small):
                M, lo, frac = parts[idx]
                frac32 = np.float32(frac)
                b = np.arange(b0, b0 + rows, dtype=np.uint64)
                if lo >= M and frac32 == 0:
                    masks[b0:b0 + rows, li] = (1 << M) - 1
                    continue
                k_sel, k_round = level_keys(key, step, idx)
                masks[b0:b0 + rows, li], *n = keep_masks(k_sel, k_round, b, M, lo, frac32,
                                                         index_dtype)
                drawn[li] += n
            width = 4 if m_max % 4 == 0 else 1
            written = np.zeros((rows, nl, m_max // width), np.int64)
            for r, li, j in row_walk(nl, m_max // width, rows):
                np.add.at(written, (r, li, j), 1)
                for e in range(width):
                    col = j * width + e
                    bit = np.where(col < 32, (masks[b0 + r, li] >> np.minimum(col, 31).astype(
                        np.uint32)) & np.uint32(1), 0)
                    out[b0 + r, np.asarray(small)[li], col] = bit.astype(np.int32) * mul[b0 + r]
            assert (written == 1).all(), "each unit of the tile's rows written once"
        if blocks is not None:
            blocks.update({small[li]: tuple(int(x) for x in n) for li, n in drawn.items()})
    b = np.arange(batch, dtype=np.uint64)
    for idx, (M, lo, frac) in enumerate(parts):
        if M < 32:
            continue
        frac32 = np.float32(frac)
        out[:, idx, :] = 0
        if lo >= M and frac32 == 0:
            out[:, idx, :M] = mul[:, None]
            continue
        k_sel, k_round = level_keys(key, step, idx)
        m = np.arange(M, dtype=np.uint64)
        score = bits_of(k_sel, b[:, None] * np.uint64(M) + m[None, :]) >> np.uint32(9)
        u = uniform_of(bits_of(k_round, b))
        comp = ((score.astype(np.uint64) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - m))
        rank = (comp[:, None, :] > comp[:, :, None]).sum(axis=2)
        keep_n = lo + ((frac32 > 0) & (u < frac32)).astype(np.int64)
        out[:, idx, :M] = (rank < keep_n[:, None]).astype(np.int32) * mul[:, None]
    return out


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("d,s,r", CONFIGS)
def test_kernel_scheme_equals_jax(d, s, r, batch):
    for name, jkey, tkey, step in _keys():
        for mask in _masks(batch):
            want = _jax_weights(d, s, r, jkey, batch, mask)
            got = kernel_scheme(tkey.tolist(), None if step is None else int(step), mask,
                                batch, d, s, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} mask={mask}")


def test_kernel_scheme_at_the_widest_lattice():
    """d=12, s=6: levels of up to C(12, 6) = 924 combinations, the widest
    the kernel takes (d <= 12)."""
    _, jkey, tkey, step = _keys()[1]
    mask = _masks(7)[1]
    want = _jax_weights(12, 6, 0.5, jkey, 7, mask)
    np.testing.assert_array_equal(kernel_scheme(tkey.tolist(), int(step), mask, 7, 12, 6, 0.5),
                                  want)
    got = ref.sample_weights_ref(tkey, step, torch.from_numpy(mask), 7, 12, 6, 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_scheme_breaks_ties_by_index():
    """Equal 23-bit scores rank by index in the composite keys, as a
    stable argsort ranks equal floats; and the top l keys of the sorting
    network are the combinations of rank < l, for every l."""
    score = np.array([5, 9, 5, 5, 9, 0], np.uint32)
    m = np.arange(6, dtype=np.uint32)
    want = tproj.descending_ranks(torch.from_numpy(score.astype(np.float32))).numpy()
    for comp in ((score << np.uint32(5)) | (np.uint32(31) - m),
                 (score.astype(np.uint64) << np.uint64(32))
                 | (np.uint64(0xFFFFFFFF) - m.astype(np.uint64))):
        rank = (comp[None, :] > comp[:, None]).sum(axis=1)
        np.testing.assert_array_equal(rank, want)
    comp = np.zeros(sort_width(6), np.uint32)
    comp[:6] = (score << np.uint32(5)) | (np.uint32(31) - m)
    top = sort_descending(comp)
    for l in range(7):
        kept = {31 - int(c & 31) for c in top[:l]}
        assert kept == set(np.nonzero(want < l)[0].tolist()), l


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_sorting_network_sorts_descending(n):
    """The bitonic network of every width the kernel instantiates sorts
    random keys, ties and the zero padding in descending order."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=(200, n), dtype=np.uint32)
    keys[:50] = rng.integers(0, 3, size=(50, n), dtype=np.uint32)
    np.testing.assert_array_equal(sort_descending(keys), -np.sort(-keys.astype(np.int64), axis=1))


@pytest.mark.parametrize("nl", [1, 2, 3, 4, 5, 6, 7, 12, 16])
def test_small_kernel_row_walk_writes_every_unit_once(nl):
    """The CTA's row walk writes every unit of a tile's rows once: rows of
    fewer and more units than the CTA's threads, full tiles and tails."""
    for rows in (1, 31, 33, THREADS):
        for units in (1, 5, 6, 64, 256, 257, 1023):
            seen = np.zeros((rows, nl, units), np.int64)
            for r, li, j in row_walk(nl, units, rows):
                np.add.at(seen, (r, li, j), 1)
            assert (seen == 1).all(), (rows, units)


def test_kernel_scheme_draws_only_what_the_rows_read():
    """At the paper's widths (M = 20, 15, 6, 1): the level with frac == 0
    (k = 3, 10 of 20 kept) draws no Bernoulli and keeps the same top 10 as
    JAX; the one-combination level draws its Bernoulli and no score; 43
    threefry blocks per record in all."""
    batch = 300
    _, jkey, tkey, step = _keys()[1]
    want = _jax_weights(6, 3, 0.5, jkey, batch, None)
    blocks = {}
    got = kernel_scheme(tkey.tolist(), int(step), None, batch, 6, 3, 0.5, blocks=blocks)
    np.testing.assert_array_equal(got, want)
    assert blocks == {0: (0, 20 * batch), 1: (batch, 15 * batch), 2: (0, 6 * batch),
                      3: (batch, 0)}
    assert sum(a + b for a, b in blocks.values()) == 43 * batch
    assert (got[:, 0, :20].sum(axis=1) == 10).all()


@pytest.mark.parametrize("d,s,r", CONFIGS)
def test_kernel_levels_carry_frac_rounded_once_to_float32(d, s, r):
    """The kernel's level arrays: M, lo, and frac rounded once to float32,
    the value ``u < frac`` compares with in JAX (weak-typed) and in the
    plain version (``torch.tensor(frac, dtype=torch.float32)``)."""
    nums, los, fracs = ksw.level_arrays(d, s, r)
    for i, (m, lo, frac) in enumerate(tproj.level_sample_parts(d, s, r)):
        assert (nums[i], los[i]) == (m, lo)
        assert np.float32(fracs[i]) == np.float32(frac)
        assert torch.tensor(frac, dtype=torch.float32).item() == float(np.float32(frac))


@pytest.mark.parametrize("step", STEPS + [5, 2**31])
def test_on_card_key_derivation_equals_the_host_keys(step):
    """level_keys from (base key, step) equals split(fold_in(default_key,
    idx)) of the host chain, for explicit keys too (step None)."""
    cfg = tsjpc.SJPCConfig(d=6, s=3, seed=SEED)
    base = prng.PRNGKey(SEED ^ 0xC0FFEE)
    for key, st in ((base, step), (tsjpc.default_key(cfg, step), None)):
        for idx in range(4):
            want = prng.split(prng.fold_in(tsjpc.default_key(cfg, step), idx))
            k_sel, k_round = level_keys(key.tolist(), st, idx)
            got = np.array([[k_sel[0], k_sel[1]], [k_round[0], k_round[1]]], np.int64)
            np.testing.assert_array_equal(got, want.numpy())


def test_default_key_from_a_step_tensor_equals_the_host_default_key():
    """The update functions' default key, the base key folded with
    ``state.step`` where the draws run, is ``default_key(cfg, step)``."""
    cfg = tsjpc.SJPCConfig(d=5, s=2, ratio=0.75, seed=SEED)
    base = prng.PRNGKey(SEED ^ 0xC0FFEE)
    for step in (0, 3, 2**31 - 1):
        got = ops.sample_weights(base, 11, 5, 2, 0.75, step=torch.tensor(step, dtype=torch.int32))
        want = ops.sample_weights(tsjpc.default_key(cfg, step), 11, 5, 2, 0.75)
        assert torch.equal(got, want)


def test_op_runs_the_plain_version_on_the_cpu_and_counts_it():
    metrics = default_registry()
    before = metrics.counter("kernel_dispatch_total", kernel="sample_weights", impl=TORCH_REF)
    key = prng.PRNGKey(3)
    got = ops.sample_weights(key, 5, 6, 3, 0.5, row_mask=np.array([1, 0, 1, 1, 0]))
    assert got.shape == (5, 4, 20) and got.dtype == torch.int32 and got.device == key.device
    assert not bool(got[[1, 4]].any())
    assert metrics.counter("kernel_dispatch_total", kernel="sample_weights",
                           impl=TORCH_REF) == before + 1


def test_kernel_wrapper_raises_instead_of_falling_back():
    """The CUDA tier never runs the plain version: on CPU tensors it
    raises, and so does a lattice wider than the kernel takes (d = 13 has
    C(13, 6) = 1,716 combinations in a level)."""
    key = prng.PRNGKey(1)
    with pytest.raises(ValueError, match="cuda"):
        ksw.sample_weights(key, None, None, 4, 6, 3, 0.5)
    with pytest.raises(ValueError, match="1024"):
        ksw.sample_weights(key, None, None, 4, 13, 1, 0.5)


def test_update_functions_sample_through_the_op():
    """update and update_fused each make one sample_weights dispatch."""
    cfg = tsjpc.SJPCConfig(d=5, s=2, width=128, depth=2, seed=4)
    params, state = tsjpc.init(cfg, device="cpu")
    values = np.random.default_rng(4).integers(0, 3, size=(9, 5)).astype(np.uint32)
    metrics = default_registry()
    before = metrics.counter("kernel_dispatch_total", kernel="sample_weights", impl=TORCH_REF)
    fused = tsjpc.update_fused(cfg, params, state, values)
    per_level = tsjpc.update(cfg, params, state, values)
    assert torch.equal(fused.counters, per_level.counters)
    assert metrics.counter("kernel_dispatch_total", kernel="sample_weights",
                           impl=TORCH_REF) == before + 2
