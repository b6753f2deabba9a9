"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng
from repro_torch.core import projections as proj
from repro_torch.core import sjpc
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import fused_ingest as kfi
from repro_torch.kernels import fused_query as kfq
from repro_torch.kernels import ref
from repro_torch.kernels import sample_weights as ksw
from repro_torch.service.ingest import ingest_key

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t64(a, device):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def _ingest_args(rng, device, batch, width, depth, d=6, s=3):
    cfg = sjpc.SJPCConfig(d=d, s=s, width=width, depth=depth, seed=int(rng.integers(1 << 16)))
    params, _ = sjpc.init(cfg, device=device)
    pad = proj.padded_lattice(d, s)
    weights = rng.integers(0, 2, size=(batch, pad.num_levels, pad.m_max)) * pad.valid[None]
    counters = rng.integers(-9, 9, size=(pad.num_levels, depth, width)).astype(np.int32)
    return (torch.from_numpy(counters).to(device),
            _t64(rng.integers(0, 2**32, size=(batch, d), dtype=np.uint32), device),
            _t64(pad.masks, device), _t64(pad.ids, device), params.fp_bases,
            params.bucket_coeffs, params.sign_coeffs,
            torch.from_numpy(weights.astype(np.int32)).to(device))


@pytest.mark.parametrize("B", [1, 257, 4096])
def test_fingerprint_equals_plain(cuda, B):
    rng = np.random.default_rng(B)
    values = _t64(rng.integers(0, 2**32, size=(B, 6), dtype=np.uint32), cuda)
    bases = _t64([12345, 67890], cuda)
    for level in proj.lattice(6, 2):
        args = (values, _t64(level.masks, cuda), _t64(level.ids, cuda), bases)
        for g, w in zip(kfp.fingerprint(*args), ref.fingerprint_ref(*args)):
            assert torch.equal(g, w)


# (d, s, B): the paper lattice (65,537 records: 1,024 tiles of 64 and a
# tail of 1 at M = 20, 512 tiles of 128 and a tail of 1 at M <= 10), the
# request monitor's lattice (70,001: 546 tiles of 128 and a tail of 113),
# and d = 12 with levels of up to 924 combinations, more than a CTA's 256
# threads
FINGERPRINT_LATTICES = [(6, 3, 1), (6, 3, 65537), (4, 4, 1), (4, 4, 4), (4, 4, 70001),
                        (12, 6, 1), (12, 6, 1001)]


@pytest.mark.parametrize("d,s,B", FINGERPRINT_LATTICES)
def test_fingerprint_lattices_equal_plain(cuda, d, s, B):
    """Every level of each lattice, bit for bit, with one launch each."""
    rng = np.random.default_rng(B + d)
    values = _t64(rng.integers(0, 2**32, size=(B, d), dtype=np.uint32), cuda)
    bases = _t64(rng.integers(2, 2**31 - 1, size=2), cuda)
    for level in proj.lattice(d, s):
        args = (values, _t64(level.masks, cuda), _t64(level.ids, cuda), bases)
        before = kfp.launches
        got = kfp.fingerprint(*args)
        assert kfp.launches == before + 1
        for g, w in zip(got, ref.fingerprint_ref(*args)):
            assert torch.equal(g, w), f"d={d} s={s} B={B} k={level.k}"


def test_fingerprint_chunks_and_wide_records(cuda):
    """More than 1,024 combinations (several CTA columns), no column, and
    records of 64 columns and more, which go in 64-column blocks (65: two
    blocks, the second of one column; 200: four), each with one launch."""
    rng = np.random.default_rng(65)
    for B, M, d in ((300, 1300, 13), (777, 40, 64), (9, 3, 0), (300, 40, 65), (130, 7, 130),
                    (70, 1100, 200)):
        args = (_t64(rng.integers(0, 2**32, size=(B, d), dtype=np.uint32), cuda),
                _t64(rng.integers(0, 2, size=(M, d)), cuda),
                _t64(rng.integers(0, 2**32, size=M, dtype=np.uint32), cuda),
                _t64([7777, 2**31 - 2], cuda))
        before = kfp.launches
        got = kfp.fingerprint(*args)
        assert kfp.launches == before + 1
        for g, w in zip(got, ref.fingerprint_ref(*args)):
            assert torch.equal(g, w), (B, M, d)


@pytest.mark.parametrize("width,depth", [(64, 1), (1024, 3), (65536, 5)])
@pytest.mark.parametrize("batch", [1, 513])
def test_fused_ingest_equals_plain(cuda, width, depth, batch):
    args = _ingest_args(np.random.default_rng(width + batch), cuda, batch, width, depth)
    before = kfi.launches
    assert torch.equal(kfi.fused_ingest(*args), ref.fused_ingest_ref(*args))
    assert kfi.launches == before + 1


@pytest.mark.parametrize("batch", [1, 17, 100, 257, 4099])
@pytest.mark.parametrize("d,s", [(4, 2), (6, 3), (9, 4)])
def test_fused_ingest_remainders_and_lattices_equal_plain(cuda, batch, d, s):
    """Batch tails, the paper's lattice and one of 126-combination levels,
    with the field data as int64 and as the kernel's int32 words."""
    args = _ingest_args(np.random.default_rng(batch * d + s), cuda, batch, 1024, 3, d=d, s=s)
    want = ref.fused_ingest_ref(*args)
    words = (args[0],) + tuple(kfi.words32(a) for a in args[1:7]) + (args[7],)
    assert torch.equal(kfi.fused_ingest(*args), want)
    assert torch.equal(kfi.fused_ingest(*words), want)


@pytest.mark.parametrize("width,depth", [(1 << 14, 3), (1024, 5), (256, 1)])
def test_fused_ingest_planes_and_zero_weights(cuda, width, depth):
    """Planes in shared memory (w <= 1024: 80 KB at t = 5) and in global
    memory (w = 2^14: 786 KB), and all-zero weights, which leave the
    counters as they were."""
    args = _ingest_args(np.random.default_rng(width + depth), cuda, 65536, width, depth)
    assert torch.equal(kfi.fused_ingest(*args), ref.fused_ingest_ref(*args))
    zero = torch.zeros_like(args[7])
    assert torch.equal(kfi.fused_ingest(*args[:7], zero), args[0])


def test_fused_ingest_refuses_a_table_that_is_no_padded_lattice(cuda):
    """A table of the padded lattice's shape holding other combinations
    raises, before any launch."""
    args = list(_ingest_args(np.random.default_rng(3), cuda, 100, 1024, 3))
    masks = args[2].clone()
    masks[0, 0] = 1 - masks[0, 0]
    before = kfi.launches
    with pytest.raises(ValueError):
        kfi.fused_ingest(*args[:2], masks, *args[3:])
    assert kfi.launches == before


SAMPLE_CONFIGS = [(6, 3, 0.5), (4, 4, 1.0), (5, 2, 0.75), (9, 4, 0.3)]


@pytest.mark.parametrize("batch", [1, 4095, 65536])
@pytest.mark.parametrize("d,s,r", SAMPLE_CONFIGS)
def test_sample_weights_equals_plain(cuda, d, s, r, batch):
    """Bit for bit, with and without a row mask, under the default key at
    steps 0, 1 and 2^31 - 1 derived on the card from a step tensor, a host
    default key and an ingest key; d=9, s=4 has levels of 126
    combinations."""
    cfg = sjpc.SJPCConfig(d=d, s=s, ratio=r, seed=5)
    mask = torch.from_numpy((np.random.default_rng(batch).random(batch) < 0.6)
                            .astype(np.int32)).to(cuda)
    base = prng.PRNGKey(cfg.seed ^ 0xC0FFEE).to(cuda)
    keys = [(base, torch.tensor(step, dtype=torch.int32, device=cuda))
            for step in (0, 1, 2**31 - 1)]
    keys += [(sjpc.default_key(cfg, 7).to(cuda), None), (ingest_key(cfg, 3, 4).to(cuda), None)]
    for key, step in keys:
        for row_mask in (None, mask):
            before = ksw.launches
            got = ksw.sample_weights(key, step, row_mask, batch, d, s, r)
            assert ksw.launches == before + 1
            assert torch.equal(got, ref.sample_weights_ref(key, step, row_mask, batch, d, s, r))


def test_sample_weights_at_the_widest_lattice(cuda):
    """d=12, s=6: levels of up to 924 combinations, one CTA of 928 threads
    per (record, level)."""
    base = prng.PRNGKey(77).to(cuda)
    step = torch.tensor(3, dtype=torch.int32, device=cuda)
    mask = torch.from_numpy((np.random.default_rng(12).random(300) < 0.6)
                            .astype(np.int32)).to(cuda)
    got = ksw.sample_weights(base, step, mask, 300, 12, 6, 0.5)
    assert torch.equal(got, ref.sample_weights_ref(base, step, mask, 300, 12, 6, 0.5))


@pytest.mark.parametrize("batch", [1, 31, 4097, 65537])
@pytest.mark.parametrize("d,s,r", SAMPLE_CONFIGS)
def test_sample_weights_batch_tails_and_zero_mask(cuda, d, s, r, batch):
    """Batches that are no multiple of a warp's 32 records or of the
    persistent grid's stride, under a key derived on the card from a step
    tensor, with no mask, a random mask and an all-zero mask."""
    base = prng.PRNGKey(d * 100 + s).to(cuda)
    step = torch.tensor(batch % 1000, dtype=torch.int32, device=cuda)
    masks = [None, torch.zeros(batch, dtype=torch.int32, device=cuda),
             torch.from_numpy((np.random.default_rng(batch).random(batch) < 0.5)
                              .astype(np.int32)).to(cuda)]
    for row_mask in masks:
        got = ksw.sample_weights(base, step, row_mask, batch, d, s, r)
        assert torch.equal(got, ref.sample_weights_ref(base, step, row_mask, batch, d, s, r))
        if row_mask is not None and not bool(row_mask.any()):
            assert not bool(got.any())


def _ptxas_report(name):
    from repro_torch.kernels import _build
    return _build.build_all()[name].with_suffix(".log").read_text()


@pytest.mark.parametrize("name", ["sample_weights", "fingerprint", "fused_pairs",
                                  "sketch_update", "sketch_moments"])
def test_kernels_build_without_spills(cuda, name):
    """ptxas (-Xptxas -v) reports no spill and no stack frame for any
    function of the source: the composite keys, Horner state, i-rows,
    packed bins and key hashes stay in registers."""
    import re
    report = _ptxas_report(name)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
    frames = re.findall(r"(\d+) bytes stack frame", report)
    assert spills and frames, report
    assert all(a == "0" and b == "0" for a, b in spills), report
    assert set(frames) == {"0"}, report


def test_update_fused_reads_nothing_back_to_the_host(cuda):
    """With the records on the card and the default key, update_fused runs
    under sync debug mode "error": no device-to-host read, no blocking
    copy.  Its counters equal a CPU run's."""
    cfg = sjpc.SJPCConfig(d=6, s=3, width=1024, depth=3, seed=9)
    values = np.random.default_rng(9).integers(0, 2**32, size=(4096, 6), dtype=np.uint32)
    dev_values = torch.from_numpy(values.astype(np.int64)).to(cuda)
    params, state = sjpc.init(cfg, device=cuda)
    state = sjpc.update_fused(cfg, params, state, dev_values)   # builds and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = sjpc.update_fused(cfg, params, state, dev_values)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    params_c, state_c = sjpc.init(cfg, device="cpu")
    for _ in range(2):
        state_c = sjpc.update_fused(cfg, params_c, state_c, values)
    assert torch.equal(state.counters.cpu(), state_c.counters)
    assert int(state.step) == 2 and float(state.n) == 8192.0


@pytest.mark.parametrize("use_fused", [True, False])
def test_sharded_ingest_equals_plain(cuda, use_fused):
    """``ShardedIngest`` at 4 shards on the card, a masked and a ragged
    micro-batch: every shard's delta and the merged state through the
    kernels equal the ``impl="torch_ref"`` executor's, bit for bit."""
    cfg = sjpc.SJPCConfig(d=6, s=3, ratio=0.5, width=1024, depth=3, seed=7)
    params, _ = sjpc.init(cfg, device=cuda)
    rng = np.random.default_rng(26)
    kernel, plain = (sjpc.ShardedIngest(cfg, params, num_shards=4, use_fused=use_fused,
                                        impl=impl, device=cuda)
                     for impl in (None, "torch_ref"))
    for rows in (4096, 1001):
        batch = rng.integers(0, 2**32, size=(rows, cfg.d), dtype=np.uint32)
        mask = (rng.random(rows) < 0.8).astype(np.int32)
        kernel.ingest(batch, row_mask=mask)
        plain.ingest(batch, row_mask=mask)
    for got, want in zip(kernel.deltas, plain.deltas):
        assert torch.equal(got, want)
    for got, want in zip(kernel.merged(), plain.merged()):
        assert torch.equal(got, want)
    assert int(plain.deltas.step.sum()) == 8


@pytest.mark.parametrize("N,L,t,w", [(1, 1, 1, 64), (3, 4, 2, 1024), (2, 2, 5, 65536)])
def test_fused_query_equals_plain(cuda, N, L, t, w):
    rng = np.random.default_rng(N * w)
    a, b = (torch.from_numpy(rng.integers(-(2**20), 2**20, size=(N, L, t, w))
                             .astype(np.int32)).to(cuda) for _ in range(2))
    assert torch.equal(kfq.fused_query(a, b), ref.fused_query_ref(a, b))
    assert torch.equal(kfq.fused_query(a, a), ref.fused_query_ref(a, a))


def test_main_path_on_the_card_equals_the_cpu(cuda):
    """update_fused, update and the batched queries on the card give the
    CPU's numbers (the CPU runs the plain versions)."""
    cfg = sjpc.SJPCConfig(d=6, s=3, width=1024, depth=3, seed=7)
    rng = np.random.default_rng(7)
    params_g, state_g = sjpc.init(cfg, device=cuda)
    params_c, state_c = sjpc.init(cfg, device="cpu")
    per_level = state_g
    for i in range(3):
        values = rng.integers(0, 5, size=(3000, 6)).astype(np.uint32)
        mask = (rng.random(3000) < 0.7).astype(np.int32) if i == 1 else None
        state_g = sjpc.update_fused(cfg, params_g, state_g, values, row_mask=mask)
        state_c = sjpc.update_fused(cfg, params_c, state_c, values, row_mask=mask)
        per_level = sjpc.update(cfg, params_g, per_level, values, row_mask=mask)
    assert torch.equal(state_g.counters.cpu(), state_c.counters)
    assert torch.equal(per_level.counters, state_g.counters)
    assert float(state_g.n) == float(state_c.n) and int(state_g.step) == int(state_c.step)
    n = np.array([float(state_c.n)] * 2, np.float32)
    got = sjpc.estimate_batch(cfg, torch.stack([state_g.counters] * 2), n)
    want = sjpc.estimate_batch(cfg, torch.stack([state_c.counters] * 2), n)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    got = sjpc.estimate_join_batch(cfg, state_g.counters[None], per_level.counters[None],
                                   n[:1], n[:1])
    want = sjpc.estimate_join_batch(cfg, state_c.counters[None], state_c.counters[None],
                                    n[:1], n[:1])
    np.testing.assert_array_equal(got.y, want.y)


def _memcpys(prof) -> tuple[int, int]:
    """(host-to-device, device-to-host) copies the card ran under ``prof``."""
    counts = {e.key: e.count for e in prof.key_averages()}
    return tuple(sum(c for k, c in counts.items() if k.startswith(f"Memcpy {way}"))
                 for way in ("HtoD", "DtoH"))


@pytest.mark.parametrize("n_on_card", [True, False])
@pytest.mark.parametrize("join", [False, True])
def test_estimates_read_back_once(cuda, join, n_on_card):
    """One estimate_batch or estimate_join_batch copies nothing to the card
    and one buffer back (the moments, with n when it is on the card), and
    its (y, x, g) equal the plain path's bit for bit."""
    cfg = sjpc.SJPCConfig(d=6, s=3, width=1024, depth=3, seed=11)
    rng = np.random.default_rng(11)
    params, empty = sjpc.init(cfg, device=cuda)
    a, b = (rng.integers(0, 5, size=(rows, 6)).astype(np.uint32) for rows in (4000, 3000))
    a = sjpc.update_fused(cfg, params, empty, a)
    b = sjpc.subtract(sjpc.update_fused(cfg, params, a, b), a)
    ca, cb = torch.stack([a.counters, b.counters]), torch.stack([b.counters, a.counters])
    na, nb = torch.stack([a.n, b.n]), torch.stack([b.n, a.n])
    if not n_on_card:
        na, nb = na.cpu().numpy(), nb.cpu().numpy()

    def call():
        if join:
            return sjpc.estimate_join_batch(cfg, ca, cb, na, nb)
        return sjpc.estimate_batch(cfg, ca, na)

    call()                                    # builds the query kernel
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = call()
        torch.cuda.synchronize()
    assert _memcpys(prof) == (0, 1)
    moments = ref.fused_query_ref(ca, cb) if join else ref.fused_query_ref(ca, ca)
    want = sjpc.estimate_from_moments(cfg, moments, na, clamp=True, join=join)
    for name, w in zip("yxg", want):
        np.testing.assert_array_equal(getattr(got, name), w.astype(np.float64), err_msg=name)
    host_n = [np.asarray(torch.as_tensor(v).cpu(), np.float64) for v in (na, nb)]
    np.testing.assert_array_equal(got.n, np.stack(host_n, axis=1) if join else host_n[0])


# ---------------------------------------------------------------------------
# fused_pairs, sketch_update, sketch_moments, and the estimator path
# ---------------------------------------------------------------------------

from repro_torch import estimators as E  # noqa: E402
from repro_torch.kernels import fused_pairs as kfp2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sketch_moments as ksm  # noqa: E402
from repro_torch.kernels import sketch_update as ksu  # noqa: E402
from repro_torch.service.ingest import ingest_key_grid  # noqa: E402


@pytest.mark.parametrize("N,R,d,p_valid", [
    (1, 1, 3, 0.8), (3, 129, 6, 0.8), (2, 1755, 6, 0.8), (1, 300, 16, 0.8), (64, 256, 1, 0.8),
    (1024, 256, 6, 1.0),                      # the bootstrap's stacked replicates, scaled down
    (4, 127, 6, 0.8), (4, 128, 6, 0.8), (4, 257, 6, 0.8), (4, 513, 6, 0.8),   # around the tile
    (3, 300, 6, 0.0),                         # no valid slot
    (2, 700, 12, 1.0), (2, 700, 14, 1.0),     # d = 12 two i-rows a thread, d = 14 one
    (2, 700, 16, 1.0), (3, 1030, 16, 0.9)])   # d = 16: bins 8-16
def test_fused_pairs_equals_plain(cuda, N, R, d, p_valid):
    rng = np.random.default_rng(N * R + d)
    items = _t64(rng.integers(0, 3, size=(N, R, d), dtype=np.uint32), cuda)
    valid = torch.from_numpy((rng.random((N, R)) < p_valid).astype(np.int32)).to(cuda)
    before = kfp2.launches
    assert torch.equal(kfp2.fused_pairs(items, valid), ref.fused_pairs_ref(items, valid))
    assert kfp2.launches == before + 1


@pytest.mark.parametrize("n,t,w,near_2_31", [
    (1, 1, 64, False), (777, 3, 1024, False), (4096 * 42, 5, 65536, False),
    (0, 3, 1024, False), (100, 3, 1024, False),     # no key; fewer keys than one CTA's threads
    (81920, 3, 1024, False),                        # one level of an unfused round
    (4096, 3, 1024, False), (200000, 2, 64, False),
    (81920, 3, 1024, True), (4096 * 42, 5, 65536, True)])  # counters within 3 of +-2^31
def test_sketch_update_equals_plain(cuda, n, t, w, near_2_31):
    """The shared-tile path (planes up to 48 KB) and the global-atomic
    path (t=5, w=65536): equal to the plain version, one launch per call,
    the input counters unchanged, and a second call right after the first
    equal too."""
    rng = np.random.default_rng(n + t)
    params = sjpc.sk.make_sketch_params(rng, t, device=cuda)
    fp1, fp2 = (_t64(rng.integers(0, 2**31 - 1, size=n), cuda) for _ in range(2))
    weights = torch.from_numpy(rng.integers(-2, 3, size=n).astype(np.int32)).to(cuda)
    counters = rng.integers(-9, 9, size=(t, w)).astype(np.int32)
    if near_2_31:
        counters[0] = rng.integers(2**31 - 4, 2**31, size=w)
        counters[-1] = -(2**31) + rng.integers(0, 4, size=w)
    counters = torch.from_numpy(counters).to(cuda)
    before = counters.clone()
    args = (counters, fp1, fp2, params.bucket_coeffs, params.sign_coeffs, weights)
    want = ref.sketch_update_ref(*args)
    launches = ksu.launches
    for _ in range(2):
        assert torch.equal(ksu.sketch_update(*args), want)
    assert ksu.launches == launches + 2
    assert torch.equal(counters, before)
    zero = torch.zeros_like(weights)
    assert torch.equal(ksu.sketch_update(*args[:5], zero), counters)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 3, 64, 1000, 1024, 2048, 4096, 65536])
@pytest.mark.parametrize("t", [1, 3, 5])
def test_sketch_moments_equals_plain(cuda, t, w, offset):
    """Rows that are views at element offset 0 (int4 loads where w % 4 ==
    0) and 1 (4-byte loads) of a larger buffer, counters up to 2^20 and
    over the whole int32 range: the join and F2 (one pointer, and a copy)
    equal the plain version, F2 also fused_query's rows; one launch per
    call."""
    rng = np.random.default_rng(t * w + offset)
    for magnitude in (2**20, 2**31):
        a, b = (torch.from_numpy(rng.integers(-magnitude, magnitude, size=t * w + offset)
                                 .astype(np.int32)).to(cuda)[offset:].view(t, w)
                for _ in range(2))
        assert a.data_ptr() % 16 == 4 * offset
        launches = ksm.launches
        assert torch.equal(ksm.sketch_moments(a, b), ref.sketch_moments_ref(a, b))
        f2 = ksm.sketch_moments(a, a)
        assert torch.equal(f2, ref.sketch_moments_ref(a, a))
        assert torch.equal(ksm.sketch_moments(a, a.clone()), f2)
        assert ksm.launches == launches + 3
        assert torch.equal(f2, kfq.fused_query(a[None, None], a[None, None])[0, 0])


def test_sketch_moments_empty_shapes(cuda):
    """t == 0 launches nothing; w == 0 gives zeros."""
    launches = ksm.launches
    empty = torch.zeros((0, 1024), dtype=torch.int32, device=cuda)
    assert ksm.sketch_moments(empty, empty).shape == (0,)
    assert ksm.launches == launches
    zero = torch.zeros((3, 0), dtype=torch.int32, device=cuda)
    assert torch.equal(ksm.sketch_moments(zero, zero), torch.zeros(3, device=cuda))
    assert ksm.launches == launches + 1


@pytest.mark.parametrize("kind", ["sjpc", "reservoir", "lsh_ss"])
def test_estimator_round_trip_on_the_card_equals_the_cpu(cuda, kind):
    """ingest_rounds, merge, subtract and estimate_batch on the card give
    the CPU's states and tables (the CPU runs the plain versions)."""
    cfg = sjpc.SJPCConfig(d=6, s=3, width=256, depth=3, seed=11)
    rng = np.random.default_rng(11)
    R, S, B = 3, 4, 500
    values = rng.integers(0, 5, size=(R, S, B, 6)).astype(np.uint32)
    mask = np.ones((R, S, B), np.int32)
    mask[-1, :, 300:] = 0
    opts = {"use_fused": False} if kind == "sjpc" else None
    results = []
    for device in (cuda, torch.device("cpu")):
        est = E.make(kind, cfg, device=device, opts=opts)
        keys = ingest_key_grid(est.ingest_seed, np.arange(S),
                               np.broadcast_to(np.arange(R)[:, None], (R, S)))
        states = E.stack_states([est.init(sid=i + 1) for i in range(S)])
        states = est.ingest_rounds(states, values, mask, keys)
        a, b = E.index_state(states, 0), E.index_state(states, 1)
        back = est.subtract(est.merge(a, b), b)
        results.append((states, back, est.estimate_batch(states)))
    (sg, bg, tg), (sc, bc, tc) = results
    for got, want in ((sg, sc), (bg, bc)):
        for leaf_g, leaf_c in zip(got, want):
            assert torch.equal(leaf_g.cpu(), leaf_c)
    for field in ("x", "g", "y", "n", "stderr", "stderr_offline"):
        np.testing.assert_array_equal(getattr(tg, field), getattr(tc, field))


@pytest.mark.parametrize("use_fused", [True, False])
def test_service_on_the_card_equals_its_plain_twin(cuda, use_fused):
    """A small service with every kind in two groups, three epochs over a
    two-epoch window, on the card through the kernels and through the
    plain versions (``impl="torch_ref"``): every window state and every
    served result bit for bit."""
    from repro_torch import service as svc_mod
    cfg = sjpc.SJPCConfig(d=6, s=3, ratio=0.5, width=256, depth=3, seed=5)
    streams = (("a", "g", "sjpc"), ("b", "g", "sjpc"), ("r", "g", "reservoir"),
               ("l", "g", "lsh_ss"), ("c", "h", "sjpc"))
    services = []
    for impl in (None, "torch_ref"):
        svc = svc_mod.EstimationService(svc_mod.ServiceConfig(
            batch_rows=128, window_epochs=2, impl=impl, use_fused=use_fused))
        assert svc.device.type == "cuda"
        for gid in ("g", "h"):
            svc.create_group(gid, cfg)
        for name, gid, kind in streams:
            svc.create_stream(name, gid, estimator=kind,
                              backing_epochs=1 if kind == "reservoir" else 0)
        for q in (("qa", "self_join", ("a",)), ("qab", "join", ("a", "b")),
                  ("qc", "all_thresholds", ("c",)), ("qr", "all_thresholds", ("r",)),
                  ("ql", "self_join", ("l",))):
            svc.register_continuous(svc_mod.ContinuousQuery(*q))
        services.append(svc)
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = {name: rng.integers(0, 5, size=(300, 6)).astype(np.uint32)
                 for name, _, _ in streams}
        outs = []
        for svc in services:
            for name, rows in batch.items():
                svc.ingest(name, rows)
            svc.advance_epoch()
            outs.append(svc.poll())
        kernel, plain = services
        for name, _, _ in streams:
            for leaf_k, leaf_p in zip(kernel.registry.stream(name).window.total,
                                      plain.registry.stream(name).window.total):
                assert leaf_k.is_cuda and torch.equal(leaf_k, leaf_p), name
        assert outs[0].keys() == outs[1].keys()
        for qname in outs[0]:
            got, want = outs[0][qname], outs[1][qname]
            cells = zip(got.values(), want.values()) if isinstance(got, dict) \
                else [(got, want)]
            for g, w in cells:
                assert g._replace(per_level=None) == w._replace(per_level=None), qname
                np.testing.assert_array_equal(g.per_level, w.per_level)


def test_distributed_cluster_on_the_card_equals_its_oracle(cuda):
    """A 2-worker in-process cluster (workers, coordinator and replicas on
    the card) against the single-process oracle on the card, at the size
    of ``tests/test_distributed.py``: replica state bit for bit, every
    estimate within 1e-6, and an idle sync ships zero-byte heartbeats."""
    from repro_torch.distributed import harness
    spec = harness.make_spec(4, kinds=("sjpc", "reservoir"), d=5, s=3, width=128, depth=2,
                             seed=9, window_epochs=3, batch_rows=64)
    assert "device" not in spec.service
    batches = harness.make_batches(spec, cycles=3, rows_per_cycle=96, seed=5)
    run = harness.run_cluster(spec, batches, n_workers=2, cycles=3, local=True,
                              keep_open=True)
    coord = run.coordinator
    try:
        assert coord.replicas[0].device.type == "cuda"
        assert all(h.runtime.service.device.type == "cuda" for h in coord.workers)
        oracle = harness.run_oracle(spec, batches, cycles=3)
        agree = harness.compare_to_oracle(coord, oracle, spec)
        assert agree["linear_exact"] and agree["worst_rel_err"] <= 1e-6, agree
        assert all(t["deltas"] > 0 for t in run.sync_trace)
        stats = coord.sync()
        assert stats["deltas"] == 0 and stats["heartbeats"] == 2
    finally:
        coord.close()


def test_registry_resolves_cuda_tensors_to_the_kernels(cuda):
    from repro_torch.kernels.registry import kernel_registry
    reg = kernel_registry()
    assert {reg.select(op, cuda)[0] for op in reg.ops()} == {"cuda_sm90"}
    items = torch.zeros((2, 5, 3), dtype=torch.int64, device=cuda)
    valid = torch.ones((2, 5), dtype=torch.int32, device=cuda)
    before = kfp2.launches
    out = ops.fused_pairs(items[:, None], valid[:, None])
    assert kfp2.launches == before + 1 and out.shape == (2, 1, 4)
    assert int(out[0, 0, 3]) == 20


# ---------------------------------------------------------------------------
# flash attention and the dense serving path
# ---------------------------------------------------------------------------

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402

# The kernel and its plain version both compute in f32, in their own tiles
# and order, within FLASH_F32_TOL there (the JAX package's flash-kernel
# tolerance).  A bf16 output is that value rounded, so in bf16 they may
# differ by one bf16 ulp of the plain value on top, and never by more than
# 2e-2 (the JAX package's bf16 limit).
FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2


def assert_flash_close(got, want):
    diff = (got.float() - want.float()).abs()
    limit = torch.full_like(diff, FLASH_F32_TOL)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(want.float())
        limit += torch.ldexp(torch.ones_like(diff), e - 8) * (want != 0)
        assert float(diff.max()) <= FLASH_BF16_TOL
    assert not bool((diff > limit).any()), (float(diff.max()), int((diff > limit).sum()))


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 64, 64, 4, 2, 16), (1, 128, 128, 8, 8, 32), (2, 64, 128, 4, 1, 16),
    (1, 96, 96, 6, 3, 64),                                  # the JAX kernel test's grid
    (1, 200, 200, 16, 2, 128), (2, 1000, 1000, 16, 2, 128),  # ragged tiles, GQA 8:1
    (1, 64, 300, 8, 1, 128), (1, 4096, 4096, 16, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_equals_plain(cuda, b, sq, skv, h, kv, hd, dtype, causal):
    rng = np.random.default_rng(sq * h + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
               for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=causal)
    # f32 runs the split-operand kernel, bf16 the bf16 one
    assert _launch_counts() == _rose(before, dtype)
    want = ref.flash_attention_ref(q, k, v, causal=causal, block_q=sq, block_k=skv)
    assert got.dtype == dtype and got.shape == q.shape
    assert_flash_close(got, want)
    if causal:
        torch.testing.assert_close(got[:, 0].float(), v[:, 0].repeat_interleave(h // kv, 1)
                                   .float(), rtol=1e-5, atol=1e-5)


def _launch_counts():
    return kfa.launches, kfa.tc_launches


def _rose(before, dtype):
    """The launch counts after one call in ``dtype``."""
    f32, tc = before
    return (f32 + 1, tc) if dtype == torch.float32 else (f32, tc + 1)


def _case(seed, b, sq, skv, h, kv, hd, q_scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    return tuple(x.to("cuda", dtype) for x in (q * q_scale, k, v))


# (Sq, Skv) of the tensor-core kernels' cases: single rows, ragged 128-row
# query tiles and 32-, 64- or 128-key tiles, Sq < Skv and Sq > Skv
TC_LENGTHS = [(1, 1), (1, 63), (63, 129), (129, 63), (200, 200), (200, 1000), (1000, 200),
              (1000, 1000)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv", TC_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_cores_equals_plain(cuda, hd, sq, skv, causal):
    """bf16 through the tensor-core kernel, per element within one bf16 ulp
    of the plain version + 2e-5; 8 query heads over 8, 4 or 1 KV heads
    (GQA groups 1, 2 and 8, by case)."""
    kv = (8, 4, 1)[(TC_LENGTHS.index((sq, skv)) + hd // 16) % 3]
    q, k, v = _case(sq + 7 * skv + hd, 2, sq, skv, 8, kv, hd)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert _launch_counts() == _rose(before, torch.bfloat16)
    want = ref.flash_attention_ref(q, k, v, causal=causal, block_q=sq, block_k=skv)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_flash_close(got, want)


@pytest.mark.parametrize("kv", [8, 4, 1])
def test_flash_attention_bf16_large_scores_equal_plain(cuda, kv):
    """q scaled 8x: scores of tens, so the running max moves by large steps
    and the rescale of the accumulator matters."""
    q, k, v = _case(kv, 1, 1000, 1000, 8, kv, 128, q_scale=8.0)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    assert _launch_counts() == _rose(before, torch.bfloat16)
    assert_flash_close(got, ref.flash_attention_ref(q, k, v, causal=True, block_q=1000,
                                                    block_k=1000))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attention_bf16_first_token_is_v0(cuda, hd):
    """Causal row 0 sees key 0 only: out[:, 0] is v[:, 0] of its KV head."""
    q, k, v = _case(hd, 2, 300, 300, 8, 2, hd)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    assert _launch_counts() == _rose(before, torch.bfloat16)
    torch.testing.assert_close(got[:, 0].float(), v[:, 0].repeat_interleave(4, 1).float(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv", TC_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_tensor_cores_equals_plain(cuda, hd, sq, skv, causal):
    """f32 through the split-operand tensor-core kernel, within 2e-5 of the
    plain version; 8 query heads over 8, 4 or 1 KV heads (GQA groups 1, 2
    and 8, by case)."""
    kv = (8, 4, 1)[(TC_LENGTHS.index((sq, skv)) + hd // 16) % 3]
    q, k, v = _case(sq + 7 * skv + hd, 2, sq, skv, 8, kv, hd, dtype=torch.float32)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert _launch_counts() == _rose(before, torch.float32)
    want = ref.flash_attention_ref(q, k, v, causal=causal, block_q=sq, block_k=skv)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert_flash_close(got, want)


@pytest.mark.parametrize("kv", [8, 4, 1])
def test_flash_attention_f32_large_scores_equal_plain(cuda, kv):
    """q scaled 4x in f32: scores up to tens, so the running max moves by
    large steps and the rescale of the accumulator matters."""
    q, k, v = _case(kv, 1, 1000, 1000, 8, kv, 128, q_scale=4.0, dtype=torch.float32)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    assert _launch_counts() == _rose(before, torch.float32)
    assert_flash_close(got, ref.flash_attention_ref(q, k, v, causal=True, block_q=1000,
                                                    block_k=1000))


def exact_attention(q, k, v):
    """Causal attention in float64, KV heads repeated: the exact answer to
    the f32 inputs, up to float64 rounding."""
    b, sq, h, hd = q.shape
    kd, vd = (x.double().repeat_interleave(h // k.shape[2], 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / np.sqrt(hd)
    above = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device).triu(1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(above, -np.inf), -1), vd)


@pytest.mark.parametrize("kv", [8, 4, 1])
def test_flash_attention_f32_large_scores_near_exact(cuda, kv):
    """q scaled 8x in f32 (the bf16 case's scale): f32's rounding of scores
    this large moves the plain version itself about 2e-5 from the exact
    answer, so the kernel is held to the float64 answer, within 2e-5, and
    to no more than the plain version's distance from it."""
    q, k, v = _case(kv, 1, 1000, 1000, 8, kv, 128, q_scale=8.0, dtype=torch.float32)
    got = kfa.flash_attention(q, k, v, causal=True)
    want = exact_attention(q, k, v)
    plain = ref.flash_attention_ref(q, k, v, causal=True, block_q=1000, block_k=1000)
    err = float((got.double() - want).abs().max())
    assert err <= min(FLASH_F32_TOL, float((plain.double() - want).abs().max())), err


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attention_f32_first_token_is_v0(cuda, hd):
    """Causal row 0 sees key 0 only: out[:, 0] is v[:, 0] of its KV head."""
    q, k, v = _case(hd, 2, 300, 300, 8, 2, hd, dtype=torch.float32)
    before = _launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    assert _launch_counts() == _rose(before, torch.float32)
    torch.testing.assert_close(got[:, 0], v[:, 0].repeat_interleave(4, 1), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_f32_repeats_bit_for_bit(cuda):
    """The f32 forward at the kernel registry's f32 case, (2, 64, 64, 4, 2,
    16) causal, 200 times on the same inputs: every call gives the first
    call's bits, within FLASH_F32_TOL of the plain version (a race between
    the kernel's pre-pass, its copies and its products would show as calls
    that differ)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
               for shape in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    first = kfa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q.cpu(), k.cpu(), v.cpu(), causal=True, block_q=32,
                                   block_k=32)
    assert float((first.cpu() - want).abs().max()) <= FLASH_F32_TOL
    calls = [kfa.flash_attention(q, k, v, causal=True) for _ in range(200)]
    assert all(torch.equal(c, first) for c in calls)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 64, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="no keys"):
        kfa.flash_attention(q, q[:, :0, :2], q[:, :0, :2])


def test_chunked_prefill_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The reduced qwen2.5-3b prefill through the flash branch (threshold
    patched to 16): the kernel on the card against the plain version on
    the CPU, logits within 1e-5 and one launch per layer."""
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    cfg = configs.reduced("qwen2.5-3b")
    dims = compute_dims(cfg)
    params_c = tM.init_params(torch.Generator().manual_seed(0), cfg, dims, device="cpu")
    params_g = tM._tree_map(lambda x: x.to(cuda), params_c)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(3, 64)))
    before = kfa.launches
    lg_g, _ = tM.prefill(params_g, cfg, dims, prompts, compute_dtype=torch.float32,
                         attn_chunk=16)
    assert kfa.launches == before + cfg.num_layers
    lg_c, _ = tM.prefill(params_c, cfg, dims, prompts, compute_dtype=torch.float32,
                         attn_chunk=16)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the MoE, SSM and encoder-decoder serving paths at small widths
# ---------------------------------------------------------------------------

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402


def _family(arch, cuda):
    """The reduced config of ``arch`` with parameters drawn on the CPU and
    copied to the card: (cfg, dims, CPU params, card params)."""
    cfg = configs.reduced(arch)
    dims = compute_dims(cfg)
    params_c = tM.init_params(torch.Generator().manual_seed(3), cfg, dims, device="cpu")
    return cfg, dims, params_c, tM._tree_map(lambda x: x.to(cuda), params_c)


def _tree_close(got, want, rtol):
    """Every leaf of two caches within ``rtol`` of the leaf's max |x|;
    returns the number of leaves."""
    pairs = []

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                walk(a[key], b[key])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            pairs.append((a, b))

    walk(got, want)
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype
        top = float(b.abs().max())
        assert float((a.float() - b.float()).abs().max()) <= rtol * max(top, 1e-30)
    return len(pairs)


def test_encdec_prefill_kernel_path_equals_plain_path(cuda, monkeypatch):
    """The reduced seamless prefill with the flash branch at 16 tokens: the
    encoder (non-causal, Sq = Skv), the decoder (causal) and the
    cross-attention (non-causal, 48 queries on 32 memory rows) through the
    f32 kernel, one launch each per layer, against the plain path
    (``impl="torch_ref"``) on the card: logits and every cache leaf within
    1e-4 of max |x|."""
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    cfg, dims, _, params = _family("seamless-m4t-large-v2", cuda)
    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(0, 256, size=(3, 48))).to(cuda)
    frames = torch.from_numpy(rng.normal(size=(3, 32, cfg.d_model)).astype(np.float32)).to(cuda)
    before = kfa.launches
    lg, cache = tM.prefill(params, cfg, dims, prompts, enc_feats=frames,
                           compute_dtype=torch.float32, attn_chunk=16)
    assert kfa.launches == before + cfg.encoder_layers + 2 * cfg.num_layers
    lg_p, cache_p = tM.prefill(params, cfg, dims, prompts, enc_feats=frames,
                               compute_dtype=torch.float32, attn_chunk=16, impl="torch_ref")
    assert kfa.launches == before + cfg.encoder_layers + 2 * cfg.num_layers
    assert float((lg - lg_p).abs().max()) <= 1e-4 * float(lg_p.abs().max())
    assert _tree_close(cache.groups, cache_p.groups, 1e-4) == 4 * len(cache.groups)


def test_encdec_greedy_generate_on_the_card_equals_the_cpu(cuda):
    cfg, dims, params_c, params_g = _family("seamless-m4t-large-v2", cuda)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, 256, size=(3, 16))
    frames = rng.normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    got = tserve.greedy_generate(params_g, cfg, dims, torch.from_numpy(prompts), 6,
                                 enc_feats=torch.from_numpy(frames).to(cuda))
    want = tserve.greedy_generate(params_c, cfg, dims, torch.from_numpy(prompts), 6,
                                  enc_feats=torch.from_numpy(frames))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_ffn_on_the_card_equals_the_cpu(cuda, cf):
    cfg, dims, params_c, params_g = _family("deepseek-moe-16b", cuda)
    moe_c = params_c["groups"][1][0]["moe"]
    moe_c = {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()})
             for k, v in moe_c.items()}
    moe_g = tM._tree_map(lambda x: x.to(cuda), moe_c)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 96, cfg.d_model))
                         .astype(np.float32))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok, capacity_factor=cf)
    out_g, aux_g = tmoe.moe_ffn(moe_g, x.to(cuda), **kw)
    out_c, aux_c = tmoe.moe_ffn(moe_c, x, **kw)
    torch.testing.assert_close(out_g.cpu(), out_c, rtol=1e-5, atol=1e-5)
    for name in aux_c:
        torch.testing.assert_close(aux_g[name].cpu(), aux_c[name], rtol=1e-5, atol=1e-6)


def test_moe_prefill_kernel_path_equals_plain_path(cuda, monkeypatch):
    """The reduced deepseek-moe prefill through the flash branch (16
    tokens): the kernel path against the plain path on the card, logits and
    K/V within 1e-4 of max |x|; decode steps after it equal the CPU's."""
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    cfg, dims, params_c, params = _family("deepseek-moe-16b", cuda)
    prompts = torch.from_numpy(np.random.default_rng(10).integers(0, 256, size=(2, 64)))
    before = kfa.launches
    lg, cache = tM.prefill(params, cfg, dims, prompts, compute_dtype=torch.float32,
                           attn_chunk=16)
    assert kfa.launches == before + cfg.num_layers
    lg_p, cache_p = tM.prefill(params, cfg, dims, prompts, compute_dtype=torch.float32,
                               attn_chunk=16, impl="torch_ref")
    assert float((lg - lg_p).abs().max()) <= 1e-4 * float(lg_p.abs().max())
    _tree_close(cache.groups, cache_p.groups, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssm_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    """Mamba layers on the card against the CPU: the chunked scan's states
    after prefill, then decode steps (the states written back into the
    stacked cache in place), logits within 1e-4 of max |logit|; prefill of
    S-1 tokens then one decode step equals the prefill of S tokens."""
    cfg, dims, params_c, params_g = _family(arch, cuda)
    prompts = np.random.default_rng(11).integers(0, 256, size=(2, 24))
    lg, cache = tM.prefill(params_g, cfg, dims, torch.from_numpy(prompts),
                           compute_dtype=torch.float32, ssm_chunk=8)
    lg_c, cache_c = tM.prefill(params_c, cfg, dims, torch.from_numpy(prompts),
                               compute_dtype=torch.float32, ssm_chunk=8)
    assert float((lg.cpu() - lg_c).abs().max()) <= 1e-4 * float(lg_c.abs().max())
    _tree_close(tM._tree_map(lambda x: x.cpu(), cache.groups), cache_c.groups, 1e-4)
    lg23, pcache = tM.prefill(params_g, cfg, dims, torch.from_numpy(prompts[:, :23]),
                              compute_dtype=torch.float32, ssm_chunk=23)
    cache = tserve._rebase_cache(tM.init_cache(cfg, dims, 2, 26, dtype=torch.float32,
                                               device=cuda), pcache, 23)
    lg24, cache = tM.decode_step(params_g, cfg, dims, torch.from_numpy(prompts[:, 23:]), cache,
                                 compute_dtype=torch.float32)
    assert float((lg24 - lg).abs().max()) <= 1e-4 * float(lg.abs().max())
    mamba = [c for g in cache.groups for c in g if "mamba" in c][0]["mamba"]
    assert mamba["ssm"].dtype == torch.float32 and bool(mamba["ssm"].abs().sum() > 0)


def _tiny_train(device, impl=None):
    """A tiny LM's train step on ``device`` with the SJPC monitor; the
    state's parameters drawn on the CPU, so both devices start alike."""
    from repro_torch.launch import train
    from repro_torch.models.config import ArchConfig, compute_dims
    from repro_torch.optim import make_adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.sketchstream.monitor import SketchMonitorConfig, init_monitor
    from repro_torch.tree import tree_map

    cfg = ArchConfig(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
                     num_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16)
    dims = compute_dims(cfg, tp=1)
    mcfg = SketchMonitorConfig(d=6, s=3, width=256, depth=2)
    opt = make_adamw(constant(5e-3))
    state, _ = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims, opt,
                                      monitor_cfg=mcfg, device="cpu")
    state = tree_map(lambda x: x.to(device), state)
    mparams, _ = init_monitor(mcfg, device=device)
    step = train.make_train_step(cfg, dims, opt, monitor_cfg=mcfg, monitor_params=mparams,
                                 remat="full", compute_dtype=torch.float32, impl=impl)
    return state, step


def test_train_step_monitor_on_the_card_equals_its_plain_twin(cuda):
    """One train step on the card: the monitor's counters (the
    sample_weights, fingerprint and sketch_update kernels) equal a
    torch_ref twin's bit for bit, and its loss the CPU step's."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, size=(4, 49), dtype=np.int32)
    toks[1] = toks[0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    launches = (ksw.launches, kfp.launches)
    state, step = _tiny_train(cuda)
    got, metrics = step(state, {k: torch.from_numpy(v.copy()).to(cuda) for k, v in batch.items()})
    assert (ksw.launches - launches[0], kfp.launches - launches[1]) == (1, 4)
    twin_state, twin_step = _tiny_train(cuda, impl="torch_ref")
    want, _ = twin_step(twin_state, batch)
    assert torch.equal(got.monitor.counters, want.monitor.counters)
    assert torch.equal(got.monitor.n, want.monitor.n)
    cpu_state, cpu_step = _tiny_train("cpu")
    _, cpu_metrics = cpu_step(cpu_state, batch)
    assert abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) <= 1e-5
    assert int(got.step) == 1 and got.monitor.counters.device.type == "cuda"


# The backward kernel against its plain version on the same (out, lse):
# gradients relative to each one's max |x|.  f32 sums in its own order
# (FLASH_F32_TOL); a bf16 gradient is that value rounded, one bf16 ulp
# (2^-8 of the max) and a little more; with bf16 probabilities dP is
# rounded to bf16 too, where two f32 orders may round an element apart.
GRAD_BF16_TOL = 1e-2


def _grad_case(cuda, b, sq, skv, h, kv, hd, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=cuda).to(dtype)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                               (b, sq, h, hd)))


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 64, 64, 4, 2, 16), (1, 96, 96, 6, 3, 64), (2, 64, 128, 4, 1, 32),
    (1, 200, 200, 16, 2, 128), (1, 129, 63, 8, 8, 128), (1, 63, 300, 8, 1, 64),
    # lengths either side of the kernel's 32-, 64- and 128-row tiles
    (1, 127, 129, 8, 8, 128), (2, 129, 127, 8, 4, 64), (1, 255, 257, 8, 2, 32),
    (1, 257, 255, 16, 2, 128), (2, 255, 129, 4, 2, 16), (1, 129, 255, 8, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("probs", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_equals_plain(cuda, b, sq, skv, h, kv, hd, dtype, causal,
                                               probs):
    """The op under autograd on the card (the kernel forward with its
    log-sum-exp, then the backward kernel) against the plain tier's
    backward on the kernel forward's own out and lse."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops
    q, k, v, dout = _grad_case(cuda, b, sq, skv, h, kv, hd, dtype, sq + skv + hd)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = kfab.launches
    out = ops.flash_attention(*leaves, causal=causal, block_q=sq, block_k=skv,
                              probs_dtype=probs)
    got = torch.autograd.grad(out, leaves, dout)
    assert kfab.launches == before + 1
    out2, lse = kfa.flash_attention(q, k, v, causal=causal, probs_dtype=probs, return_lse=True)
    assert torch.equal(out2, out.detach())
    want = ref.flash_attention_bwd_ref(q, k, v, out2, lse, dout, causal=causal, block_q=sq,
                                       block_k=skv, probs_dtype=probs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert rel <= (FLASH_F32_TOL if dtype == probs == torch.float32 else GRAD_BF16_TOL), rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(cuda, dtype):
    """No atomics: two backward calls on the same inputs give the same
    bits; and the forward without lse stores the same output as with it."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k, v, dout = _grad_case(cuda, 1, 1000, 1000, 16, 2, 128, dtype, 1)
    out, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, kfa.flash_attention(q, k, v, causal=True))
    first = kfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    second = kfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (1, 1, 257, 4, 1, 16), (1, 257, 1, 8, 1, 64), (2, 1, 1, 4, 2, 32), (1, 1, 129, 8, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("probs", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_single_rows_and_keys(cuda, b, sq, skv, h, kv, hd, dtype,
                                                       causal, probs):
    """Sq or Skv of 1: the kernel's gradients (on its forward's out and
    lse) and the plain path's (on its own) against the float64 gradient,
    within the card's gate (kfab.GRAD_MULT, kfab.GRAD_FLOOR).  Where a row
    sees one key, dQ and dK are 0 up to rounding, and a relative gate
    against the plain version would compare two roundings' noise."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k, v, dout = _grad_case(cuda, b, sq, skv, h, kv, hd, dtype, sq + 2 * skv + hd)
    out, lse = kfa.flash_attention(q, k, v, causal=causal, probs_dtype=probs, return_lse=True)
    got = kfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, probs_dtype=probs)
    p_out, p_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=sq, block_k=skv,
                                               probs_dtype=probs)
    plain = ref.flash_attention_bwd_ref(q, k, v, p_out, p_lse, dout, causal=causal, block_q=sq,
                                        block_k=skv, probs_dtype=probs)
    exact = ref.attention_grads_f64(q, k, v, dout, causal=causal)
    floor = kfab.GRAD_FLOOR * max(float(x.abs().max()) for x in exact)
    for g, p, x in zip(got, plain, exact):
        assert g.dtype == dtype and g.shape == x.shape
        e_kernel = float((g.double() - x).abs().max())
        e_plain = float((p.double() - x).abs().max())
        assert e_kernel <= kfab.GRAD_MULT[dtype] * e_plain + floor, (e_kernel, e_plain, floor)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 200, 1000, 8, 1, 16), (1, 255, 257, 8, 2, 128), (1, 1000, 200, 4, 4, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_probabilities_round_at_the_final_max(cuda, b, sq, skv, h, kv, hd,
                                                                   causal):
    """With bf16 probabilities the bf16 forward kernel rounds P at its
    row's final max, as the plain version over one key chunk does: at most
    1 % of the outputs differ from the plain version's (rounded at the
    128-key tiles' running maxima, many more would:
    test_torch_flash_grad.py emulates both), and the kernel's gradients
    end to end are within the card's gate of the plain path's against the
    float64 gradient."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k, v, dout = _grad_case(cuda, b, sq, skv, h, kv, hd, torch.bfloat16, sq + skv + hd)
    out, lse = kfa.flash_attention(q, k, v, causal=causal, probs_dtype=torch.bfloat16,
                                   return_lse=True)
    kw = dict(causal=causal, block_q=sq, block_k=skv, probs_dtype=torch.bfloat16)
    p_out, p_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    assert float((out != p_out).float().mean()) <= 0.01
    got = kfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   probs_dtype=torch.bfloat16)
    plain = ref.flash_attention_bwd_ref(q, k, v, p_out, p_lse, dout, **kw)
    exact = ref.attention_grads_f64(q, k, v, dout, causal=causal)
    floor = kfab.GRAD_FLOOR * max(float(x.abs().max()) for x in exact)
    for g, p, x in zip(got, plain, exact):
        e_kernel = float((g.double() - x).abs().max())
        e_plain = float((p.double() - x).abs().max())
        assert e_kernel <= kfab.GRAD_MULT[torch.bfloat16] * e_plain + floor, (e_kernel, e_plain)


def test_flash_attention_backward_rejects_what_it_does_not_take(cuda):
    """The backward's wrapper raises on what the kernel does not take:
    misaligned data, a head dim outside 16/32/64/128, query heads that do
    not group over the KV heads, another dtype."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k, v, dout = _grad_case(cuda, 1, 64, 64, 4, 2, 64, torch.bfloat16, 3)
    out, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
    before = kfab.launches
    flat = torch.zeros(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = flat[1:q.numel() + 1].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        kfab.flash_attention_bwd(shifted, k, v, out, lse, dout)
    q48 = torch.zeros((1, 64, 4, 48), dtype=q.dtype, device=cuda)
    k48 = torch.zeros((1, 64, 2, 48), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kfab.flash_attention_bwd(q48, k48, k48, q48, lse, q48)
    k3 = torch.zeros((1, 64, 3, 64), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="group"):
        kfab.flash_attention_bwd(q, k3, k3, out, lse, dout)
    with pytest.raises(TypeError):
        kfab.flash_attention_bwd(*(x.half() for x in (q, k, v, out)), lse, dout.half())
    with pytest.raises(ValueError, match="no keys"):
        kfab.flash_attention_bwd(q, k[:, :0], v[:, :0], out, lse, dout)
    assert kfab.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_equals_plain(cuda, dtype, causal):
    q, k, v, _ = _grad_case(cuda, 2, 200, 330, 8, 2, 64, dtype, 2)
    _, lse = kfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    _, want = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=200, block_k=330)
    assert torch.isfinite(lse).all()
    assert float(((lse - want).abs() / want.abs().clamp_min(1)).max()) <= FLASH_F32_TOL
