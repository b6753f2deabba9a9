"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import projections as proj
from repro_torch.core import sjpc
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import fused_ingest as kfi
from repro_torch.kernels import fused_query as kfq
from repro_torch.kernels import ref

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


@pytest.mark.parametrize("width,depth", [(64, 1), (1024, 3), (65536, 5)])
@pytest.mark.parametrize("batch", [1, 513])
def test_fused_ingest_equals_plain(cuda, width, depth, batch):
    args = _ingest_args(np.random.default_rng(width + batch), cuda, batch, width, depth)
    before = kfi.launches
    assert torch.equal(kfi.fused_ingest(*args), ref.fused_ingest_ref(*args))
    assert kfi.launches == before + 1


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
