"""The benchmark's frozen work formulas agree with the program's
``kernels/work.py`` at the cells' shapes (bytes from the shapes alone, on
``meta`` tensors; operations from data)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import projections as proj
from repro_torch.kernels import work as port
from sjbench import work

CALL_ROWS = 1 << 20


@pytest.mark.parametrize("d,s", [(6, 3), (5, 3)])
def test_sjbench_fused_ingest_work(d, s):
    L, t, w = d - s + 1, 3, 1024
    pad = proj.padded_lattice(d, s)
    meta = dict(device="meta")
    args = (torch.empty((L, t, w), dtype=torch.int32, **meta),
            torch.empty((CALL_ROWS, d), dtype=torch.int64, **meta),
            torch.empty((L, pad.m_max, d), dtype=torch.int64, **meta),
            torch.empty((L, pad.m_max), dtype=torch.int64, **meta),
            torch.empty(2, dtype=torch.int64, **meta),
            torch.empty((L, t, 2, 4), dtype=torch.int64, **meta),
            torch.empty((L, t, 2, 4), dtype=torch.int64, **meta), None)
    assert work.fused_ingest(d, s, t, w, CALL_ROWS, [0] * L)[0] == \
        port.fused_ingest_work(args, {}, None).nbytes
    weights = (torch.rand((4096, L, pad.m_max)) < 0.5).to(torch.int32) \
        * torch.from_numpy(pad.valid.astype("int32"))[None]
    small = (torch.zeros((L, t, w), dtype=torch.int32), torch.zeros((4096, d), dtype=torch.int64),
             None, None, None, torch.zeros((L, t, 2, 4), dtype=torch.int64), None, weights)
    kept = (weights != 0).sum(dim=(0, 2)).tolist()
    assert work.fused_ingest(d, s, t, w, 4096, kept)[1] == \
        port.fused_ingest_work(small, {}, None, exact=True).ops["int32"]


@pytest.mark.parametrize("d,s", [(6, 3), (5, 3)])
def test_sjbench_sample_weights_work(d, s):
    parts = proj.level_sample_parts(d, s, 0.5)
    kept = torch.stack([torch.randint(0, m + 1, (CALL_ROWS,)) for m, _, _ in parts], dim=1)
    partial = [int(((kept[:, i] > 0) & (kept[:, i] < m)).sum()) for i, (m, _, _) in
               enumerate(parts)]
    nbytes, ops = work.sample_weights(d, s, 0.5, CALL_ROWS, partial)
    blocks = port.sampling_blocks(d, s, 0.5, CALL_ROWS, kept)
    assert ops == port.THREEFRY_OPS * blocks
    L, m_max = len(parts), max(m for m, _, _ in parts)
    assert nbytes == CALL_ROWS * L * m_max * 4 + 12
    assert work.bound_ms(nbytes, ops) == pytest.approx(port.bound_ms(nbytes, ops)[0], rel=1e-12)


@pytest.mark.parametrize("n,r,m", [(1024, 1755, 1755), (32768, 256, 256), (64, 1755, 900)])
def test_sjbench_fused_pairs_work(n, r, m):
    items = torch.empty((n, r, 6), dtype=torch.int64, device="meta")
    valid = torch.zeros((n, r), dtype=torch.int32)
    valid[:, :m] = 1
    got = port.fused_pairs_work((items, valid), {}, None, exact=True)
    assert work.fused_pairs(n, r, 6, m) == (got.nbytes, got.ops["int32"])
