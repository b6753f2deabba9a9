"""The frozen reference against the program's plain path on the CPU, at
small sizes: counters and reservoir states bit for bit, tables within
float64 rounding, the draws equal to the program's replay of jax.random."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import estimators
from repro_torch.core import prng as port_prng
from repro_torch.core import sjpc
from sjbench import datagen
from sjbench.reference import prng, reservoir
from sjbench.reference import sjpc as ref


def test_sjbench_prng_replays_the_program_stream():
    key = port_prng.fold_in(port_prng.PRNGKey(2**31 + 77), 5)
    assert torch.equal(prng.fold_in(prng.key(2**31 + 77), 5), key)
    keys = torch.randint(0, 1 << 32, (3, 2), dtype=torch.int64)
    bound = torch.tensor([[1], [1755], [2**31 - 1]], dtype=torch.int64)
    assert torch.equal(prng.randint(keys, 40, 0, bound),
                       port_prng.randint(keys, (40,), 0, bound).to(torch.int64))
    assert torch.equal(prng.unit_float(prng.bits(key, 3, 5)),
                       port_prng.uniform(key, (8,))[3:])


@pytest.mark.parametrize("d,s,ratio", [(6, 3, 0.5), (5, 3, 0.5), (4, 2, 0.75)])
def test_sjbench_counters_and_tables_match_the_port(d, s, ratio):
    seed = 2**31 + d
    cfg = sjpc.SJPCConfig(d=d, s=s, ratio=ratio, width=64, depth=3, seed=seed)
    table = datagen.shingles(2048, d, [[s, 0.1], [d, 0.05]], 4,
                             datagen.generator(seed, "cpu"), "cpu")
    params, state = sjpc.init(cfg, device="cpu")
    half = None
    for i in range(4):
        state = sjpc.update_fused(cfg, params, state, table[i * 512:(i + 1) * 512])
        if i == 1:
            half = state
    sk = ref.Sketcher(d, s, ratio, 64, 3, seed, "cpu")
    first = sk.scan(table[:1024], 512, 0)
    second = sk.scan(table[1024:], 512, 2)
    assert torch.equal(state.counters.to(torch.int64), first + second)
    assert torch.equal(half.counters.to(torch.int64), first)
    want = ref.tables(d, s, ratio, first + second, 2048.0)
    got = sjpc.estimate(cfg, state)
    np.testing.assert_allclose(got.x, want["x"], rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(got.y, want["y"], rtol=1e-12)
    np.testing.assert_allclose(got.g_s, want["g"][0], rtol=1e-12)
    rest = sjpc.subtract(state, half)
    join = sjpc.estimate_join(cfg, half, rest)
    want = ref.tables(d, s, ratio, first, 1024.0, second)
    np.testing.assert_allclose(join.x, want["x"], rtol=1e-12, atol=1e-9)


def test_sjbench_reservoir_rounds_and_query_match_the_port():
    seed, S, B, d = 2**31 + 9, 3, 40, 6
    scfg = sjpc.SJPCConfig(d=d, s=3, width=16, depth=3, seed=seed)
    est = estimators.make("reservoir", scfg, device="cpu",
                          opts={"bootstrap_replicates": 8, "bootstrap_item_cap": 16})
    cap = reservoir.equal_space_capacity(d, 3, 16, 3)
    assert est.cfg.capacity == cap
    pool = datagen.shingles(4096, d, [[3, 0.2], [6, 0.05]], 6,
                            datagen.generator(seed, "cpu"), "cpu")
    keys = torch.randint(0, 1 << 32, (6, S, 2), dtype=torch.int64)
    states = estimators.stack_states([est.init(sid=i) for i in range(S)])
    st = (torch.zeros((S, cap, d), dtype=torch.int64), torch.full((S, cap), -1, dtype=torch.int32),
          torch.zeros(S, dtype=torch.int64), torch.zeros(S, dtype=torch.int32))
    sid = torch.arange(S, dtype=torch.int32)
    for r in range(6):
        vals = pool[r * S * B:(r + 1) * S * B].view(S, B, d)
        mask = torch.ones((S, B), dtype=torch.int32)
        if r == 5:
            mask[1, ::3] = 0
        states = est.ingest_rounds(states, vals[None], mask[None], keys[r][None])
        st = reservoir.ingest_round(*st[:3], sid, st[3], vals, mask, keys[r], cap)
    assert torch.equal(states.items, st[0]) and torch.equal(states.tags, st[1])
    assert torch.equal(states.n.to(torch.int64), st[2]) and torch.equal(states.step, st[3])
    table = est.estimate_batch(states)
    want = reservoir.query(*st, s=3, seed=seed, replicates=8, item_cap=16)
    port = {"x": table.x, "g": table.g, "y": table.y, "stderr": table.stderr}
    assert reservoir.table_gap(port, want) < 1e-12
    low = reservoir.query(*st, s=3, seed=seed, replicates=8, item_cap=16, dtype=torch.float32)
    assert reservoir.table_gap(low, want) > 1e-9
