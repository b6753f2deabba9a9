"""Batched all-thresholds queries over reservoir-sample tenants: a closed
loop of one caller.

Set-up makes ``streams`` reservoir states of the configuration's group
(the paper's equal-space capacity, which ``capacity_for_bytes`` gives), a pool of records
(the configuration's table) and a key per (round, stream), all on the card,
and fills every reservoir with ``fill_rounds`` rounds.  A step is one
``ingest_rounds`` round of ``round_rows`` pool rows into every stream, then
one ``estimate_batch`` with the estimator's bootstrap, ending with the
table on the host.

The check replays the fill from empty states with the plain reference, and,
for the window's first and last steps and steps drawn from the seed,
the round from the program's own state before it (the reference follows
the program there) and the query from the reference's state after it.
"""
from __future__ import annotations

import numpy as np
import torch

from sjbench import datagen, work
from sjbench.reference import reservoir as ref

KEY_ROUNDS = 8192      # rounds of keys made in set-up; later rounds reuse them in turn
DRAWN_STEPS = 3        # window steps drawn from the seed for the check, besides two


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from repro_torch import estimators
        from repro_torch.core.sjpc import SJPCConfig
        c, tr = cell.config, cell.traffic
        self.c, self.tr, self.seed, self.spans = c, tr, seed, spans
        self.device = torch.device(device)
        scfg = SJPCConfig(d=c["d"], s=c["s"], ratio=c["ratio"], width=c["width"],
                          depth=c["depth"], seed=seed)
        self.est = estimators.make("reservoir", scfg, device=self.device,
                                   opts={"bootstrap_replicates": tr["bootstrap_replicates"],
                                         "bootstrap_item_cap": tr["bootstrap_item_cap"]})
        self.S, self.B = int(tr["streams"]), int(tr["round_rows"])
        self.capacity = ref.equal_space_capacity(c["d"], c["s"], c["width"], c["depth"])
        self.limits = tr["limits"]
        self.pool = datagen.table(c, seed, self.device)
        if self.pool.shape[0] % (self.S * self.B):
            raise ValueError("the pool must hold whole rounds")
        self.pool_rounds = self.pool.shape[0] // (self.S * self.B)
        gen = datagen.generator(seed, self.device, stream=1)
        self.keys = torch.randint(0, 1 << 32, (KEY_ROUNDS, self.S, 2), generator=gen,
                                  device=self.device, dtype=torch.int64)
        self.mask = torch.ones((1, self.S, self.B), dtype=torch.int32, device=self.device)
        init = estimators.stack_states([self.est.init(sid=i) for i in range(self.S)])
        fill = int(tr["fill_rounds"])
        vals = torch.stack([self.round_values(r)[0] for r in range(fill)])
        self.states = self.est.ingest_rounds(init, vals,
                                             self.mask.expand(fill, -1, -1).contiguous(),
                                             self.keys[:fill])
        self.filled = self.states
        self.round = fill
        rng = np.random.default_rng([seed, 0x5A4B])
        self.drawn = set(rng.integers(2, 4096, size=DRAWN_STEPS).tolist())
        self.kept = {}
        self.steps = 0
        self.counts = {}
        self.step()                            # the warm step, of the window's shapes
        self.kept.clear()
        self.steps = 0

    def round_values(self, r: int) -> torch.Tensor:
        """(1, S, B, d) pool rows of round ``r``: a view."""
        off = (r % self.pool_rounds) * self.S * self.B
        return self.pool[off:off + self.S * self.B].view(1, self.S, self.B, -1)

    def step(self) -> None:
        r = self.round
        before = self.states
        with self.spans("ingest_rounds"):
            after = self.est.ingest_rounds(before, self.round_values(r), self.mask,
                                           self.keys[r % KEY_ROUNDS][None])
        with self.spans("estimate_batch"):
            table = self.est.estimate_batch(after)
        if self.steps in self.drawn or self.steps == 0:
            self.kept[self.steps] = (r, before, after, table)
        self.last = (r, before, after, table)
        self.states = after
        self.round += 1
        self.steps += 1

    def release(self) -> None:
        self.kept[self.steps - 1] = self.last
        self.states = self.last = None

    def _state(self, st):
        return (st.items, st.tags, st.n.to(torch.int64), st.step)

    def _mismatch(self, port, want) -> int:
        return sum(int((a.to(torch.int64) != b.to(torch.int64)).sum())
                   for a, b in zip(self._state(port), want))

    def check(self):
        S, B, cap = self.S, self.B, self.capacity
        dev = self.device
        sid = torch.arange(S, dtype=torch.int32, device=dev)
        st = (torch.zeros((S, cap, self.c["d"]), dtype=torch.int64, device=dev),
              torch.full((S, cap), -1, dtype=torch.int32, device=dev),
              torch.zeros(S, dtype=torch.int64, device=dev),
              torch.zeros(S, dtype=torch.int32, device=dev))
        ones = torch.ones((S, B), dtype=torch.int32, device=dev)
        for r in range(int(self.tr["fill_rounds"])):
            st = ref.ingest_round(*st[:3], sid, st[3], self.round_values(r)[0], ones,
                                  self.keys[r], cap)
        mismatch = self._mismatch(self.filled, st) if self.est.cfg.capacity == cap \
            else S * cap
        self.valid_slots = int((st[1] >= 0).sum(dim=1).min())
        gap = 0.0
        bad = 0
        for r, before, after, table in self.kept.values():
            items, tags, n, step = self._state(before)
            want = ref.ingest_round(items, tags, n, sid, step, self.round_values(r)[0], ones,
                                    self.keys[r % KEY_ROUNDS], cap)
            wrong = self._mismatch(after, want)
            rt = ref.query(want[0], want[1], want[2], want[3], self.c["s"], self.seed,
                           int(self.tr["bootstrap_replicates"]),
                           int(self.tr["bootstrap_item_cap"]))
            g = ref.table_gap({"x": table.x, "g": table.g, "y": table.y,
                               "stderr": table.stderr}, rt)
            mismatch += wrong
            gap = max(gap, g)
            bad += int(wrong > 0 or g > self.limits["table_gap"])
        checks = {"state_mismatch": (mismatch, self.limits["state_mismatch"]),
                  "table_gap": (gap, self.limits["table_gap"])}
        return checks, self.steps, bad

    def bounds(self) -> dict:
        """The least milliseconds of one query's pair histograms: the
        samples' and the bootstrap replicates' (:mod:`sjbench.work`)."""
        d, S = self.c["d"], self.S
        m = self.valid_slots
        reps, b = int(self.tr["bootstrap_replicates"]), int(self.tr["bootstrap_item_cap"])
        b = min(b, self.capacity)
        qb, qo = work.fused_pairs(S, self.capacity, d, m)
        rb, ro = work.fused_pairs(S * reps, b, d, min(b, m))
        return {"estimate_batch": [work.bound_ms(qb, qo) + work.bound_ms(rb, ro)]}


def control(cell, seed: int, device) -> dict:
    """The compared numbers of the control: the reference in the program's
    place, its fill and one window round at the cell's size, with the
    table computed in float32, the precision below the float64 the
    program's tables carry."""
    c, tr = cell.config, cell.traffic
    device = torch.device(device)
    S, B = int(tr["streams"]), int(tr["round_rows"])
    cap = ref.equal_space_capacity(c["d"], c["s"], c["width"], c["depth"])
    pool = datagen.table(c, seed, device)
    gen = datagen.generator(seed, device, stream=1)
    keys = torch.randint(0, 1 << 32, (KEY_ROUNDS, S, 2), generator=gen, device=device,
                         dtype=torch.int64)
    st = (torch.zeros((S, cap, c["d"]), dtype=torch.int64, device=device),
          torch.full((S, cap), -1, dtype=torch.int32, device=device),
          torch.zeros(S, dtype=torch.int64, device=device),
          torch.zeros(S, dtype=torch.int32, device=device))
    sid = torch.arange(S, dtype=torch.int32, device=device)
    ones = torch.ones((S, B), dtype=torch.int32, device=device)
    rounds = pool.shape[0] // (S * B)
    for r in range(int(tr["fill_rounds"]) + 1):
        off = (r % rounds) * S * B
        st = ref.ingest_round(*st[:3], sid, st[3], pool[off:off + S * B].view(S, B, -1), ones,
                              keys[r], cap)
    args = (st[0], st[1], st[2], st[3], c["s"], seed, int(tr["bootstrap_replicates"]),
            int(tr["bootstrap_item_cap"]))
    want = ref.query(*args)
    low = ref.query(*args, dtype=torch.float32)
    return {"state_mismatch": 0, "table_gap": ref.table_gap(low, want)}
