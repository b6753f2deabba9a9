"""One-pass scans of a table on the card: a closed loop of estimation jobs.

A job starts from empty states (the hash parameters made once, in set-up,
by ``sjpc.init``), absorbs the first half of the table and then the second
in ``update_fused`` calls of ``call_rows`` rows (views of the table, no
copy), takes the second half's state by ``subtract``, and reads to the host
the self-join table of the whole (``estimate_batch``) and the join table
of the two halves (``estimate_join_batch``).  Then the next job starts.

Every job's tables are compared with the plain reference's; the counters
of the first job of the window, of jobs drawn from the seed and of the last
job are compared bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from sjbench import datagen, work
from sjbench.reference import sjpc as ref

KEEP_EVERY = 64        # about one job in this many keeps its states for the check


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from repro_torch.core import sjpc
        self.sjpc, self.spans = sjpc, spans
        c, tr = cell.config, cell.traffic
        self.c, self.seed, self.device = c, seed, torch.device(device)
        self.cfg = sjpc.SJPCConfig(d=c["d"], s=c["s"], ratio=c["ratio"], width=c["width"],
                                   depth=c["depth"], seed=seed)
        self.table = datagen.table(c, seed, self.device)
        self.rows = self.table.shape[0]
        self.call_rows = int(tr["call_rows"])
        if self.rows % (2 * self.call_rows):
            raise ValueError(f"{self.rows} rows do not split into halves of whole calls of "
                             f"{self.call_rows}")
        self.calls = [self.table[i:i + self.call_rows]
                      for i in range(0, self.rows, self.call_rows)]
        self.half_calls = len(self.calls) // 2
        self.limits = tr["limits"]
        self.params, self.empty = sjpc.init(self.cfg, device=self.device)
        self.keep = np.random.default_rng([seed, 0x5CA7]).random(1 << 20) < 1 / KEEP_EVERY
        self.jobs = 0
        self.tables = []
        self.kept = {}
        self.counts = {"records": 0}
        self.step()                            # the warm job, of the window's shapes
        self.counts = {"records": 0}

    def step(self) -> None:
        sjpc, cfg, params = self.sjpc, self.cfg, self.params
        state = self.empty
        half = None
        for i, values in enumerate(self.calls):
            with self.spans("update_fused"):
                state = sjpc.update_fused(cfg, params, state, values)
            if i == self.half_calls - 1:
                half = state
        with self.spans("estimate"):
            second = sjpc.subtract(state, half)
            whole = sjpc.estimate_batch(cfg, state.counters[None], state.n[None])
            join = sjpc.estimate_join_batch(cfg, half.counters[None], second.counters[None],
                                            half.n[None], second.n[None])
        self.tables.append((whole, join))
        if self.jobs < 2 or self.keep[self.jobs % self.keep.size]:
            self.kept[self.jobs] = (half, state, second)
        self.last = (half, state, second)
        self.jobs += 1
        self.counts["records"] += self.rows

    def release(self) -> None:
        """Drop what the check does not read."""
        self.kept[self.jobs - 1] = self.last
        self.params = self.empty = self.last = None

    def _reference(self):
        c = self.c
        sk = ref.Sketcher(c["d"], c["s"], c["ratio"], c["width"], c["depth"], self.seed,
                          self.device)
        h = self.rows // 2
        self.work_stats = []
        first = sk.scan(self.table[:h], self.call_rows, 0, self.work_stats)
        second = sk.scan(self.table[h:], self.call_rows, self.half_calls, self.work_stats)
        return first, first + second, second

    def check(self):
        c = self.c
        ref_half, ref_whole, ref_second = self._reference()
        h = float(self.rows // 2)
        want_self = ref.tables(c["d"], c["s"], c["ratio"], ref_whole, 2 * h)
        want_join = ref.tables(c["d"], c["s"], c["ratio"], ref_half, h, ref_second)
        mismatch = 0
        bad_jobs = set()
        for j, states in self.kept.items():
            for st, want, n in zip(states, (ref_half, ref_whole, ref_second), (h, 2 * h, h)):
                wrong = int((st.counters.to(torch.int64) != want).sum()) + int(float(st.n) != n)
                mismatch += wrong
                if wrong:
                    bad_jobs.add(j)
        gap = 0.0
        for j, (whole, join) in enumerate(self.tables):
            g = max(ref.table_gap(_row(whole), want_self, c["ratio"]),
                    ref.table_gap(_row(join), want_join, c["ratio"]))
            gap = max(gap, g)
            if g > self.limits["table_gap"]:
                bad_jobs.add(j)
        checks = {"counter_mismatch": (mismatch, self.limits["counter_mismatch"]),
                  "table_gap": (gap, self.limits["table_gap"])}
        return checks, self.jobs, len(bad_jobs)

    def bounds(self) -> dict:
        """The least milliseconds of each ``update_fused`` call of a job, in
        order: its draws and its fused ingest (:mod:`sjbench.work`)."""
        c = self.c
        out = []
        for stats in self.work_stats:
            sb, so = work.sample_weights(c["d"], c["s"], c["ratio"], self.call_rows,
                                         [p for p, _ in stats])
            fb, fo = work.fused_ingest(c["d"], c["s"], c["depth"], c["width"], self.call_rows,
                                       [k for _, k in stats])
            out.append(work.bound_ms(sb, so) + work.bound_ms(fb, fo))
        return {"update_fused": out}


def _row(est) -> dict:
    return {"x": est.x[0], "g": est.g[0], "y": est.y[0]}


def control(cell, seed: int, device) -> dict:
    """The compared numbers of the control: the reference in the program's
    place with its tables computed in bfloat16, the precision below the
    float32 the configuration states."""
    c = cell.config
    table = datagen.table(c, seed, device)
    sk = ref.Sketcher(c["d"], c["s"], c["ratio"], c["width"], c["depth"], seed, device)
    call_rows = int(cell.traffic["call_rows"])
    h = table.shape[0] // 2
    first = sk.scan(table[:h], call_rows, 0)
    second = sk.scan(table[h:], call_rows, h // call_rows)
    gaps = []
    for a, n, b in ((first + second, 2.0 * h, None), (first, float(h), second)):
        want = ref.tables(c["d"], c["s"], c["ratio"], a, n, b)
        low = ref.tables(c["d"], c["s"], c["ratio"], a, n, b, dtype=torch.bfloat16)
        gaps.append(ref.table_gap(low, want, c["ratio"]))
    return {"counter_mismatch": 0, "table_gap": max(gaps)}
