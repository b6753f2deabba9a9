"""Streaming LSH-SS behind the Estimator protocol, ported from the JAX
package's ``estimators/lsh_ss.py``.

The paper's stratified competitor (§2.3, Lee et al.), one pass:

  * a **bucket-count sketch**: one counter per LSH bucket (the values of
    ``num_hash_cols`` chosen columns, avalanche-hashed into
    ``num_buckets`` slots); sum c_b(c_b - 1) estimates the same-stratum
    ordered-pair count.  Linear, so merge/subtract are counter arithmetic.
  * a **record reservoir** (Algorithm R, with each record's bucket id):
    every arriving record g is paired with one uniform earlier record -- a
    uniform rank u in [0, g) resolves to the in-batch record when it falls
    in the current round, else to a stored reservoir slot.  The pair is a
    same- or cross-stratum candidate by bucket equality.
  * two **stratified pair reservoirs**: per stratum, Algorithm R over its
    candidate pairs, storing each pair's match count.

Estimates: g_s = f1 * same_pairs + f2 * cross_pairs + n; the stderr is
the stratified bootstrap of :mod:`.uncertainty` (host numpy).  No kernel
runs here: the update is plain PyTorch on the states' device, one call per
round for all S streams (the states carry a leading stream axis), and the
query is host numpy.  The uint32 hash is carried in int64 with 32-bit
masks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import platform
from ..core import prng
from ..core.hashing import as_field_tensor
from ..core.prng import mul_u32
from . import uncertainty
from .base import (EstimateTable, Estimator, merge_tagged_samples, pairwise_exact_oracle,
                   register, scan_rounds)
from .reservoir import reservoir_accept

_MERGE_SALT = 0x15A55B01
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LSHSSConfig:
    d: int                     # record dimensionality
    s: int                     # lowest queryable threshold
    num_hash_cols: int = 1     # LSH column-subset size c, 1 <= c <= d
    num_buckets: int = 1024    # hashed bucket counters (power of two)
    record_capacity: int = 256   # record reservoir slots
    pair_capacity: int = 256     # pair reservoir slots per stratum
    seed: int = 0x5A5A

    def __post_init__(self):
        if not 1 <= self.s <= self.d:
            raise ValueError(f"need 1 <= s={self.s} <= d={self.d}")
        if not 1 <= self.num_hash_cols <= self.d:
            raise ValueError(f"num_hash_cols={self.num_hash_cols} outside [1, d={self.d}]")
        if self.num_buckets & (self.num_buckets - 1):
            raise ValueError("num_buckets must be a power of two")
        assert self.record_capacity >= 1 and self.pair_capacity >= 1


class LSHSSState(NamedTuple):
    counts: torch.Tensor      # (Bh,) int32 records per hashed bucket
    rec_items: torch.Tensor   # (R, d) int64: uint32 record reservoir
    rec_bucket: torch.Tensor  # (R,) int32 bucket id of each stored record
    rec_tags: torch.Tensor    # (R,) int32 provenance; -1 = empty
    same_sim: torch.Tensor    # (M,) int32 match counts, same-bucket stratum
    same_tags: torch.Tensor   # (M,) int32
    same_seen: torch.Tensor   # int32 same-stratum candidates seen
    cross_sim: torch.Tensor   # (M,) int32 match counts, cross-bucket stratum
    cross_tags: torch.Tensor  # (M,) int32
    cross_seen: torch.Tensor  # int32
    n: torch.Tensor           # int32 records seen
    sid: torch.Tensor         # int32 provenance tag for insertions
    step: torch.Tensor        # int32 rounds that carried data


def _gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table (S, R, ...) and index (S, B) -> table[s, index[s, b], ...]."""
    if table.ndim == 2:
        return torch.gather(table, 1, index)
    return torch.gather(table, 1, index[..., None].expand(index.shape + table.shape[2:]))


class LSHSSEstimator(Estimator):
    kind = "lsh_ss"
    linear = False
    supports_join = False

    def __init__(self, cfg: LSHSSConfig, *,
                 bootstrap_replicates: int = uncertainty.DEFAULT_REPLICATES, device=None):
        self.cfg = cfg
        self.device = platform.resolve(device)
        rng = np.random.default_rng(cfg.seed ^ 0x15AC01)
        self.cols = np.sort(rng.choice(cfg.d, size=cfg.num_hash_cols, replace=False))
        if bootstrap_replicates == 1:
            raise ValueError("bootstrap_replicates must be 0 (disabled) "
                             "or >= 2 (a std needs two replicates)")
        self.bootstrap = int(bootstrap_replicates)

    @property
    def d(self) -> int:
        return self.cfg.d

    @property
    def s(self) -> int:
        return self.cfg.s

    @property
    def seed(self) -> int:
        return self.cfg.seed

    def memory_bytes(self) -> int:
        c = self.cfg
        return c.num_buckets * 4 + c.record_capacity * (c.d + 2) * 4 + 2 * c.pair_capacity * 8

    # ------------------------------------------------------------------
    def _bucket(self, values: torch.Tensor) -> torch.Tensor:
        """Avalanche hash of the chosen columns' values -> bucket id."""
        h = torch.full(values.shape[:-1], 0x811C9DC5 ^ (self.cfg.seed & _MASK32),
                       dtype=torch.int64, device=values.device)
        for c in self.cols:
            h = torch.bitwise_xor(mul_u32(h, 0x01000193),
                                  torch.bitwise_and(values[..., int(c)] + 0x9E3779B1, _MASK32))
        h = torch.bitwise_xor(h, h >> 15)
        h = mul_u32(h, 0x85EBCA77)
        h = torch.bitwise_xor(h, h >> 13)
        return torch.bitwise_and(h, self.cfg.num_buckets - 1).to(torch.int32)

    def init(self, sid: int = 0) -> LSHSSState:
        c, dev = self.cfg, self.device

        def full(shape, value, dtype=torch.int32):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return LSHSSState(
            counts=full((c.num_buckets,), 0),
            rec_items=full((c.record_capacity, c.d), 0, torch.int64),
            rec_bucket=full((c.record_capacity,), 0),
            rec_tags=full((c.record_capacity,), -1),
            same_sim=full((c.pair_capacity,), 0), same_tags=full((c.pair_capacity,), -1),
            same_seen=full((), 0),
            cross_sim=full((c.pair_capacity,), 0), cross_tags=full((c.pair_capacity,), -1),
            cross_seen=full((), 0),
            n=full((), 0), sid=full((), sid), step=full((), 0))

    def _ingest_one(self, state: LSHSSState, values, mask, keys) -> LSHSSState:
        """One round of S streams: values (S, B, d), mask (S, B), keys (S, 2)."""
        cfg = self.cfg
        device = values.device
        S, B = mask.shape
        mask = mask.to(torch.int64)
        maskb = mask != 0
        bucket = self._bucket(values)                                  # (S, B)
        counts = state.counts.scatter_add(1, torch.where(maskb, bucket, 0).to(torch.int64),
                                          maskb.to(torch.int32))

        kp, kq, ks, kc, kr = prng.split(keys, 5).unbind(dim=-2)
        # pair each arriving record with a uniform EARLIER record: a rank u in
        # [0, g); ranks inside this round resolve to the in-batch record,
        # earlier ranks to a reservoir slot
        n = state.n.to(torch.int64)[:, None]
        pos = torch.cumsum(mask, dim=1) - 1                            # candidate index
        gidx = n + pos                                                 # global arrival
        u = prng.randint(kp, (B,), 0, torch.clamp_min(gidx, 1), device).to(torch.int64)
        within = maskb & (u >= n)
        # while the reservoir fills (n < R) rank u lives at slot u; once
        # full, every uniform slot is valid
        slot_draw = prng.randint(kq, (B,), 0, cfg.record_capacity, device).to(torch.int64)
        warmup = n < cfg.record_capacity
        slot = torch.where(warmup, torch.clamp(u, 0, cfg.record_capacity - 1), slot_draw)
        row_of = torch.zeros((S, B + 1), dtype=torch.int64, device=device)
        row_of.scatter_(1, torch.where(maskb, pos, B),
                        torch.arange(B, device=device).expand(S, B))
        in_row = torch.gather(row_of, 1, torch.clamp(u - n, 0, B))
        p_items = torch.where(within[..., None], _gather_rows(values, in_row),
                              _gather_rows(state.rec_items, slot))
        p_bucket = torch.where(within, torch.gather(bucket, 1, in_row),
                               torch.gather(state.rec_bucket, 1, slot))
        p_ok = (gidx > 0) & (within | (torch.gather(state.rec_tags, 1, slot) >= 0))
        p_sim = (values == p_items).sum(dim=-1, dtype=torch.int32)
        p_same = p_bucket == bucket
        sid = state.sid[:, None]

        def pair_reservoir(k, cand, sims, tags, seen):
            win, src, seen_new = reservoir_accept(k, seen, cand.to(torch.int32),
                                                  cfg.pair_capacity)
            return (torch.where(win, torch.gather(p_sim, 1, src), sims),
                    torch.where(win, sid, tags), seen_new)

        same_sim, same_tags, same_seen = pair_reservoir(
            ks, maskb & p_ok & p_same, state.same_sim, state.same_tags, state.same_seen)
        cross_sim, cross_tags, cross_seen = pair_reservoir(
            kc, maskb & p_ok & ~p_same, state.cross_sim, state.cross_tags, state.cross_seen)

        win, src, n_new = reservoir_accept(kr, state.n, mask, cfg.record_capacity)
        return LSHSSState(
            counts=counts,
            rec_items=torch.where(win[..., None], _gather_rows(values, src), state.rec_items),
            rec_bucket=torch.where(win, torch.gather(bucket, 1, src), state.rec_bucket),
            rec_tags=torch.where(win, sid, state.rec_tags),
            same_sim=same_sim, same_tags=same_tags, same_seen=same_seen,
            cross_sim=cross_sim, cross_tags=cross_tags, cross_seen=cross_seen,
            n=n_new, sid=state.sid,
            # rounds that carried data only: padding rounds leave the state as it was
            step=state.step + (mask.sum(dim=1) > 0).to(torch.int32))

    def ingest_rounds(self, states, values, row_mask, keys):
        device = states.counts.device
        return scan_rounds(self._ingest_one, states, as_field_tensor(values, device),
                           torch.as_tensor(row_mask).to(device=device, dtype=torch.int32),
                           torch.as_tensor(keys, dtype=torch.int64).to(device))

    # -- algebra -------------------------------------------------------
    def _merge_sample(self, items_a, tags_a, n_a, items_b, tags_b, n_b, capacity):
        return merge_tagged_samples(items_a, tags_a, n_a, items_b, tags_b, n_b, capacity,
                                    _MERGE_SALT ^ self.cfg.seed)

    def refill_capacity(self, backing: int) -> tuple[int, int]:
        """(record, pair) fold capacities with ``backing`` half-capacity
        backing epochs."""
        c = self.cfg
        return (c.record_capacity + backing * (c.record_capacity // 2),
                c.pair_capacity + backing * (c.pair_capacity // 2))

    def merge(self, a: LSHSSState, b: LSHSSState, *, backing: int = 0) -> LSHSSState:
        """Weighted union of the samples, sum of the bucket counts (single
        states or stacks)."""
        d = self.cfg.d
        rec_cap, pair_cap = self.refill_capacity(backing)
        # the record reservoir carries each record's bucket id as an extra column
        rec, rec_tags = self._merge_sample(
            torch.cat([a.rec_items, a.rec_bucket.to(torch.int64)[..., None]], dim=-1),
            a.rec_tags, a.n,
            torch.cat([b.rec_items, b.rec_bucket.to(torch.int64)[..., None]], dim=-1),
            b.rec_tags, b.n, rec_cap)
        same, same_tags = self._merge_sample(
            a.same_sim.to(torch.int64)[..., None], a.same_tags, a.same_seen,
            b.same_sim.to(torch.int64)[..., None], b.same_tags, b.same_seen, pair_cap)
        cross, cross_tags = self._merge_sample(
            a.cross_sim.to(torch.int64)[..., None], a.cross_tags, a.cross_seen,
            b.cross_sim.to(torch.int64)[..., None], b.cross_tags, b.cross_seen, pair_cap)
        return LSHSSState(
            counts=a.counts + b.counts,
            rec_items=rec[..., :d], rec_bucket=rec[..., d].to(torch.int32),
            rec_tags=rec_tags,
            same_sim=same[..., 0].to(torch.int32), same_tags=same_tags,
            same_seen=a.same_seen + b.same_seen,
            cross_sim=cross[..., 0].to(torch.int32), cross_tags=cross_tags,
            cross_seen=a.cross_seen + b.cross_seen,
            n=a.n + b.n, sid=torch.maximum(a.sid, b.sid), step=a.step + b.step)

    def subtract(self, a: LSHSSState, b: LSHSSState) -> LSHSSState:
        drop = b.sid.unsqueeze(-1)

        def untag(tags):
            return torch.where(tags == drop, -1, tags)

        return LSHSSState(
            counts=a.counts - b.counts,
            rec_items=a.rec_items, rec_bucket=a.rec_bucket, rec_tags=untag(a.rec_tags),
            same_sim=a.same_sim, same_tags=untag(a.same_tags),
            same_seen=torch.clamp_min(a.same_seen - b.same_seen, 0),
            cross_sim=a.cross_sim, cross_tags=untag(a.cross_tags),
            cross_seen=torch.clamp_min(a.cross_seen - b.cross_seen, 0),
            n=torch.clamp_min(a.n - b.n, 0), sid=a.sid, step=a.step)

    # -- estimation ----------------------------------------------------
    def _stderr(self, same_sim, same_tags, same_seen, cross_sim, cross_tags, cross_seen,
                same_pairs, cross_pairs, n, step):
        """(N, L) stratified-bootstrap stderr, or zeros when disabled."""
        if not self.bootstrap:
            return np.zeros((np.asarray(n).shape[0], self.num_levels))
        return uncertainty.stratified_bootstrap_stderr(
            same_sim, same_tags >= 0, same_seen, cross_sim, cross_tags >= 0, cross_seen,
            same_pairs, cross_pairs, d=self.d, s=self.s, seed=self.cfg.seed, n=n, step=step,
            replicates=self.bootstrap)

    def _table(self, counts, same_sim, same_tags, same_seen, cross_sim, cross_tags,
               cross_seen, n, step) -> EstimateTable:
        """Host numpy: stratum totals from the bucket counts, per-stratum
        level fractions from the pair reservoirs (§2.3)."""
        counts = counts.astype(np.float64)
        same_pairs = (counts * (counts - 1)).sum(axis=-1)       # ordered
        total = n * (n - 1)
        cross_pairs = np.maximum(total - same_pairs, 0.0)
        levels = np.arange(self.d + 1)

        def level_fracs(sim, tags):
            ok = tags >= 0
            m = ok.sum(axis=-1).astype(np.float64)
            hits = ((sim[..., None] == levels) & ok[..., None]).sum(axis=-2).astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(m[:, None] > 0, hits / m[:, None], 0.0), hits

        f1, y1 = level_fracs(same_sim, same_tags)
        f2, _ = level_fracs(cross_sim, cross_tags)
        x_full = f1 * same_pairs[:, None] + f2 * cross_pairs[:, None]
        x = x_full[:, self.s:]
        g = np.cumsum(x[:, ::-1], axis=1)[:, ::-1] + n[:, None]
        stderr = self._stderr(same_sim, same_tags, same_seen, cross_sim, cross_tags,
                              cross_seen, same_pairs, cross_pairs, n, step)
        return EstimateTable(x=x, g=g, y=y1[:, self.s:], n=n, stderr=stderr,
                             stderr_offline=stderr,
                             stderr_kind="bootstrap_stratified" if self.bootstrap else "none")

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        del clamp, impl                            # host numpy, no kernel
        get = lambda t: t.cpu().numpy()            # noqa: E731
        return self._table(get(states.counts), get(states.same_sim), get(states.same_tags),
                           get(states.same_seen), get(states.cross_sim),
                           get(states.cross_tags), get(states.cross_seen),
                           get(states.n).astype(np.float64), get(states.step))

    def estimate_ref(self, state: LSHSSState, *, clamp: bool = True) -> EstimateTable:
        """Scalar python-loop oracle of the batched numpy path (the stderr
        reuses the stratified bootstrap, whose per-stream rng makes
        batch == ref by construction)."""
        del clamp
        get = lambda t: t.cpu().numpy()            # noqa: E731
        counts = get(state.counts).astype(np.int64)
        n = float(get(state.n))
        same_pairs = float((counts * (counts - 1)).sum())
        cross_pairs = max(n * (n - 1) - same_pairs, 0.0)
        x = np.zeros(self.d + 1)
        y = np.zeros(self.d + 1)
        for sim, tags, pairs, record_y in (
                (get(state.same_sim), get(state.same_tags), same_pairs, True),
                (get(state.cross_sim), get(state.cross_tags), cross_pairs, False)):
            ok = tags >= 0
            m = int(ok.sum())
            for k in range(self.d + 1):
                hits = int(((sim == k) & ok).sum())
                if record_y:
                    y[k] = hits
                if m > 0:
                    x[k] += hits / m * pairs
        xs = x[self.s:]
        g = np.array([xs[i:].sum() + n for i in range(self.num_levels)])
        stderr = self._stderr(
            get(state.same_sim)[None], get(state.same_tags)[None], get(state.same_seen)[None],
            get(state.cross_sim)[None], get(state.cross_tags)[None],
            get(state.cross_seen)[None], np.array([same_pairs]), np.array([cross_pairs]),
            np.array([n]), get(state.step)[None])
        return EstimateTable(x=xs[None], g=g[None], y=y[self.s:][None], n=np.array([n]),
                             stderr=stderr, stderr_offline=stderr,
                             stderr_kind="bootstrap_stratified" if self.bootstrap else "none")


def derive_config(sjpc_cfg, *, num_hash_cols: int = 1) -> LSHSSConfig:
    """Split the group's SJPC byte budget across the three structures:
    about half to the record reservoir, a quarter to the pair reservoirs,
    the rest to bucket counters (at most 1024 buckets)."""
    budget = sjpc_cfg.counters_bytes
    d = sjpc_cfg.d
    num_buckets = 1024
    while num_buckets * 4 > max(budget // 4, 64):
        num_buckets //= 2
    record_capacity = max(1, (budget // 2) // ((d + 2) * 4))
    pair_capacity = max(1, (budget // 4) // (2 * 8))
    return LSHSSConfig(d=d, s=sjpc_cfg.s, num_hash_cols=num_hash_cols,
                       num_buckets=max(num_buckets, 16), record_capacity=record_capacity,
                       pair_capacity=pair_capacity, seed=sjpc_cfg.seed)


def _factory(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    del params                # no shared hash randomness
    if estimator_cfg is None:
        estimator_cfg = derive_config(sjpc_cfg)
    return LSHSSEstimator(estimator_cfg, device=device, **(dict(opts) if opts else {}))


register("lsh_ss", _factory, state_cls=LSHSSState, linear=False, join_capable=False,
         stderr_kind="bootstrap_stratified", exact_oracle=pairwise_exact_oracle)
