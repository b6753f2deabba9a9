"""A KMV/theta bottom-K distinct-value sketch as a PLUGIN estimator kind of
the PyTorch port: ``examples/plugins/theta_sketch.py`` on tensors.

The kind ("theta_kmv") is registered from outside ``src/repro_torch``
through the port's one declarative ``EstimatorSpec`` surface; nothing in
its service, wire, planner or observability layers names it.

The sketch hashes every record to a uniform 32-bit key and keeps the K
smallest distinct (key, provenance-tag) entries, each with the number of
records behind it.  With ``theta`` = (K-th smallest retained key + 1) /
2^32 every distinct value survives independently with probability theta:

* distinct values  D-hat = (retained_distinct - 1) / theta  (full sketch)
* duplicate pairs  P-hat = sum_v c_v * (c_v - 1) / theta    (ordered)

A duplicate pair agrees on all d attributes, so the table reports x = 0
except at level d and the constant column g_k = n + P-hat.  Window
semantics are the sample-window algebra: states are not linear, merge is
the exact bottomK(A union B) = bottomK(bottomK(A) union bottomK(B)), and
subtract drops entries by provenance tag.  No exact-replay oracle is
registered: the accuracy auditor skips the kind with
``reason="no_exact_oracle"``.

The uint32 keys are carried as int64 in [0, 2^32), the port's rule for
uint32 data, so they go on the wire as ``<u4`` like the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import platform
from repro_torch.core.hashing import as_field_tensor
from repro_torch.core.prng import mul_u32
from repro_torch.estimators import (EstimateTable, Estimator, register, scan_rounds,
                                    stack_states)

_EMPTY_KEY = 0xFFFFFFFF       # slot sentinel; validity is tag >= 0
_NO_TAG = 0x7FFFFFFF          # sorts empty slots after every valid tag
_ENTRY_BYTES = 12             # key u32 + count i32 + tag i32


@dataclasses.dataclass(frozen=True)
class ThetaConfig:
    """Static plugin configuration, derived from the group's SJPCConfig
    by the factory (equal space: capacity = counters_bytes // 12)."""
    d: int
    s: int
    capacity: int
    seed: int


class ThetaState(NamedTuple):
    """One stream's sketch: K slots of (key, count, tag) entries; ``tag``
    is the provenance sid (-1 = empty slot), and empty slots hold the
    0xFFFFFFFF key so that a plain sort pushes them to the tail."""
    keys: torch.Tensor     # (K,) int64: uint32 keys
    counts: torch.Tensor   # (K,) int32 records retained behind each key
    tags: torch.Tensor     # (K,) int32 provenance sid, -1 = empty
    n: torch.Tensor        # ()  int32 records represented
    sid: torch.Tensor      # ()  int32 this state's provenance tag


def _hash_rows(values: torch.Tensor, seed: int) -> torch.Tensor:
    """(..., B, d) uint32 records (int64) -> (..., B) uniform 32-bit keys:
    a fold-multiply mix per attribute and a murmur3-style finalizer, in
    uint32 arithmetic carried in int64."""
    h = torch.full(values.shape[:-1], (seed ^ 0x0D15C0DE) & _EMPTY_KEY, dtype=torch.int64,
                   device=values.device)
    for c in range(values.shape[-1]):
        h = mul_u32(torch.bitwise_xor(h, values[..., c]), 0x9E3779B1)
    h = torch.bitwise_xor(h, h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = torch.bitwise_xor(h, h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return torch.bitwise_xor(h, h >> 16)


def _combine(keys, counts, tags, capacity: int):
    """bottomK of pooled entry lists (leading axes are streams): sort by
    (key, tag) with empties last, coalesce equal (key, tag) runs, keep the
    first ``capacity``.  Two stable argsorts make the lexicographic sort
    (secondary key first); empty slots sort by a +inf tag surrogate, so a
    valid entry whose key equals the sentinel still lands ahead of them.
    The runs' counts are summed by an integer ``index_add_``, exact."""
    tag_key = torch.where(tags >= 0, tags, _NO_TAG)
    order = torch.argsort(tag_key, dim=-1, stable=True)
    keys, counts, tag_key = (torch.gather(x, -1, order) for x in (keys, counts, tag_key))
    order = torch.argsort(keys, dim=-1, stable=True)
    keys, counts, tag_key = (torch.gather(x, -1, order) for x in (keys, counts, tag_key))

    m = keys.shape[-1]
    lead = keys.shape[:-1]
    first = torch.cat([torch.ones(lead + (1,), dtype=torch.bool, device=keys.device),
                       (keys[..., 1:] != keys[..., :-1]) | (tag_key[..., 1:] != tag_key[..., :-1])],
                      dim=-1)
    gid = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    rows = int(np.prod(lead, dtype=np.int64))
    flat = (gid.reshape(rows, m)
            + torch.arange(rows, device=keys.device)[:, None] * m).reshape(-1)
    out_counts = torch.zeros(rows * m, dtype=counts.dtype, device=keys.device).index_add_(
        0, flat, counts.reshape(-1)).reshape(lead + (m,))
    out_keys = torch.full_like(keys, _EMPTY_KEY).scatter_(-1, gid, keys)
    out_tags = torch.full_like(tag_key, -1).scatter_(
        -1, gid, torch.where(tag_key == _NO_TAG, -1, tag_key))
    out_counts = torch.where(out_tags >= 0, out_counts, 0)
    return out_keys[..., :capacity], out_counts[..., :capacity], out_tags[..., :capacity]


class ThetaEstimator(Estimator):
    kind = "theta_kmv"
    linear = False
    supports_join = False

    def __init__(self, cfg: ThetaConfig, *, device=None):
        self.cfg = cfg
        self.device = platform.resolve(device)

    @property
    def d(self) -> int:
        return self.cfg.d

    @property
    def s(self) -> int:
        return self.cfg.s

    @property
    def seed(self) -> int:
        return self.cfg.seed

    # -- state algebra -------------------------------------------------
    def init(self, sid: int = 0) -> ThetaState:
        K, dev = self.cfg.capacity, self.device
        return ThetaState(
            keys=torch.full((K,), _EMPTY_KEY, dtype=torch.int64, device=dev),
            counts=torch.zeros((K,), dtype=torch.int32, device=dev),
            tags=torch.full((K,), -1, dtype=torch.int32, device=dev),
            n=torch.zeros((), dtype=torch.int32, device=dev),
            sid=torch.tensor(sid, dtype=torch.int32, device=dev))

    def _ingest_one(self, states: ThetaState, values, mask, keys) -> ThetaState:
        """One round of S streams: values (S, B, d), mask (S, B)."""
        del keys                                  # hash-based, PRNG-free
        live = mask > 0
        row_keys = torch.where(live, _hash_rows(values, self.cfg.seed), _EMPTY_KEY)
        row_tags = torch.where(live, states.sid[..., None], -1).to(torch.int32)
        keys, counts, tags = _combine(
            torch.cat([states.keys, row_keys], dim=-1),
            torch.cat([states.counts, live.to(torch.int32)], dim=-1),
            torch.cat([states.tags, row_tags], dim=-1),
            self.cfg.capacity)
        return ThetaState(keys=keys, counts=counts, tags=tags,
                          n=states.n + mask.sum(dim=-1).to(torch.int32), sid=states.sid)

    def ingest_rounds(self, states, values, row_mask, keys):
        device = states.keys.device
        return scan_rounds(self._ingest_one, states, as_field_tensor(values, device),
                           torch.as_tensor(row_mask).to(device=device, dtype=torch.int32),
                           keys)

    def merge(self, a: ThetaState, b: ThetaState, *, backing: int = 0) -> ThetaState:
        """Exact union: bottomK over the pooled entries (single states or
        stacks).  ``backing`` is taken for the window refill's call; a KMV
        sketch keeps its K smallest keys whatever it is."""
        del backing
        keys, counts, tags = _combine(torch.cat([a.keys, b.keys], dim=-1),
                                      torch.cat([a.counts, b.counts], dim=-1),
                                      torch.cat([a.tags, b.tags], dim=-1), self.cfg.capacity)
        return ThetaState(keys=keys, counts=counts, tags=tags, n=a.n + b.n,
                          sid=torch.maximum(a.sid, b.sid))

    def subtract(self, a: ThetaState, b: ThetaState) -> ThetaState:
        drop = a.tags == b.sid[..., None]
        keys, counts, tags = _combine(torch.where(drop, _EMPTY_KEY, a.keys),
                                      torch.where(drop, 0, a.counts),
                                      torch.where(drop, -1, a.tags), self.cfg.capacity)
        return ThetaState(keys=keys, counts=counts, tags=tags,
                          n=torch.clamp_min(a.n - b.n, 0), sid=a.sid)

    def memory_bytes(self) -> int:
        return self.cfg.capacity * _ENTRY_BYTES

    # -- estimation ----------------------------------------------------
    def _row(self, keys: np.ndarray, counts: np.ndarray, tags: np.ndarray,
             n: float) -> tuple[float, float]:
        """One sketch -> (distinct-hat, ordered-duplicate-pairs-hat)."""
        valid = tags >= 0
        m = int(valid.sum())
        if m == 0 or n <= 0:
            return 0.0, 0.0
        ks = keys[valid].astype(np.uint64)
        cs = counts[valid].astype(np.float64)
        uniq, inv = np.unique(ks, return_inverse=True)
        per_key = np.zeros(uniq.shape[0])
        np.add.at(per_key, inv, cs)
        if m < self.cfg.capacity:
            theta, distinct = 1.0, float(uniq.size)       # exact regime
        else:
            theta = (float(ks.max()) + 1.0) / 4294967296.0
            distinct = max(float(uniq.size) - 1.0, 1.0) / theta
        dup = float((per_key * (per_key - 1.0)).sum()) / theta
        return distinct, dup

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        del impl                                  # host-numpy estimator
        keys = states.keys.cpu().numpy()
        counts = states.counts.cpu().numpy()
        tags = states.tags.cpu().numpy()
        n = states.n.cpu().numpy().astype(np.float64)
        N, L = n.shape[0], self.num_levels
        x = np.zeros((N, L))
        y = np.zeros((N, L))
        for i in range(N):
            distinct, dup = self._row(keys[i], counts[i], tags[i], n[i])
            x[i, L - 1] = dup                     # duplicates match at d
            y[i, :] = distinct                    # diagnostic: D-hat
        if clamp:
            x = np.maximum(x, 0.0)
        g = np.cumsum(x[:, ::-1], axis=1)[:, ::-1] + n[:, None]
        zeros = np.zeros_like(x)
        return EstimateTable(x=x, g=g, y=y, n=n, stderr=zeros, stderr_offline=zeros,
                             stderr_kind="none")

    def estimate_ref(self, state, *, clamp: bool = True) -> EstimateTable:
        return self.estimate_batch(stack_states([state]), clamp=clamp)


def _factory(cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    """Equal-space factory: the sketch budget comes from the group's
    SJPCConfig, 12 bytes per retained entry."""
    del params
    opts = opts or {}
    capacity = int(opts.get("capacity", max(int(cfg.counters_bytes) // _ENTRY_BYTES, 8)))
    theta_cfg = estimator_cfg or ThetaConfig(d=cfg.d, s=cfg.s, capacity=capacity,
                                             seed=cfg.seed ^ 0x7E7A)
    return ThetaEstimator(theta_cfg, device=device)


register("theta_kmv", _factory, state_cls=ThetaState,
         linear=False, join_capable=False, stderr_kind="none")
