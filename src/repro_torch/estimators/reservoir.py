"""Streaming uniform record sampling behind the Estimator protocol, ported
from the JAX package's ``estimators/reservoir.py``.

The paper's one-pass competitor (§2.1, Fig. 8): keep R records chosen
uniformly without replacement from the stream (Vitter's Algorithm R), and
estimate x[k] as the sample's all-pairs similarity histogram scaled by
n(n-1)/(m(m-1)).  The query is one ``fused_pairs`` launch over the stacked
samples (the CUDA kernel on the card), and so are its bootstrap error bars.

Vectorized Algorithm R: the record with global arrival index g is accepted
with probability min(1, R/(g+1)) into a uniform random slot; per slot the
latest accepted candidate of a batch wins (a scatter-max over arrival
order), which is exactly sequential processing.  One round of all S
streams is one call (:meth:`ReservoirEstimator._ingest_one`): the states
carry a leading stream axis.

Epoch algebra: inserted items are tagged with the state's ``sid``;
``merge`` is the deterministic weighted union of
:func:`.base.merge_tagged_samples`, ``subtract(a, b)`` drops a's items
tagged with b's sid.

Storage: items are uint32 record values held as int64 (the port's rule
for uint32 data); ``n`` is int32, exact to 2^31 as Algorithm R needs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import platform
from ..core import exact, prng
from ..core.hashing import as_field_tensor
from . import uncertainty
from .base import (EstimateTable, Estimator, merge_tagged_samples, pairwise_exact_oracle,
                   register, scan_rounds)

_MERGE_SALT = 0x7E5E4B01


@dataclasses.dataclass(frozen=True)
class ReservoirConfig:
    d: int                   # record dimensionality
    s: int                   # lowest queryable threshold
    capacity: int            # reservoir slots R
    seed: int = 0x5A5A

    def __post_init__(self):
        assert 1 <= self.s <= self.d, "need 1 <= s <= d"
        assert self.capacity >= 1, "reservoir needs at least one slot"


class ReservoirState(NamedTuple):
    items: torch.Tensor      # (R, d) int64: uint32 stored records
    tags: torch.Tensor       # (R,) int32 provenance sid; -1 = empty slot
    n: torch.Tensor          # int32 records seen (exact arrival index)
    sid: torch.Tensor        # int32 provenance tag for new insertions
    step: torch.Tensor       # int32 rounds that carried data


def reservoir_accept(keys: torch.Tensor, n0: torch.Tensor, mask: torch.Tensor, capacity: int):
    """One batch of vectorized Algorithm R for S streams at once.

    keys (S, 2); n0 (S,) int32 stream counts before the batch; mask (S, B)
    marks candidate rows.  Returns (win (S, R) bool, src (S, R) int64
    batch row feeding each winning slot, n_new (S,) int32): per slot the
    latest accepted candidate wins.  Shared by the record reservoir and
    the stratified pair reservoirs of LSH-SS.
    """
    S, B = mask.shape
    device = mask.device
    mask = mask.to(torch.int64)
    maskb = mask != 0
    pos = torch.cumsum(mask, dim=1) - 1                    # index among candidates
    gidx = n0.to(torch.int64)[:, None] + pos               # global arrival index
    ku, ks = prng.split(keys).unbind(dim=-2)
    # accept w.p. capacity/(gidx+1), decided on integers: a uniform arrival
    # rank in [0, gidx], accepted iff it is below capacity
    rank = prng.randint(ku, (B,), 0, torch.clamp_min(gidx + 1, 1), device)
    rand_slot = prng.randint(ks, (B,), 0, capacity, device)
    accept = maskb & ((gidx < capacity) | (rank < capacity))
    slot = torch.where(gidx < capacity, torch.clamp(gidx, 0, capacity - 1),
                       rand_slot.to(torch.int64))
    order = torch.where(accept, pos, -1)
    best = torch.full((S, capacity), -1, dtype=torch.int64, device=device)
    best.scatter_reduce_(1, slot, order, "amax", include_self=True)
    # candidate index -> batch row (masked-out rows scatter into the spare
    # B-th slot, which is never read)
    row_of = torch.zeros((S, B + 1), dtype=torch.int64, device=device)
    row_of.scatter_(1, torch.where(maskb, pos, B),
                    torch.arange(B, device=device).expand(S, B))
    win = best >= 0
    src = torch.gather(row_of, 1, torch.clamp(best, 0, B))
    return win, src, (n0 + mask.sum(dim=1)).to(torch.int32)


class ReservoirEstimator(Estimator):
    kind = "reservoir"
    linear = False
    supports_join = False

    def __init__(self, cfg: ReservoirConfig, *, impl: str | None = None,
                 bootstrap_replicates: int = uncertainty.DEFAULT_REPLICATES,
                 bootstrap_item_cap: int = uncertainty.DEFAULT_ITEM_CAP, device=None):
        self.cfg = cfg
        self.impl = impl
        self.device = platform.resolve(device)
        if bootstrap_replicates == 1:
            raise ValueError("bootstrap_replicates must be 0 (disabled) "
                             "or >= 2 (a std needs two replicates)")
        # a capacity-1 reservoir never holds a pair: no bars rather than zero bars
        self.bootstrap = int(bootstrap_replicates) if cfg.capacity >= 2 else 0
        self.bootstrap_cap = int(bootstrap_item_cap)

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
        # items + tags at 4 bytes each; n/sid/step are O(1) scalars
        return self.cfg.capacity * (self.cfg.d + 1) * 4

    # -- protocol ------------------------------------------------------
    def init(self, sid: int = 0) -> ReservoirState:
        R, d, dev = self.cfg.capacity, self.cfg.d, self.device
        return ReservoirState(
            items=torch.zeros((R, d), dtype=torch.int64, device=dev),
            tags=torch.full((R,), -1, dtype=torch.int32, device=dev),
            n=torch.zeros((), dtype=torch.int32, device=dev),
            sid=torch.tensor(sid, dtype=torch.int32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev))

    def _ingest_one(self, states: ReservoirState, values, mask, keys) -> ReservoirState:
        """One round of S streams: values (S, B, d), mask (S, B), keys (S, 2)."""
        win, src, n_new = reservoir_accept(keys, states.n, mask, self.cfg.capacity)
        taken = torch.gather(values, 1, src[..., None].expand(src.shape + (values.shape[-1],)))
        # step (the bootstrap key coordinate) counts rounds that carried data
        carried = (mask.sum(dim=1) > 0).to(torch.int32)
        return ReservoirState(
            items=torch.where(win[..., None], taken, states.items),
            tags=torch.where(win, states.sid[:, None], states.tags),
            n=n_new, sid=states.sid, step=states.step + carried)

    def ingest_rounds(self, states, values, row_mask, keys):
        device = states.items.device
        return scan_rounds(self._ingest_one, states, as_field_tensor(values, device),
                           torch.as_tensor(row_mask).to(device=device, dtype=torch.int32),
                           torch.as_tensor(keys, dtype=torch.int64).to(device))

    def refill_capacity(self, backing: int) -> int:
        """Fold capacity with ``backing`` half-capacity backing epochs."""
        return self.cfg.capacity + backing * (self.cfg.capacity // 2)

    def merge(self, a: ReservoirState, b: ReservoirState, *,
              backing: int = 0) -> ReservoirState:
        """Deterministic weighted union (single states or stacks)."""
        items, tags = merge_tagged_samples(a.items, a.tags, a.n, b.items, b.tags, b.n,
                                           self.refill_capacity(backing),
                                           _MERGE_SALT ^ self.cfg.seed)
        return ReservoirState(items=items, tags=tags, n=a.n + b.n,
                              sid=torch.maximum(a.sid, b.sid), step=a.step + b.step)

    def subtract(self, a: ReservoirState, b: ReservoirState) -> ReservoirState:
        keep = a.tags != b.sid.unsqueeze(-1)
        return ReservoirState(items=a.items, tags=torch.where(keep, a.tags, -1),
                              n=torch.clamp_min(a.n - b.n, 0), sid=a.sid, step=a.step)

    # -- estimation ----------------------------------------------------
    def _table(self, hist: np.ndarray, n: np.ndarray, m: np.ndarray,
               stderr: np.ndarray | None = None) -> EstimateTable:
        """hist (N, d+1) float64 sample pair counts -> the (N, L) table,
        scaled by n(n-1)/(m(m-1)) (m < 2 gives the zero histogram)."""
        x_full = hist * uncertainty.pair_scale(n, m)[:, None]
        x = x_full[:, self.s:]
        g = np.cumsum(x[:, ::-1], axis=1)[:, ::-1] + n[:, None]
        if stderr is None:
            stderr = np.zeros_like(x)
        # a pure sampling estimator: the online and offline bars coincide
        return EstimateTable(x=x, g=g, y=hist[:, self.s:], n=n, stderr=stderr,
                             stderr_offline=stderr,
                             stderr_kind="bootstrap" if self.bootstrap else "none")

    def _bootstrap_stderr(self, items, valid, n, step, *, impl,
                          pair_fn=None) -> np.ndarray | None:
        if not self.bootstrap:
            return None
        keys = uncertainty.bootstrap_key(self.cfg.seed, n, step)
        return uncertainty.bootstrap_pair_stderr(
            items, valid, np.asarray(n.cpu().numpy(), np.float64), keys=keys, s=self.s,
            replicates=self.bootstrap, item_cap=self.bootstrap_cap, impl=impl,
            pair_fn=pair_fn)

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        del clamp                                  # counts are >= 0 already
        from ..kernels.ops import fused_pairs
        impl = self.impl if impl is None else impl
        valid = (states.tags >= 0).to(torch.int32)
        hist = fused_pairs(states.items, valid, impl=impl).cpu().numpy().astype(np.float64)
        n = states.n.cpu().numpy().astype(np.float64)
        m = valid.sum(dim=1).cpu().numpy().astype(np.float64)
        stderr = self._bootstrap_stderr(states.items, valid, states.n, states.step, impl=impl)
        return self._table(hist, n, m, stderr)

    def estimate_ref(self, state: ReservoirState, *, clamp: bool = True) -> EstimateTable:
        """O(m^2 d) numpy oracle: the brute-force histogram of the valid
        sample, the same scaling, and bootstrap bars from the same
        replicate indices binned by the numpy oracle."""
        del clamp
        tags = state.tags.cpu().numpy()
        valid = (tags >= 0).astype(np.int32)
        items = state.items.cpu().numpy()
        hist = (exact.brute_force_pair_counts(items[tags >= 0])
                if items[tags >= 0].shape[0] else np.zeros(self.d + 1))
        n = np.array([self.state_n(state)], np.float64)

        def pair_fn(it, va):
            it, va = np.asarray(it.cpu()), np.asarray(va.cpu())
            lead = it.shape[:-2]
            flat_it = it.reshape((-1,) + it.shape[-2:])
            flat_va = va.reshape((-1, va.shape[-1]))
            out = np.stack([exact.brute_force_pair_counts(r[v != 0])
                            if (v != 0).sum() else np.zeros(self.d + 1)
                            for r, v in zip(flat_it, flat_va)])
            return out.reshape(lead + (self.d + 1,))

        stderr = self._bootstrap_stderr(
            state.items[None], torch.from_numpy(valid[None]).to(state.items.device),
            state.n[None], state.step[None], impl=None, pair_fn=pair_fn)
        return self._table(hist[None], n, np.array([float(valid.sum())], np.float64), stderr)


def capacity_for_bytes(sjpc_cfg) -> int:
    """The Fig. 8 equal-space rule: the records (plus provenance tag)
    storable in the byte budget of the group's SJPC counters."""
    return max(1, sjpc_cfg.counters_bytes // ((sjpc_cfg.d + 1) * 4))


def _factory(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    del params                               # no shared hash randomness
    if estimator_cfg is None:
        estimator_cfg = ReservoirConfig(d=sjpc_cfg.d, s=sjpc_cfg.s,
                                        capacity=capacity_for_bytes(sjpc_cfg),
                                        seed=sjpc_cfg.seed)
    return ReservoirEstimator(estimator_cfg, device=device, **(dict(opts) if opts else {}))


register("reservoir", _factory, state_cls=ReservoirState, linear=False,
         join_capable=False, stderr_kind="bootstrap", exact_oracle=pairwise_exact_oracle)
