"""A Pagh-Sivertsen-style inner-product filter estimator as a PLUGIN kind
of the PyTorch port: ``examples/plugins/inner_product.py`` on tensors.

A linear, join-capable kind ("ipf") registered from outside
``src/repro_torch``: it rides the delta-ring window, the merge wire path,
the fused join planner and the accuracy auditor through its
``EstimatorSpec`` alone.

For every threshold level k the sketch keeps one CountSketch row of width
W, partitioned into C(d, k) disjoint regions, one per size-k attribute
subset.  A record hashes each of its C(d, k) subset projections into that
subset's own region with a +/-1 sign, so the row's second moment has

    E[y_k] = n * C(d, k) + sum_{j >= k} C(j, k) * x_j,

the paper's Eq. 4 moment system at sampling ratio r = 1: the estimator
reuses the port's ``sjpc.f2_to_pair_count`` (self-join) and
``sjpc.inner_to_join_count`` (Eq. 7 join).  States are int32 counter
planes, so merge and subtract are exact counter arithmetic.  The hashes
are the JAX package's uint32 arithmetic, carried in int64.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import platform
from repro_torch.core import sjpc
from repro_torch.core.hashing import as_field_tensor
from repro_torch.core.prng import mul_u32
from repro_torch.estimators import (EstimateTable, Estimator, pairwise_exact_oracle,
                                    register, scan_rounds, stack_states)


@dataclasses.dataclass(frozen=True)
class IPFConfig:
    """Static sketch shape: one (num_levels, row_width) counter plane.
    Frozen and hashable on purpose: the instance's config is the planner's
    fusion-signature key (see ``_fusion_key``)."""
    d: int
    s: int
    row_width: int
    seed: int

    @property
    def num_levels(self) -> int:
        return self.d - self.s + 1


class IPFState(NamedTuple):
    """One stream's sketch: the counter plane and the record count.  The
    counter leaf is named ``counters`` like SJPC's, so generic linear
    checks apply unchanged."""
    counters: torch.Tensor   # (L, W) int32
    n: torch.Tensor          # ()  int32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = torch.bitwise_xor(h, h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = torch.bitwise_xor(h, h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return torch.bitwise_xor(h, h >> 16)


class IPFEstimator(Estimator):
    kind = "ipf"
    linear = True
    supports_join = True

    def __init__(self, cfg: IPFConfig, *, device=None):
        self.cfg = cfg
        self.device = platform.resolve(device)
        W = cfg.row_width
        # per-level constants: subset index arrays, region strides,
        # per-subset hash salts
        self._subsets, self._strides, self._salts = [], [], []
        for k in self.thresholds:
            subs = np.array(list(itertools.combinations(range(cfg.d), k)),
                            dtype=np.int64).reshape(-1, k)
            stride = W // subs.shape[0]
            if stride < 1:
                raise ValueError(f"ipf row_width {W} cannot partition into "
                                 f"C({cfg.d},{k}) = {subs.shape[0]} subset regions")
            base_salt = (cfg.seed * 2654435761 ^ (k << 16)) & 0xFFFFFFFF
            salts = (np.uint32(base_salt)
                     ^ (np.arange(subs.shape[0]).astype(np.uint64)
                        * 0x85EBCA6B & 0xFFFFFFFF).astype(np.uint32))
            self._subsets.append(torch.from_numpy(subs).to(self.device))
            self._strides.append(stride)
            self._salts.append(torch.from_numpy(salts.astype(np.int64)).to(self.device))

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
    def init(self, sid: int = 0) -> IPFState:
        del sid                                    # linear: no provenance
        return IPFState(
            counters=torch.zeros((self.num_levels, self.cfg.row_width), dtype=torch.int32,
                                 device=self.device),
            n=torch.zeros((), dtype=torch.int32, device=self.device))

    def _ingest_one(self, states: IPFState, values, mask, keys) -> IPFState:
        """One round of S streams: values (S, B, d), mask (S, B).  Writes a
        new counter stack; the input states stay as they were."""
        del keys                                   # hash-based, PRNG-free
        S = values.shape[0]
        counters = states.counters.clone()        # (S, L, W)
        madd = mask.to(torch.int32)               # (S, B)
        for li, (subs, stride, salts) in enumerate(
                zip(self._subsets, self._strides, self._salts)):
            sub = values[:, :, subs]              # (S, B, C, k)
            h = salts.expand(sub.shape[:3])
            for t in range(sub.shape[-1]):
                h = mul_u32(torch.bitwise_xor(h, sub[..., t]), 0x9E3779B1)
            h = _fmix(h)
            sign = 1 - 2 * (h >> 31)                                   # (S, B, C)
            base = torch.arange(subs.shape[0], dtype=torch.int64, device=h.device) * stride
            bucket = base + h % stride
            contrib = (sign * madd[..., None]).to(torch.int32)
            counters[:, li].scatter_add_(1, bucket.reshape(S, -1), contrib.reshape(S, -1))
        return IPFState(counters=counters, n=states.n + madd.sum(dim=-1).to(torch.int32))

    def ingest_rounds(self, states, values, row_mask, keys):
        device = states.counters.device
        return scan_rounds(self._ingest_one, states, as_field_tensor(values, device),
                           torch.as_tensor(row_mask).to(device=device, dtype=torch.int32),
                           keys)

    def merge(self, a: IPFState, b: IPFState) -> IPFState:
        return IPFState(counters=a.counters + b.counters, n=a.n + b.n)

    def subtract(self, a: IPFState, b: IPFState) -> IPFState:
        # exact counter arithmetic, deliberately unclamped: the window's
        # delta-ring expiry relies on subtract being merge's true inverse
        return IPFState(counters=a.counters - b.counters, n=a.n - b.n)

    def memory_bytes(self) -> int:
        return self.num_levels * self.cfg.row_width * 4

    # -- estimation ----------------------------------------------------
    @staticmethod
    def _host(states):
        return (states.counters.cpu().numpy().astype(np.float64),      # (N, L, W)
                states.n.cpu().numpy().astype(np.float64))

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        del impl                                   # host-numpy estimator
        counters, n = self._host(states)
        y = (counters ** 2).sum(axis=2)            # (N, L) second moments
        N, L = y.shape
        x = np.zeros((N, L))
        for i in range(N):
            x[i] = sjpc.f2_to_pair_count(self.d, self.s, n[i], 1.0, y[i], clamp=clamp)
        g = np.cumsum(x[:, ::-1], axis=1)[:, ::-1] + n[:, None]
        zeros = np.zeros_like(x)
        return EstimateTable(x=x, g=g, y=y, n=n, stderr=zeros, stderr_offline=zeros,
                             stderr_kind="none")

    def estimate_ref(self, state, *, clamp: bool = True) -> EstimateTable:
        return self.estimate_batch(stack_states([state]), clamp=clamp)

    def estimate_join_batch(self, states_a, states_b, *, clamp: bool = True,
                            impl: str | None = None) -> EstimateTable:
        del impl
        ca, n_a = self._host(states_a)
        cb, n_b = self._host(states_b)
        y = (ca * cb).sum(axis=2)                  # (N, L) inner products
        N, L = y.shape
        x = np.zeros((N, L))
        for i in range(N):
            x[i] = sjpc.inner_to_join_count(self.d, self.s, 1.0, y[i], clamp=clamp)
        g = np.cumsum(x[:, ::-1], axis=1)[:, ::-1]  # join g: pairs only
        zeros = np.zeros_like(x)
        return EstimateTable(x=x, g=g, y=y, n=np.stack([n_a, n_b], axis=1), stderr=zeros,
                             stderr_offline=zeros, stderr_kind="none")

    def estimate_join_ref(self, state_a, state_b, *, clamp: bool = True) -> EstimateTable:
        return self.estimate_join_batch(stack_states([state_a]), stack_states([state_b]),
                                        clamp=clamp)


def _fusion_key(est: IPFEstimator):
    """Planner fusion signature: the same frozen config gives the same
    state shapes, so the cohorts fuse (the spec's ``fusion`` hook)."""
    return est.cfg


def _factory(cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    """Equal-space factory: the group's counter budget (L * depth * width
    int32 cells) spread over L partitioned rows of W = depth * width
    cells, so memory_bytes == cfg.counters_bytes."""
    del params
    opts = opts or {}
    row_width = int(opts.get("row_width", cfg.width * cfg.depth))
    ipf_cfg = estimator_cfg or IPFConfig(d=cfg.d, s=cfg.s, row_width=row_width,
                                         seed=cfg.seed ^ 0x1BF0)
    return IPFEstimator(ipf_cfg, device=device)


register("ipf", _factory, state_cls=IPFState,
         linear=True, join_capable=True, stderr_kind="none",
         fusion=_fusion_key, exact_oracle=pairwise_exact_oracle)
