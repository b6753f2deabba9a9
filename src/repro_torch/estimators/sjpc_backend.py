"""SJPC behind the Estimator protocol: a thin adapter over
:mod:`..core.sjpc`, ported from the JAX package's
``estimators/sjpc_backend.py``.

Nothing numerical lives here: ingest is ``service.ingest
.multi_round_update`` (the ``fused_ingest`` kernel on the card, or with
``use_fused=False`` the ``fingerprint`` and ``sketch_update`` kernels),
queries are ``sjpc.estimate_batch`` (the ``fused_query`` kernel) with the
Theorem 1/2 bounds.
"""
from __future__ import annotations

import numpy as np

from .. import platform
from ..core import sjpc
from ..core.sjpc import SJPCConfig, SJPCParams, SJPCState
from .base import EstimateTable, Estimator, pairwise_exact_oracle, register


class SJPCEstimator(Estimator):
    """The paper's estimator (Algorithm 1): linear (merge/subtract are
    exact counter arithmetic), joinable (§6), with analytical bounds."""

    kind = "sjpc"
    linear = True
    supports_join = True

    def __init__(self, cfg: SJPCConfig, params: SJPCParams | None = None, *,
                 use_fused: bool = True, impl: str | None = None, shards: int = 1,
                 device=None):
        self.cfg = cfg
        self.device = platform.resolve(device)
        self.params = params if params is not None else sjpc.init(cfg, device=self.device)[0]
        self.use_fused = use_fused
        self.impl = impl
        self.shards = shards

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
        return self.cfg.counters_bytes

    # -- protocol ------------------------------------------------------
    def init(self, sid: int = 0) -> SJPCState:
        del sid                      # linear subtract needs no provenance
        return sjpc.init(self.cfg, device=self.device)[1]

    def ingest_rounds(self, states, values, row_mask, keys):
        from ..service.ingest import multi_round_update
        counters, n, steps = multi_round_update(
            self.cfg, self.params, states.counters, states.n, states.step, values, row_mask,
            keys, impl=self.impl, use_fused=self.use_fused, shards=self.shards)
        return SJPCState(counters=counters, n=n, step=steps)

    def merge(self, a: SJPCState, b: SJPCState) -> SJPCState:
        return sjpc.merge(a, b)

    def subtract(self, a: SJPCState, b: SJPCState) -> SJPCState:
        return sjpc.subtract(a, b)

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        be = sjpc.estimate_batch(self.cfg, states.counters, states.n, clamp=clamp,
                                 impl=self.impl if impl is None else impl)
        return EstimateTable(*be, stderr_kind="analytic")

    def estimate_ref(self, state: SJPCState, *, clamp: bool = True) -> EstimateTable:
        """The per-stream oracle: int64-exact F2, float64 inversion, scalar
        Theorem 1/2 bounds."""
        cfg = self.cfg
        y = sjpc.level_f2(state)
        n = self.state_n(state)
        x = sjpc.f2_to_pair_count(cfg.d, cfg.s, n, cfg.ratio, y, clamp=clamp)
        L = cfg.num_levels
        g = np.array([x[i:].sum() + n for i in range(L)], np.float64)
        on = np.zeros(L)
        off = np.zeros(L)
        for i, s in enumerate(self.thresholds):
            if g[i] > 0:
                off[i] = np.sqrt(sjpc.offline_variance_bound(cfg.d, s, cfg.ratio, g[i])) * g[i]
                on[i] = np.sqrt(sjpc.online_variance_bound(
                    cfg.d, s, cfg.ratio, cfg.width, n, g[i])) * g[i]
        return EstimateTable(x=x[None], g=g[None], y=np.asarray(y)[None], n=np.array([n]),
                             stderr=on[None], stderr_offline=off[None], stderr_kind="analytic")

    # -- join (SJPC only) ----------------------------------------------
    def estimate_join_batch(self, states_a, states_b, *, clamp: bool = True,
                            impl: str | None = None) -> EstimateTable:
        be = sjpc.estimate_join_batch(self.cfg, states_a.counters, states_b.counters,
                                      states_a.n, states_b.n, clamp=clamp,
                                      impl=self.impl if impl is None else impl)
        return EstimateTable(*be, stderr_kind="analytic")

    def estimate_join_ref(self, state_a, state_b, *, clamp: bool = True) -> EstimateTable:
        """Per-pair oracle: int64-exact inner products, float64 inversion,
        and the self-join bound at n = max(n_a, n_b), g = max(estimate, 1)."""
        cfg = self.cfg
        y = sjpc.join_level_inner(state_a, state_b)
        x = sjpc.inner_to_join_count(cfg.d, cfg.s, cfg.ratio, y, clamp=clamp)
        L = cfg.num_levels
        g = np.array([x[i:].sum() for i in range(L)], np.float64)
        n_a, n_b = self.state_n(state_a), self.state_n(state_b)
        n = max(n_a, n_b)
        on = np.zeros(L)
        off = np.zeros(L)
        for i, s in enumerate(self.thresholds):
            gp = max(g[i], 1.0)
            off[i] = np.sqrt(sjpc.offline_variance_bound(cfg.d, s, cfg.ratio, gp)) * gp
            on[i] = np.sqrt(sjpc.online_variance_bound(cfg.d, s, cfg.ratio, cfg.width, n,
                                                       gp)) * gp
        return EstimateTable(x=x[None], g=g[None], y=np.asarray(y)[None],
                             n=np.array([[n_a, n_b]]), stderr=on[None],
                             stderr_offline=off[None], stderr_kind="analytic")


def _factory(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    # SJPC has no config of its own (it IS the group's SJPCConfig); both
    # channels carry construction keywords, estimator_cfg winning
    kwargs = {**(dict(opts) if opts else {}), **(dict(estimator_cfg) if estimator_cfg else {})}
    return SJPCEstimator(sjpc_cfg, params, device=device, **kwargs)


register("sjpc", _factory, state_cls=SJPCState, linear=True, join_capable=True,
         stderr_kind="analytic", exact_oracle=pairwise_exact_oracle)
