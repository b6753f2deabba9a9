"""Query planner + admission control for the continuous-query path,
ported from the JAX package's ``service/planner.py``.

``service.poll`` batches device work per (group, estimator instance,
state-shape) cohort -- one ``estimate_batch`` per hash group.  At planner
scale (thousands of standing queries over dozens of groups) that still
means one launch per group per poll, and every tenant's query is equal.
The :class:`QueryPlanner` sits between ``poll()`` and the snapshot engine
and adds three things:

**Cross-group cohort fusion.**  Group cohorts whose *fusion
signature* matches -- same estimator kind, same derived estimator config
(which pins the counter geometry: levels, depth t, width w -- and the
seed), and same state leaf shapes -- stack along one stream axis into ONE
``estimate_batch`` launch; the result unstacks back into the per-group
cache entries the unfused path would have written.  All batched estimate
paths are row-independent (moments, depth medians, the Eq. 4 inversion are
per-stream reductions; bootstrap bars are position-independent by
construction), so fused results equal unfused results --
tests/test_torch_planner.py holds them within 1e-6 for every kind.

**Priority scheduling + admission control.**  Each
:class:`~repro_torch.service.query.ContinuousQuery` carries a ``priority`` class
(lower = more critical) and a ``tenant`` budget account (default: its
first stream).  Per tenant, a token bucket refills every poll; queries are
charged in priority order, and a tenant over budget is served its *last
fresh* result marked ``stale=True`` -- no new device work, no audit --
with ``admission_rejections_total{tenant}`` counting every throttled
serve.  A query that has never produced a result is admitted regardless
(there is nothing to serve stale).  Fused launches run in priority order:
a launch's priority is the most critical admitted query that needs it.

**Plan caching.**  The fusion plan -- signature -> member cohorts,
query -> cohort/pair wiring -- is a pure function of the registry topology
and the registered queries, so it is computed once and reused across polls
(``planner_plans_built_total`` / ``planner_plan_reuse_total``).  It is
invalidated by ``create_stream``/``create_group`` (the registry's topology
``version``), ``register_continuous`` (the service's query version), and
estimator-cfg changes (registration-time, hence covered); a per-poll
validation pass additionally rebuilds when any covered stream's state
shapes drift (backing-epoch refill widens sample windows mid-life).
"""
from __future__ import annotations

import dataclasses
import time

from .. import estimators
from ..obs import Observability

from .query import ContinuousQuery, QueryResult, Snapshot
from .registry import StreamRegistry


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    fuse_groups: bool = True         # cross-group cohort fusion
    tenant_budget: float | None = None   # default tokens refilled per poll
    #   per tenant (None = unlimited: admission control off unless a
    #   per-tenant budget is set)
    tenant_budgets: tuple = ()       # ((tenant, refill), ...) overrides
    tenant_burst: float | None = None    # bucket capacity (None = refill)
    coalesce_window: float = 0.0     # seconds: a cohort/pair whose
    #   launch completed within this window serves the SAME result to the
    #   next poll even if window versions moved -- back-to-back sub-second
    #   polls reuse the in-flight launch instead of recomputing.  0 = off
    #   (every version bump recomputes; the pre-coalescing behavior)


class _Bucket:
    """Per-tenant token bucket: ``refill`` tokens per poll, capped at
    ``burst``; one admitted query costs one token."""

    __slots__ = ("refill", "burst", "tokens")

    def __init__(self, refill: float, burst: float | None):
        self.refill = float(refill)
        self.burst = float(refill if burst is None else burst)
        self.tokens = self.burst         # start full: first poll is served

    def tick(self) -> None:
        self.tokens = min(self.tokens + self.refill, self.burst)

    def take(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class _Plan:
    key: tuple                       # (registry.version, queries_version)
    stream_sigs: dict                # name -> (id(estimator), shape_sig)
    self_launches: list              # [[cohort_key, ...], ...] one fused
    #   launch per inner list; cohort_key = (group_id, eid, shape_sig)
    query_cohort: dict               # query name -> cohort_key (self kinds)
    join_launches: list              # [[(a, b), ...], ...] fused join buckets
    query_pair: dict                 # query name -> (a, b) (join kind)


class QueryPlanner:
    def __init__(self, registry: StreamRegistry, cfg: PlannerConfig | None
                 = None, *, obs: Observability | None = None):
        self.registry = registry
        self.cfg = cfg or PlannerConfig()
        self.obs = obs if obs is not None else Observability.disabled()
        self._plan: _Plan | None = None
        self._queries_version = 0
        self._budgets: dict[str, float | None] = dict(
            self.cfg.tenant_budgets)
        self._buckets: dict[str, _Bucket] = {}
        self._last: dict[str, object] = {}   # query name -> last fresh result
        # launch coalescing: ("self", ck) / ("join", pair) -> the
        # (timestamp, cache key) of the last *fresh* launch.  Aliased
        # serves keep the original record, so a real launch happens at
        # least once per coalesce window
        self._coalesce: dict = {}
        self._now = time.monotonic           # injectable clock (tests)

    # -- registration-side invalidation --------------------------------
    def invalidate_queries(self) -> None:
        """Called by ``register_continuous``: the query set is part of the
        plan key (join pairs and needed cohorts change with it)."""
        self._queries_version += 1

    def set_tenant_budget(self, tenant: str, refill: float | None, *,
                          burst: float | None = None) -> None:
        """Set (or clear, with ``refill=None``) one tenant's per-poll query
        budget at runtime; takes effect at the next poll."""
        self._budgets[tenant] = refill
        self._buckets.pop(tenant, None)
        if refill is not None:
            self._buckets[tenant] = _Bucket(refill, burst
                                            if burst is not None
                                            else self.cfg.tenant_burst)

    # -- planning ------------------------------------------------------
    def _fusion_sig(self, view) -> tuple:
        """Cohorts fuse iff this matches: estimator kind, the derived
        config (geometry AND seed -- groups with equal SJPCConfig draw
        identical hash params, and sample kinds' bootstrap keys derive
        from the cfg seed), and the state leaf shapes.  Only the group's
        *cached* kind instance is eligible: its numerics are a pure
        function of the config, whereas an ``estimator_cfg``-overridden
        instance may carry construction kwargs the config cannot see, so
        it falls back to instance identity (fused only with itself)."""
        est = view.estimator
        group = self.registry.group(view.group_id)
        if group.cached_estimator(view.kind) is not est:
            cfg = id(est)
        else:
            # the kind's spec may contribute its own fusion key
            # (``EstimatorSpec.fusion``); the default is
            # the instance's derived config
            fusion = estimators.spec_of(est).fusion
            cfg = fusion(est) if fusion is not None \
                else getattr(est, "cfg", None)
            try:
                hash(cfg)
            except TypeError:
                cfg = id(est)
        return (view.kind, cfg, view.shape_sig)

    def _build_plan(self, snap: Snapshot,
                    queries: dict[str, ContinuousQuery]) -> _Plan:
        stream_sigs: dict = {}
        cohort_of: dict = {}         # cohort_key -> fusion sig
        query_cohort: dict = {}
        join_buckets: dict = {}      # fused-join sig -> [(a, b), ...]
        query_pair: dict = {}
        for name, q in queries.items():
            if q.kind == "join":
                a, b = q.streams
                self.registry.require_joinable(a, b)
                va, vb = snap._view(a), snap._view(b)
                for v in (va, vb):
                    stream_sigs[v.name] = (id(v.estimator), v.shape_sig)
                sig = ((self._fusion_sig(va), self._fusion_sig(vb))
                       if self.cfg.fuse_groups
                       else (va.group_id, id(va.estimator),
                             id(vb.estimator), va.shape_sig, vb.shape_sig))
                pair = (a, b)
                if pair not in query_pair.values():
                    join_buckets.setdefault(sig, []).append(pair)
                query_pair[name] = pair
            else:
                v = snap._view(q.streams[0])
                stream_sigs[v.name] = (id(v.estimator), v.shape_sig)
                ck = (v.group_id, id(v.estimator), v.shape_sig)
                cohort_of[ck] = (self._fusion_sig(v) if self.cfg.fuse_groups
                                 else ck)
                query_cohort[name] = ck
        by_sig: dict = {}
        for ck, sig in cohort_of.items():
            by_sig.setdefault(sig, []).append(ck)
        plan = _Plan(key=(self.registry.version, self._queries_version),
                     stream_sigs=stream_sigs,
                     self_launches=list(by_sig.values()),
                     query_cohort=query_cohort,
                     join_launches=[sorted(set(p))
                                    for p in join_buckets.values()],
                     query_pair=query_pair)
        m = self.obs.metrics
        if m.enabled:
            m.inc("planner_plans_built_total")
        return plan

    def _plan_for(self, snap: Snapshot,
                  queries: dict[str, ContinuousQuery]) -> _Plan:
        key = (self.registry.version, self._queries_version)
        plan = self._plan
        if plan is not None and plan.key == key:
            # shape drift (backing-epoch refill) changes cohort membership
            # without touching the topology version -- validate per poll
            for name, (eid, sig) in plan.stream_sigs.items():
                v = snap._views.get(name)
                if v is None or id(v.estimator) != eid or v.shape_sig != sig:
                    plan = None
                    break
        else:
            plan = None
        if plan is None:
            plan = self._build_plan(snap, queries)
            self._plan = plan
        elif self.obs.metrics.enabled:
            self.obs.metrics.inc("planner_plan_reuse_total")
        return plan

    # -- admission -----------------------------------------------------
    def _admit(self, queries: dict[str, ContinuousQuery]) -> set:
        """Charge each tenant's bucket in priority order; return the names
        throttled this poll (served stale)."""
        throttled: set = set()
        default = self.cfg.tenant_budget
        if default is None and not self._budgets:
            return throttled
        per_tenant: dict[str, list] = {}
        for idx, (name, q) in enumerate(queries.items()):
            per_tenant.setdefault(q.tenant_id, []).append((q.priority, idx,
                                                           name))
        m = self.obs.metrics
        for tenant, qs in per_tenant.items():
            refill = self._budgets.get(tenant, default)
            if refill is None:
                continue
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = _Bucket(
                    refill, self.cfg.tenant_burst)
            else:
                bucket.tick()
            if m.enabled:
                m.set("admission_tokens", bucket.tokens, tenant=tenant)
            for _, _, name in sorted(qs):
                if not bucket.take() and name in self._last:
                    # over budget AND a previous fresh result exists to
                    # serve; a never-served query is admitted regardless
                    throttled.add(name)
                    if m.enabled:
                        m.inc("admission_rejections_total", tenant=tenant)
        return throttled

    @staticmethod
    def _stale(result):
        if isinstance(result, QueryResult):
            return result._replace(stale=True)
        return {k: r._replace(stale=True) for k, r in result.items()}

    # -- launch coalescing ---------------------------------------------
    @staticmethod
    def _launch_key(snap: Snapshot, op: str, member) -> tuple:
        """The version-embedding cache key ``member`` resolves to in this
        snapshot (the key the fused launch would fill)."""
        if op == "self":
            return snap._self_key(snap._cohort_views(*member), True)
        a, b = member
        return ("join", a, snap._view(a).version,
                b, snap._view(b).version, True)

    def _apply_coalescing(self, snap: Snapshot, cohort_prio: dict,
                          pair_prio: dict) -> list:
        """Alias cache entries for launches whose previous fresh result is
        younger than the coalesce window: the new version key points at
        the last launch's entry, so the launch loop skips the cohort/pair
        entirely.  Returns the members that still need fresh launches (the
        records to stamp afterwards)."""
        win = self.cfg.coalesce_window
        m = self.obs.metrics
        fresh = []
        now = self._now() if win > 0.0 else 0.0
        for op, prio in (("self", cohort_prio), ("join", pair_prio)):
            for member in prio:
                key = self._launch_key(snap, op, member)
                if key in snap._cache:
                    continue
                rec = self._coalesce.get((op, member)) if win > 0.0 else None
                if (rec is not None and now - rec[0] <= win
                        and rec[1] in snap._cache and rec[1] != key):
                    # within the window: serve the in-flight result under
                    # the new version key (no device work; the entry ages
                    # out when the ORIGINAL launch leaves the window)
                    snap._cache[key] = snap._cache_get(rec[1])
                    if m.enabled:
                        m.inc("planner_coalesced_launches_total", op=op)
                else:
                    fresh.append((op, member, key))
        return fresh

    def _stamp_coalescing(self, fresh: list) -> None:
        if self.cfg.coalesce_window <= 0.0:
            return
        now = self._now()
        for op, member, key in fresh:
            self._coalesce[(op, member)] = (now, key)

    # -- the poll body -------------------------------------------------
    def poll(self, snap: Snapshot,
             queries: dict[str, ContinuousQuery]) -> dict:
        """Evaluate the standing queries against ``snap`` through the plan:
        admission first, then the fused launches (priority order, skipping
        work no admitted query needs), then per-query evaluation -- cache
        hits for admitted queries, last-fresh ``stale=True`` results for
        throttled ones."""
        throttled = self._admit(queries)
        plan = self._plan_for(snap, queries)
        m = self.obs.metrics
        if snap._use_fused:
            # priority of each cohort/pair = most critical admitted query
            # needing it; untouched launches are skipped entirely
            cohort_prio: dict = {}
            pair_prio: dict = {}
            for name, q in queries.items():
                if name in throttled:
                    continue
                if q.kind == "join":
                    pair = plan.query_pair[name]
                    pair_prio[pair] = min(pair_prio.get(pair, q.priority),
                                          q.priority)
                else:
                    ck = plan.query_cohort[name]
                    cohort_prio[ck] = min(cohort_prio.get(ck, q.priority),
                                          q.priority)
            fresh = self._apply_coalescing(snap, cohort_prio, pair_prio)
            launches = [(min(cohort_prio[ck] for ck in cks), "self", cks)
                        for cks in plan.self_launches
                        if any(ck in cohort_prio for ck in cks)]
            launches += [(min(pair_prio[p] for p in ps), "join", ps)
                         for ps in plan.join_launches
                         if any(p in pair_prio for p in ps)]
            launches.sort(key=lambda t: t[0])
            for _, op, members in launches:
                if op == "self":
                    done = snap.fused_self_batch(
                        [snap._cohort_views(*ck) for ck in members
                         if ck in cohort_prio])
                    if done and m.enabled:
                        m.inc("planner_fused_launches_total", op="self")
                        m.inc("planner_fused_cohorts_total",
                              value=float(done), op="self")
                else:
                    pairs = [p for p in members if p in pair_prio
                             and ("join", p[0], snap._view(p[0]).version,
                                  p[1], snap._view(p[1]).version, True)
                             not in snap._cache]
                    if pairs:
                        if m.enabled:
                            m.inc("planner_fused_launches_total", op="join")
                            m.inc("planner_fused_cohorts_total",
                                  value=float(len(pairs)), op="join")
                        snap._join_batch(pairs, True)
            self._stamp_coalescing(fresh)
        out = {}
        for name, q in queries.items():
            if name in throttled:
                out[name] = self._stale(self._last[name])
            else:
                out[name] = self._last[name] = q.evaluate(snap)
        return out
