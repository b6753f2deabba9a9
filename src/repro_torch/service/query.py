"""Query engine: self-join / join / all-thresholds estimates from a
snapshot, ported from the JAX package's ``service/query.py``.

Queries never touch live ingest state: the engine materializes a
:class:`Snapshot` -- each stream's windowed ``SJPCState`` pulled at one
instant -- and answers any number of queries from it.

The default query path is the **fused batched engine**: all streams of a
hash group are stacked into one (N, levels, t, w) counter tensor and
``sjpc.estimate_batch`` answers every (stream, threshold) cell -- level
moments, depth medians, the Eq. 4 inversion, and the suffix-sum g_k table
-- from one ``fused_query`` launch (the CUDA kernel on the card).  Join
queries batch the same way through ``sjpc.estimate_join_batch``;
``Snapshot.prefetch`` lets ``service.poll`` answer every registered join
pair of a group in one additional call.  The per-stream numpy path
(int64-exact F2 + float64 inversion per stream) is kept behind
``use_fused_query=False`` as the conformance oracle (``estimate_ref``).

Every batched table comes back to the host once, as numpy, when it is
computed (``EstimateTable`` holds numpy arrays), and enters the cache
there: the per-cell reads of ``self_join`` and ``join`` are numpy reads,
never device reads.

Results are memoized in a cache shared across snapshots of one
:class:`QueryEngine`, keyed by each stream's **window version** (bumped by
`WindowedSketch` on every ingest commit and epoch rotation) -- so standing
queries over an unchanged window are pure lookups, and a snapshot taken
across an expiry boundary can never be served a stale entry.

Error bars come from the paper's analytical bounds: Theorem 1 (projection
sampling alone) and Theorem 2 (sampling + sketching, width w) bound
var(G_s / g_s), so ``sqrt(bound)`` is a relative standard-deviation bound.
The true g_s is unknown at query time, so the estimate is plugged in --
standard practice, conservative when the estimate is low, and reported as
an explicit ``stderr`` field rather than silently folded in.  For join
queries the self-join bound with n = max(n_a, n_b) is used as a proxy (the
paper proves no join-specific bound).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.sjpc import SJPCConfig
from ..estimators import Estimator, stack_states
from ..obs import Observability

from .registry import StreamRegistry

_CACHE_MAX_ENTRIES = 4096      # shared-cache bound; LRU-evicted beyond


class QueryResult(NamedTuple):
    kind: str                  # "self_join" | "join" | "all_thresholds"
    streams: tuple             # 1 or 2 stream names
    s: int                     # threshold the estimate answers
    estimate: float            # g_s (self-join) or join size
    stderr: float              # absolute 1-sigma bound/estimate (online)
    stderr_offline: float      # absolute 1-sigma, sampling-only variant
    per_level: np.ndarray      # X_k for k = s..d
    n: tuple                   # records in the window, per stream
    window_epochs: tuple       # live epochs per stream (coverage metadata)
    stderr_kind: str = "none"  # uncertainty method behind stderr:
    #   "analytic" (Thm 1/2 bounds), "bootstrap", "bootstrap_stratified",
    #   or "none" (no bars available; stderr is 0)
    stale: bool = False        # True when admission control served the last
    #   cached result instead of fresh device work

    def ci(self, z: float = 1.96) -> tuple:
        """The +/- z-sigma confidence interval, floored at 0 (both g_s
        and join sizes are non-negative counts).  The default z is the
        normal 95% quantile; for "analytic" kinds the bounds are
        conservative, so coverage is >= the nominal level."""
        return (max(self.estimate - z * self.stderr, 0.0),
                self.estimate + z * self.stderr)


@dataclasses.dataclass(frozen=True)
class _StreamView:
    name: str
    cfg: SJPCConfig            # the group's config (thresholds, join params)
    state: object              # the stream's windowed estimator state
    estimator: Estimator       # the stream's protocol engine
    kind: str                  # estimator kind (batch cohort key)
    n: float
    live_epochs: int
    window_epochs: int | None
    group_id: str
    version: int               # window version at snapshot time (cache key)
    shape_sig: tuple = ()      # state leaf shapes: same-estimator streams
    #   with different window geometry (backing-epoch refill expands the
    #   sample-window total) must batch in separate stacks


class Snapshot:
    """Immutable view of every stream's window at one instant.

    ``cache`` is shared across the owning engine's snapshots; every entry's
    key embeds the (name, version) pairs it was computed from, so entries
    survive exactly as long as the underlying windows are unchanged.
    """

    def __init__(self, views: dict[str, _StreamView],
                 registry: StreamRegistry, *,
                 use_fused_query: bool = True,
                 impl: str | None = None,
                 cache: dict | None = None,
                 obs: Observability | None = None):
        self._views = views
        self._registry = registry
        self._use_fused = use_fused_query
        self._impl = impl
        self._cache = {} if cache is None else cache
        self._local: dict = {}     # per-snapshot memo of shared-cache hits
        self._obs = obs if obs is not None else Observability.disabled()

    def _count_cache(self, hit: bool, group: str, kind: str, op: str) -> None:
        """Version-keyed cache accounting: a *miss* is a serve that had to
        recompute; everything else -- per-snapshot memo hits, shared-cache
        hits across snapshots, idle ride-along tenants whose versions kept
        a cohort key stable -- is a *hit*."""
        m = self._obs.metrics
        if m.enabled:
            m.inc("query_cache_hits_total" if hit
                  else "query_cache_misses_total",
                  group=group, kind=kind, op=op)

    def _view(self, name: str) -> _StreamView:
        if name not in self._views:
            raise KeyError(f"stream {name!r} not in snapshot")
        return self._views[name]

    def _cache_get(self, key):
        """Shared-cache read that refreshes LRU recency (the engine evicts
        least-recently-used entries, so every hit must count as use)."""
        cache = self._cache
        if isinstance(cache, collections.OrderedDict):
            cache.move_to_end(key)
        return cache[key]

    # -- fused batched path --------------------------------------------
    def _cohort_views(self, group_id: str, eid: int,
                      shape_sig: tuple) -> list[_StreamView]:
        # cohorts key on the estimator INSTANCE (id), not the kind: a
        # same-kind stream with an explicit estimator_cfg override has its
        # own engine (and possibly state shapes) and must batch separately.
        # The shape signature further splits same-engine streams whose
        # window geometry differs (a backing-epoch refill total is wider
        # than an unexpanded one; stacking them would shape-mismatch)
        return [v for v in self._views.values()
                if v.group_id == group_id and id(v.estimator) == eid
                and v.shape_sig == shape_sig]

    def _self_batch(self, view: _StreamView, clamp: bool):
        """The one batched call answering every (stream, threshold) cell of
        a hash group's estimator cohort; memoized by the member windows'
        versions (shared engine cache) and per-snapshot (versions are fixed
        within one snapshot, so repeated queries skip rebuilding the
        version key)."""
        group_id, eid = view.group_id, id(view.estimator)
        local_key = (group_id, eid, view.shape_sig, clamp)
        if local_key in self._local:
            self._count_cache(True, group_id, view.kind, "self")
            return self._local[local_key]
        views = self._cohort_views(group_id, eid, view.shape_sig)
        key = self._self_key(views, clamp)
        hit = key in self._cache
        self._count_cache(hit, group_id, views[0].kind, "self")
        if not hit:
            with self._obs.span("query.self_batch",
                                histogram="query_batch_seconds",
                                labels={"group": group_id,
                                        "kind": views[0].kind, "op": "self"},
                                group=group_id, kind=views[0].kind,
                                streams=len(views)) as sp:
                est = views[0].estimator.estimate_batch(
                    stack_states([v.state for v in views]), clamp=clamp,
                    impl=self._impl)
                sp.sync(est)
            self._cache[key] = ({v.name: i for i, v in enumerate(views)}, est)
        self._local[local_key] = self._cache_get(key)
        return self._local[local_key]

    @staticmethod
    def _self_key(views: list[_StreamView], clamp: bool) -> tuple:
        """The shared-cache key of one group cohort's batched self table."""
        return ("self", views[0].group_id, views[0].kind, clamp,
                tuple((v.name, v.version) for v in views))

    def fused_self_batch(self, cohorts: list[list[_StreamView]],
                         clamp: bool = True) -> int:
        """ONE ``estimate_batch`` launch answering several group cohorts at
        once (the planner's cross-group fusion).  Every
        cohort must share the fusion signature -- same estimator kind,
        derived config, and state shapes -- so their states stack along one
        stream axis; the result unstacks back into the per-cohort cache
        entries ``_self_batch`` reads, byte-for-byte the entries the
        unfused path would have written (row slices of one batch).
        """
        todo = [c for c in cohorts if self._self_key(c, clamp)
                not in self._cache]
        if not todo:
            return 0
        views = [v for c in todo for v in c]
        kind = views[0].kind
        for c in todo:           # the per-cohort miss the unfused path counts
            self._count_cache(False, c[0].group_id, kind, "self")
        gids = sorted({c[0].group_id for c in todo})
        with self._obs.span("query.self_batch",
                            histogram="query_batch_seconds",
                            labels={"group": "+".join(gids), "kind": kind,
                                    "op": "self"},
                            group="+".join(gids), kind=kind,
                            streams=len(views), cohorts=len(todo)) as sp:
            est = views[0].estimator.estimate_batch(
                stack_states([v.state for v in views]), clamp=clamp,
                impl=self._impl)
            sp.sync(est)
        lo = 0
        for c in todo:
            hi = lo + len(c)
            sub = type(est)(*(a[lo:hi] if isinstance(a, (np.ndarray,
                                                         torch.Tensor))
                              else a for a in est))
            self._cache[self._self_key(c, clamp)] = (
                {v.name: i for i, v in enumerate(c)}, sub)
            lo = hi
        return len(todo)

    def _join_batch(self, pairs: list[tuple[str, str]], clamp: bool) -> None:
        """Answer many join pairs of one group in a single compiled call,
        filling the per-pair cache entries ``prefetch``/``join`` read."""
        views_a = [self._view(a) for a, _ in pairs]
        views_b = [self._view(b) for _, b in pairs]
        gid, kind = views_a[0].group_id, views_a[0].kind
        with self._obs.span("query.join_batch",
                            histogram="query_batch_seconds",
                            labels={"group": gid, "kind": kind, "op": "join"},
                            group=gid, kind=kind, pairs=len(pairs)) as sp:
            est = views_a[0].estimator.estimate_join_batch(
                stack_states([v.state for v in views_a]),
                stack_states([v.state for v in views_b]),
                clamp=clamp, impl=self._impl)
            sp.sync(est)
        for i, (va, vb) in enumerate(zip(views_a, views_b)):
            k = ("join", va.name, va.version, vb.name, vb.version, clamp)
            # slice array fields to the pair's row; scalar metadata
            # (stderr_kind) passes through unsliced
            self._cache[k] = type(est)(*(a[i:i + 1] if isinstance(
                a, (np.ndarray, torch.Tensor)) else a for a in est))

    def prefetch(self, queries, *, clamp: bool = True) -> None:
        """Warm the cache for a batch of :class:`ContinuousQuery` -- one
        ``estimate_batch`` per touched group plus one ``estimate_join_batch``
        per group with join pairs (instead of one call per query)."""
        if not self._use_fused:
            return
        m = self._obs.metrics
        if m.enabled and queries:
            m.inc("query_prefetch_queries_total", value=float(len(queries)))
        # join pairs bucket like the self path splits cohorts: by estimator
        # INSTANCE and state shapes, not group alone -- a group mixing
        # estimator_cfg-overridden streams or backing-epoch geometries must
        # not stack mismatched states into one estimate_join_batch launch
        join_pairs: dict[tuple, list[tuple[str, str]]] = {}
        for q in queries:
            if q.kind == "join":
                a, b = q.streams
                self._registry.require_joinable(a, b)
                va, vb = self._view(a), self._view(b)
                k = ("join", a, va.version, b, vb.version, clamp)
                if k not in self._cache:
                    bucket = (va.group_id, id(va.estimator),
                              id(vb.estimator), va.shape_sig, vb.shape_sig)
                    join_pairs.setdefault(bucket, []).append((a, b))
            else:
                self._self_batch(self._view(q.streams[0]), clamp)
        for bucket, pairs in join_pairs.items():
            pairs = sorted(set(pairs))
            if m.enabled:
                m.inc("query_prefetch_join_pairs_total",
                      value=float(len(pairs)), group=bucket[0])
            self._join_batch(pairs, clamp)

    # -- per-stream reference oracle -----------------------------------
    def _ref_table(self, name: str, clamp: bool):
        """The estimator's per-stream host oracle (SJPC: int64-exact F2 +
        float64 inversion), memoized by window version."""
        v = self._view(name)
        key = ("ref", name, v.version, clamp)
        hit = key in self._cache
        self._count_cache(hit, v.group_id, v.kind, "ref")
        if not hit:
            self._cache[key] = v.estimator.estimate_ref(v.state, clamp=clamp)
        return self._cache_get(key)

    # ------------------------------------------------------------------
    def self_join(self, name: str, s: int | None = None, *,
                  clamp: bool = True) -> QueryResult:
        """Windowed g_s for ``name`` (s defaults to, and must be >=, cfg.s)."""
        v = self._view(name)
        s = v.cfg.s if s is None else s
        if not v.cfg.s <= s <= v.cfg.d:
            raise ValueError(f"s={s} outside sketched range "
                             f"[{v.cfg.s}, {v.cfg.d}] of {name!r}")
        li = s - v.cfg.s
        if self._use_fused:
            index, est = self._self_batch(v, clamp)
            i = index[name]
        else:
            est = self._ref_table(name, clamp)
            i = 0
        g = float(est.g[i, li])
        on, off = float(est.stderr[i, li]), float(est.stderr_offline[i, li])
        xs = est.x[i, li:]
        return QueryResult("self_join", (name,), s, g, on, off, xs,
                           (v.n,), (v.live_epochs,), est.stderr_kind)

    def join(self, a: str, b: str, s: int | None = None, *,
             clamp: bool = True) -> QueryResult:
        """Windowed similarity-join size of two same-group streams (§6)."""
        self._registry.require_joinable(a, b)
        va, vb = self._view(a), self._view(b)
        cfg = va.cfg
        s = cfg.s if s is None else s
        if not cfg.s <= s <= cfg.d:
            raise ValueError(f"s={s} outside sketched range [{cfg.s}, {cfg.d}]")
        li = s - cfg.s
        if self._use_fused:
            k = ("join", a, va.version, b, vb.version, clamp)
            hit = k in self._cache
            self._count_cache(hit, va.group_id, va.kind, "join")
            if not hit:
                self._join_batch([(a, b)], clamp)
            est = self._cache_get(k)
        else:
            k = ("join_ref", a, va.version, b, vb.version, clamp)
            hit = k in self._cache
            self._count_cache(hit, va.group_id, va.kind, "join")
            if not hit:
                self._cache[k] = va.estimator.estimate_join_ref(
                    va.state, vb.state, clamp=clamp)
            est = self._cache_get(k)
        j = float(est.g[0, li])
        on, off = float(est.stderr[0, li]), float(est.stderr_offline[0, li])
        xs = est.x[0, li:]
        return QueryResult("join", (a, b), s, j, on, off, xs,
                           (va.n, vb.n), (va.live_epochs, vb.live_epochs),
                           est.stderr_kind)

    def all_thresholds(self, name: str, *, clamp: bool = True) -> dict[int, QueryResult]:
        """g_k for every k in [cfg.s, d] -- one batch lookup, d-s+1 results."""
        v = self._view(name)
        return {k: self.self_join(name, k, clamp=clamp)
                for k in range(v.cfg.s, v.cfg.d + 1)}

    def streams(self) -> list[str]:
        return list(self._views)


@dataclasses.dataclass(frozen=True)
class ContinuousQuery:
    """A standing query evaluated against each snapshot (``service.poll``)."""
    name: str
    kind: str                       # "self_join" | "join" | "all_thresholds"
    streams: tuple                  # (a,) or (a, b)
    s: int | None = None
    priority: int = 1               # planner scheduling class; LOWER value is
    #   served first and throttled last (0 = most critical)
    tenant: str | None = None       # admission-control budget account;
    #   defaults to the first stream name (one tenant per stream)

    @property
    def tenant_id(self) -> str:
        return self.tenant if self.tenant is not None else self.streams[0]

    def evaluate(self, snap: Snapshot):
        if self.kind == "self_join":
            return snap.self_join(self.streams[0], self.s)
        if self.kind == "join":
            return snap.join(self.streams[0], self.streams[1], self.s)
        if self.kind == "all_thresholds":
            return snap.all_thresholds(self.streams[0])
        raise ValueError(f"unknown query kind {self.kind!r}")


class QueryEngine:
    def __init__(self, registry: StreamRegistry, *,
                 use_fused_query: bool = True,
                 impl: str | None = None,
                 cache_max_entries: int | None = None,
                 obs: Observability | None = None):
        self._registry = registry
        self.use_fused_query = use_fused_query
        self.impl = impl
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_max = (_CACHE_MAX_ENTRIES if cache_max_entries is None
                           else cache_max_entries)
        self.obs = obs if obs is not None else Observability.disabled()

    def snapshot(self, names: list[str] | None = None) -> Snapshot:
        entries = (self._registry.streams() if names is None
                   else [self._registry.stream(n) for n in names])
        # LRU eviction: drop only the least-recently-used entries down to
        # the bound (every read refreshes recency via Snapshot._cache_get),
        # so one overflowing snapshot can never cold-start hot standing
        # queries the way a wholesale clear() did
        evicted = 0
        while len(self._cache) > self._cache_max:
            self._cache.popitem(last=False)
            evicted += 1
        if evicted:
            self.obs.metrics.inc("query_cache_evictions_total",
                                 value=float(evicted))
        with self.obs.span("query.snapshot",
                           histogram="query_snapshot_seconds",
                           streams=len(entries)):
            views = {}
            for e in entries:
                st = e.window.window_state()
                views[e.name] = _StreamView(
                    name=e.name, cfg=self._registry.group(e.group_id).cfg,
                    state=st, estimator=e.estimator, kind=e.estimator_kind,
                    n=e.window.n_live(),
                    live_epochs=e.window.live_epochs,
                    window_epochs=e.window.window_epochs,
                    group_id=e.group_id, version=e.window.version,
                    shape_sig=tuple(tuple(leaf.shape) for leaf in st))
        if self.obs.metrics.enabled:
            self.obs.metrics.set("query_cache_entries", float(len(self._cache)))
        return Snapshot(views, self._registry,
                        use_fused_query=self.use_fused_query,
                        impl=self.impl, cache=self._cache, obs=self.obs)
