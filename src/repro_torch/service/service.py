"""`EstimationService`: the multi-tenant streaming estimation front end,
ported from the JAX package's ``service/service.py``.

Composes the subsystem:

  registry.py   named streams grouped by shared hash params (join-ability)
  window.py     per-stream sliding windows; expiry = counter subtraction
  ingest.py     double-buffered, fixed-shape, batched ingest per cohort
  query.py      snapshot-based queries with analytical error bars
  planner.py    cross-group launch fusion and per-tenant admission

Lifecycle:

    svc = EstimationService()
    svc.create_group("g", SJPCConfig(d=6, s=4, width=2048, depth=3))
    svc.create_stream("tenant-a", "g", window_epochs=8)
    svc.ingest("tenant-a", records)        # buffered (numpy in, no device work)
    svc.flush()                            # one batched ingest per cohort
    svc.advance_epoch()                    # close the epoch on every window
    r = svc.snapshot().self_join("tenant-a")   # estimate +/- r.stderr

``ingest`` is deliberately device-free so tenant request handling stays
cheap; all device work happens in ``flush`` (and is shared across tenants).
``poll()`` evaluates the registered continuous queries against one shared
snapshot -- the batched continuous-query path.

States live on ``ServiceConfig.device``: the CUDA card when it is None,
the CPU only when the caller asks for it.  ``impl`` names the kernel
implementation of every op (None: resolved from the device, the
hand-written kernels on the card; ``"torch_ref"``: the plain versions).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import estimators
from .. import platform
from ..core.sjpc import SJPCConfig, SJPCState
from ..obs import (AccuracyAuditor, Observability, Tracer,
                   default_registry, default_tracer)

from .ingest import IngestPipeline
from .planner import PlannerConfig, QueryPlanner
from .query import ContinuousQuery, QueryEngine, QueryResult, Snapshot
from .registry import HashGroup, StreamEntry, StreamRegistry


_DEFAULT_WINDOW = object()       # "use ServiceConfig.window_epochs" sentinel


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    device: object = None            # where states live and kernels run
                                     # (None = the CUDA card; "cpu" on request)
    batch_rows: int = 256            # ingest round size per stream
    window_epochs: int | None = 8    # default; per-stream override at create
    auto_flush_rows: int | None = None   # flush() when a group's backlog hits this
    impl: str | None = None          # kernel implementation of every op
                                     # (None = resolved from the device;
                                     # "torch_ref" = the plain versions)
    use_fused: bool = True           # fused ingest path; False = reference oracle
    shards: int = 1                  # data-parallel ingest shards per round
    use_fused_query: bool = True     # batched query engine; False = per-stream
                                     # numpy oracle
    estimator: str = "sjpc"          # default estimator kind for new streams
                                     # (any repro_torch.estimators kind;
                                     # per-stream override at create_stream)
    backing_epochs: int = 0          # default sample-window refill depth K
                                     # (per-stream override at create_stream;
                                     # sample kinds only)
    observe: bool = True             # metrics + spans; False =
                                     # shared no-op bundle, reference-speed paths
    audit_rate: float = 0.0          # sampled exact-replay accuracy telemetry
                                     # (0 = off; 1 = audit every polled query)
    audit_max_records: int = 65536   # audit skip threshold (exact oracle cost)
    trace_sink: object = None        # JSON-lines span sink: path or file-like
    trace_annotate: bool = False     # bracket spans in torch.profiler
                                     # record_function regions
    use_planner: bool = True         # plan poll() through the query planner
                                     # (cross-group fusion + admission);
                                     # False = the per-group prefetch path
    planner: PlannerConfig = PlannerConfig()   # fusion/budget knobs


class EstimationService:
    def __init__(self, cfg: ServiceConfig = ServiceConfig(), *,
                 obs: Observability | None = None):
        if cfg.shards < 1 or cfg.batch_rows % cfg.shards:
            raise ValueError(f"batch_rows={cfg.batch_rows} must be divisible "
                             f"by shards={cfg.shards}")
        self.cfg = cfg
        self.device = platform.resolve(cfg.device)
        if obs is None:
            obs = self._build_obs(cfg)
        if cfg.audit_rate > 0.0 and obs.auditor is None:
            obs = dataclasses.replace(obs, auditor=AccuracyAuditor(
                obs.metrics, rate=cfg.audit_rate,
                max_records=cfg.audit_max_records))
        self.obs = obs
        self.registry = StreamRegistry(obs=self.obs, device=self.device)
        self.engine = QueryEngine(self.registry,
                                  use_fused_query=cfg.use_fused_query,
                                  impl=cfg.impl, obs=self.obs)
        self._pipelines: dict[str, IngestPipeline] = {}
        self._continuous: dict[str, ContinuousQuery] = {}
        self.planner = (QueryPlanner(self.registry, cfg.planner,
                                     obs=self.obs)
                        if cfg.use_planner else None)
        self.stats = {"ingested_records": 0, "flush_s": 0.0, "epochs": 0,
                      "snapshots": 0, "polls": 0}

    @staticmethod
    def _build_obs(cfg: ServiceConfig) -> Observability:
        """Default bundle: the process-global registry/tracer, a private
        tracer only when the config asks for a sink or profiler
        annotations (so two services never interleave one file)."""
        if not cfg.observe:
            return Observability.disabled()
        metrics = default_registry()
        if cfg.trace_sink is not None or cfg.trace_annotate:
            tracer = Tracer(sink=cfg.trace_sink, annotate=cfg.trace_annotate,
                            registry=metrics)
        else:
            tracer = default_tracer()
        return Observability(metrics=metrics, tracer=tracer)

    # -- provisioning ---------------------------------------------------
    def create_group(self, group_id: str, cfg: SJPCConfig) -> HashGroup:
        group = self.registry.create_group(
            group_id, cfg,
            estimator_opts={
                "sjpc": {"use_fused": self.cfg.use_fused,
                         "impl": self.cfg.impl,
                         "shards": self.cfg.shards},
                "reservoir": {"impl": self.cfg.impl},
            })
        self._pipelines[group_id] = IngestPipeline(
            group, batch_rows=self.cfg.batch_rows, obs=self.obs)
        return group

    def create_stream(self, name: str, group_id: str,
                      window_epochs=_DEFAULT_WINDOW, *,
                      estimator: str | None = None,
                      estimator_cfg=None,
                      backing_epochs: int | None = None,
                      uid: int | None = None) -> StreamEntry:
        """Register a stream.  ``estimator`` picks the protocol kind
        ("sjpc" | "reservoir" | "lsh_ss", default from ServiceConfig);
        competitors derive an equal-space config from the group's
        SJPCConfig unless ``estimator_cfg`` overrides it.
        ``backing_epochs`` enables the sample-window refill fold for
        windowed sample estimators (default from ServiceConfig; linear
        kinds reject it -- their expiry is exact already).  ``uid`` pins
        the stream's registry id, and with it the stream's ingest key grid
        (see StreamRegistry.register)."""
        if window_epochs is _DEFAULT_WINDOW:
            window_epochs = self.cfg.window_epochs
        kind = estimator or self.cfg.estimator
        if backing_epochs is None:
            backing = self.cfg.backing_epochs
            # the config-level default applies only where it is meaningful
            # (bounded sample windows); explicit arguments stay strict.
            # ``linear`` is a kind-level capability, read from the spec
            # (the group's cached instance resolves legacy registrations)
            if (estimators.spec_of(
                    self.registry.group(group_id).estimator(kind)).linear
                    or window_epochs is None):
                backing = 0
        else:
            backing = backing_epochs
        entry = self.registry.register(
            name, group_id, window_epochs, estimator=kind,
            estimator_cfg=estimator_cfg, backing_epochs=backing, uid=uid)
        if self.obs.metrics.enabled:
            self.obs.metrics.set("estimator_memory_bytes",
                                 float(entry.window.memory_bytes()),
                                 stream=name, kind=kind)
            entry.window._export_gauges()
        return entry

    # -- ingest ---------------------------------------------------------
    def ingest(self, name: str, records) -> int:
        """Buffer records for ``name``; device work is deferred to flush."""
        entry = self.registry.stream(name)
        pipe = self._pipelines[entry.group_id]
        n = pipe.submit(name, records)
        self.stats["ingested_records"] += n
        if self.obs.auditor is not None:
            self.obs.auditor.record(name, records,
                                    entry.window.window_epochs)
        if (self.cfg.auto_flush_rows is not None
                and pipe.pending_rows() >= self.cfg.auto_flush_rows):
            self._flush_group(entry.group_id)
        return n

    def ingest_state_delta(self, name: str, delta: SJPCState) -> None:
        """Absorb an externally-sketched delta (e.g. the training monitor's
        counters since its last publish) into ``name``'s open epoch.  The
        delta must have been sketched with this stream's group params (and
        the stream must run a linear estimator kind -- sample estimators
        cannot absorb foreign states)."""
        entry = self.registry.stream(name)
        est = entry.estimator
        if not estimators.spec_of(est).linear:
            raise ValueError(
                f"stream {name!r} runs non-linear estimator "
                f"{entry.estimator_kind!r}; external state deltas need a "
                "linear (mergeable-by-arithmetic) estimator")
        entry.window.absorb_delta(est.merge(entry.window.ingest_base(), delta))
        if self.obs.auditor is not None:
            self.obs.auditor.mark_unauditable(name)
        self.obs.metrics.inc("ingest_state_deltas_total", stream=name)

    # -- delta exchange between services --------------------------------
    def export_deltas(self) -> list:
        """Every stream's unshipped window delta since the last export
        (flushing first so the exports reflect all buffered records):
        ``[(name, kind, epoch, window_version, mode, state), ...]``.
        Streams with nothing new are skipped entirely -- an idle service
        returns ``[]``."""
        self.flush()
        out = []
        for e in self.registry.streams():
            d = e.window.export_delta()
            if d is None:
                continue
            mode, state = d
            out.append((e.name, e.estimator_kind, e.window.epoch,
                        e.window.version, mode, state))
            self.obs.metrics.inc("delta_exports_total", stream=e.name,
                                 mode=mode)
        return out

    def apply_remote_delta(self, name: str, mode: str, state) -> None:
        """Receiver-side application of one exported delta.  ``"merge"``
        folds a linear counter delta into the open epoch via the existing
        merge algebra (exactly :meth:`ingest_state_delta`); ``"replace"``
        installs a sample kind's open-slot state and refolds.  Epoch
        alignment (apply-before-advance) is the caller's contract."""
        entry = self.registry.stream(name)
        if mode == "merge":
            self.ingest_state_delta(name, state)
            return
        if mode != "replace":
            raise ValueError(f"unknown delta mode {mode!r}")
        if estimators.spec_of(entry.estimator).linear:
            raise ValueError(
                f"stream {name!r} runs linear estimator "
                f"{entry.estimator_kind!r}; replace-mode deltas are the "
                "sample-window protocol (linear kinds merge)")
        entry.window.absorb_delta(state)
        if self.obs.auditor is not None:
            self.obs.auditor.mark_unauditable(name)
        self.obs.metrics.inc("ingest_state_deltas_total", stream=name)

    def _flush_group(self, group_id: str) -> None:
        pipe = self._pipelines[group_id]
        entries = self.registry.streams(group_id)
        with self.obs.span("service.flush", histogram="service_flush_seconds",
                           labels={"group": group_id},
                           group=group_id, streams=len(entries)):
            t0 = time.perf_counter()
            new_states = pipe.flush(entries)
            for e in entries:
                e.window.absorb_delta(new_states[e.name])
            # CUDA launches are asynchronous: without waiting for the
            # committed windows this would time the *enqueue*.  flush_s is
            # device-inclusive wall time, obs on or off (the span's
            # histogram inherits the same interval)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats["flush_s"] += time.perf_counter() - t0

    def flush(self) -> None:
        """Drain every group's ingest buffer into the windows."""
        for group_id in list(self._pipelines):
            self._flush_group(group_id)

    # -- windowing ------------------------------------------------------
    def advance_epoch(self, name: str | None = None) -> None:
        """Close the open epoch (flushing first so the epoch boundary is
        exact); expired epochs are subtracted out of their windows."""
        self.flush()
        entries = (self.registry.streams() if name is None
                   else [self.registry.stream(name)])
        for e in entries:
            e.window.advance_epoch()
            if self.obs.auditor is not None:
                self.obs.auditor.advance_epoch(e.name)
        self.stats["epochs"] += 1
        self.obs.metrics.inc("service_epochs_total")

    # -- queries --------------------------------------------------------
    def snapshot(self, names: list[str] | None = None) -> Snapshot:
        self.flush()
        self.stats["snapshots"] += 1
        return self.engine.snapshot(names)

    def register_continuous(self, query: ContinuousQuery) -> None:
        if query.name in self._continuous:
            raise ValueError(f"continuous query {query.name!r} already exists")
        # validate eagerly: unknown streams / non-joinable pairs fail here,
        # not at poll time
        for s in query.streams:
            self.registry.stream(s)
        if query.kind == "join":
            self.registry.require_joinable(*query.streams)
        self._continuous[query.name] = query
        if self.planner is not None:
            self.planner.invalidate_queries()

    def set_tenant_budget(self, tenant: str, refill: float | None, *,
                          burst: float | None = None) -> None:
        """Set (or clear) one tenant's per-poll standing-query budget; see
        :meth:`QueryPlanner.set_tenant_budget`.  Requires the planner."""
        if self.planner is None:
            raise ValueError("admission control needs use_planner=True")
        self.planner.set_tenant_budget(tenant, refill, burst=burst)

    def poll(self) -> dict[str, QueryResult | dict[int, QueryResult]]:
        """Evaluate every continuous query against ONE shared snapshot.

        With the planner (the default) the device work is scheduled through
        the cached fusion plan: matching cohorts across hash groups share
        one ``estimate_batch`` launch, launches run in priority order, and
        over-budget tenants are served their last fresh result with
        ``stale=True``.  With ``use_planner=False`` the path prefetches one
        batch per touched group instead.  Either
        way the individual ``evaluate`` calls are pure cache lookups.
        """
        with self.obs.span("service.poll", histogram="service_poll_seconds",
                           queries=len(self._continuous)):
            snap = self.snapshot()
            if self.planner is not None:
                out = self.planner.poll(snap, self._continuous)
            else:
                snap.prefetch(self._continuous.values())
                out = {name: q.evaluate(snap)
                       for name, q in self._continuous.items()}
            self.stats["polls"] += 1
        if self.obs.auditor is not None:
            for q in self._continuous.values():
                res = out[q.name]
                if (res.stale if isinstance(res, QueryResult)
                        else any(r.stale for r in res.values())):
                    continue          # already audited when it was fresh
                kind = self.registry.stream(q.streams[0]).estimator_kind
                self.obs.auditor.maybe_audit(res, kind)
        return out

    # -- introspection --------------------------------------------------
    def describe(self) -> dict:
        groups = {}
        for g in self.registry.groups():
            pipe = self._pipelines[g.group_id]
            groups[g.group_id] = {
                "cfg": dataclasses.asdict(g.cfg),
                "streams": {e.name: {"records": e.records,
                                     "estimator": e.estimator_kind,
                                     "window_epochs": e.window.window_epochs,
                                     "live_epochs": e.window.live_epochs,
                                     "memory_bytes": e.window.memory_bytes()}
                            for e in self.registry.streams(g.group_id)},
                "ingest": dict(pipe.stats),
            }
        return {"groups": groups, "continuous": list(self._continuous),
                **self.stats}

    def refresh_gauges(self) -> None:
        """Recompute the derived / point-in-time gauges (memory bytes,
        window geometry, queue depth, per-(group, kind) cache hit
        ratios) so an export reflects *now*, not the last mutation."""
        m = self.obs.metrics
        if not m.enabled:
            return
        for e in self.registry.streams():
            m.set("estimator_memory_bytes", float(e.window.memory_bytes()),
                  stream=e.name, kind=e.estimator_kind)
            e.window._export_gauges()
        for group_id, pipe in self._pipelines.items():
            m.set("ingest_pending_rows", float(pipe.pending_rows()),
                  group=group_id)
        hits = m.series("query_cache_hits_total")
        misses = m.series("query_cache_misses_total")
        for key in sorted(set(hits) | set(misses)):
            h, miss = hits.get(key, 0.0), misses.get(key, 0.0)
            if h + miss > 0:
                m.set("query_cache_hit_ratio", h / (h + miss),
                      **dict(key))

    def metrics_report(self) -> str:
        """The service's metric state in the Prometheus text exposition
        format (derived gauges refreshed first).  ``obs.metrics.collect()``
        is the plain-dict equivalent for programmatic readers."""
        self.refresh_gauges()
        return self.obs.metrics.to_prometheus()
