"""Coordinator: tenant-hash routing, delta merging, replica serving, ported
from the JAX package's ``distributed/coordinator.py``.

The multi-host topology is a star: N worker processes each run an
`EstimationService` shard for the tenants ``crc32(name) % N`` hashes onto
them; the coordinator routes ingest, drives the epoch protocol, merges
exported deltas into **replica** windows through the existing merge
algebra, and answers any query from any replica -- queries never wait on
workers.

The epoch protocol per sync cycle (the coordinator is the only clock):

    ingest*  -> route records to the owning worker (fire-and-forget)
    flush    -> every worker drains its buffers (one ack each)
    sync     -> every worker exports its unshipped deltas (or the
                zero-byte heartbeat); the coordinator merges them into
                each replica (``coordinator_merge_seconds`` histogram,
                the replicas' device work included)
    advance  -> every worker closes its open epoch; the replicas rotate
                in the same breath (export-before-advance keeps ring
                slots mirrored slot-for-slot)

**Failure semantics**: a worker whose pipe breaks is marked dead; its
tenants keep serving from the last merged replica state with
``stale=True`` on every result.  No other tenant is affected; ingest routed
to a dead worker is counted and dropped.

Worker handles come in two flavors with one API (``send``/``recv``):
:class:`SubprocessWorker` frames the protocol over a child process's
stdin/stdout; :class:`LocalWorker` drives a `WorkerRuntime` in-process
through the SAME encoded bytes.  Either speaks to a coordinator of the
JAX package too: the frames are the same.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib

import numpy as np
import torch

from . import transport, wire
from .transport import (OP_ADVANCE, OP_CONFIG, OP_EXPORT, OP_FLUSH,
                        OP_INGEST, OP_METRICS, OP_SHUTDOWN)
from .worker import WorkerRuntime, encode_ingest, handle_request


def shard_of(name: str, n_workers: int) -> int:
    """The worker owning tenant ``name`` (stable content hash, so every
    process -- coordinator, workers, the oracle harness -- agrees)."""
    return zlib.crc32(name.encode("utf-8")) % n_workers


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The cluster topology: hash groups, tenant streams (declaration
    order defines the global uid every process pins), and the
    ``ServiceConfig`` kwargs workers and replicas share.  Streams are
    dicts ``{"name", "group"}`` plus optional ``window_epochs`` /
    ``estimator`` / ``backing_epochs`` overrides.  Everything is
    JSON-shippable: the service's ``device`` is a string (``"cpu"``), or
    absent for the CUDA card."""
    groups: tuple                # ((group_id, SJPCConfig), ...)
    streams: tuple               # ({"name": ..., "group": ...}, ...)
    service: dict = dataclasses.field(default_factory=dict)

    def uid(self, name: str) -> int:
        for i, s in enumerate(self.streams):
            if s["name"] == name:
                return i
        raise KeyError(f"unknown stream {name!r}")

    def tenants_of(self, worker: int, n_workers: int) -> list[str]:
        return [s["name"] for s in self.streams
                if shard_of(s["name"], n_workers) == worker]

    def worker_spec(self, worker: int, n_workers: int) -> dict:
        """The OP_CONFIG payload for one worker: all groups, only its
        tenants, uids pinned to the global declaration index."""
        return {
            "worker": worker,
            "service": dict(self.service),
            "groups": [{"group_id": gid, "cfg": dataclasses.asdict(cfg)}
                       for gid, cfg in self.groups],
            "streams": [{**s, "uid": i} for i, s in enumerate(self.streams)
                        if shard_of(s["name"], n_workers) == worker],
        }


# -- worker handles ---------------------------------------------------------

class LocalWorker:
    """In-process handle: the same encoded request/response bytes as the
    subprocess protocol, dispatched straight into a `WorkerRuntime`.
    ``fail()`` severs it (the lost-worker tests' kill switch)."""

    def __init__(self):
        self._runtime: WorkerRuntime | None = None
        self._pending: list = []
        self.alive = True

    @property
    def runtime(self) -> WorkerRuntime | None:
        return self._runtime

    def fail(self) -> None:
        self.alive = False

    def send(self, op: int, body: bytes = b"") -> None:
        if not self.alive:
            raise ConnectionError("worker handle severed")
        self._runtime, resp = handle_request(self._runtime, op, body)
        if resp is not None:
            self._pending.append(resp)

    def recv(self) -> bytes:
        if not self.alive:
            raise ConnectionError("worker handle severed")
        return self._pending.pop(0)

    def close(self) -> None:
        self.alive = False


class SubprocessWorker:
    """Framed protocol over a child process's stdin/stdout.  ``env`` is
    typically ``harness.worker_env()`` (capped threads and a PYTHONPATH
    that reaches ``repro_torch``); stderr is inherited, so worker-side
    tracebacks surface in the parent's console."""

    def __init__(self, *, env: dict | None = None, python: str | None = None,
                 stderr=None):
        import subprocess
        import sys
        # -c instead of -m: the package __init__ imports .worker, and
        # runpy warns when re-executing an already-imported submodule
        self._proc = subprocess.Popen(
            [python or sys.executable, "-c",
             "import sys; from repro_torch.distributed.worker import main; "
             "sys.exit(main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
            env=env)
        self.alive = True

    def send(self, op: int, body: bytes = b"") -> None:
        try:
            transport.write_frame(self._proc.stdin, transport.pack_op(op, body))
        except (OSError, ValueError) as e:
            self.alive = False
            raise ConnectionError(f"worker pipe broken: {e}") from e

    def recv(self) -> bytes:
        try:
            frame = transport.read_frame(self._proc.stdout)
        except (OSError, ValueError) as e:
            self.alive = False
            raise ConnectionError(f"worker pipe broken: {e}") from e
        if frame is None:
            self.alive = False
            raise ConnectionError("worker closed its pipe (EOF)")
        return frame

    def kill(self) -> None:
        self._proc.kill()
        self._proc.wait()
        self.alive = False

    def close(self) -> None:
        if self.alive:
            try:
                self.send(OP_SHUTDOWN)
                self.recv()
            except ConnectionError:
                pass
        self.alive = False
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        self._proc.wait(timeout=10)


# -- the coordinator --------------------------------------------------------

class Coordinator:
    def __init__(self, spec: ClusterSpec, workers: list, *,
                 replicas: int = 1, obs=None):
        from ..obs import MetricsRegistry, Observability, Tracer
        from ..service import EstimationService, ServiceConfig

        if obs is None:
            metrics = MetricsRegistry()
            obs = Observability(metrics=metrics,
                                tracer=Tracer(registry=metrics))
        self.obs = obs
        self.spec = spec
        self.workers = list(workers)
        self.n_workers = len(self.workers)
        self._dead: set[int] = set()
        self._stale_tenants: set[str] = set()
        self._rr = 0                       # replica round-robin cursor
        self._unsynced_since: float | None = None
        # replicas: full-topology services that never ingest records --
        # they absorb worker deltas and serve every query.  Replica 0
        # shares the coordinator's obs bundle (one aggregated registry);
        # extra replicas run with obs disabled to keep series unambiguous.
        self.replicas = []
        for r in range(replicas):
            svc = EstimationService(
                ServiceConfig(**spec.service),
                obs=self.obs if r == 0 else Observability.disabled())
            for gid, cfg in spec.groups:
                svc.create_group(gid, cfg)
            for i, s in enumerate(spec.streams):
                kwargs = {k: s[k] for k in
                          ("window_epochs", "estimator", "backing_epochs")
                          if k in s}
                svc.create_stream(s["name"], s["group"], uid=i, **kwargs)
            self.replicas.append(svc)
        # configure the workers (their shard of the same topology)
        for w, h in enumerate(self.workers):
            h.send(OP_CONFIG, json.dumps(
                spec.worker_spec(w, self.n_workers)).encode("utf-8"))
        for w, h in enumerate(self.workers):
            ack = json.loads(h.recv())
            if not (ack.get("ok") and ack.get("worker") == w):
                raise ConnectionError(f"worker {w} refused its configuration: {ack}")

    # -- failure bookkeeping -------------------------------------------
    def _mark_dead(self, w: int) -> None:
        if w in self._dead:
            return
        self._dead.add(w)
        tenants = self.spec.tenants_of(w, self.n_workers)
        self._stale_tenants.update(tenants)
        self.obs.metrics.inc("coordinator_worker_failures_total",
                             worker=str(w))
        self.obs.metrics.set("coordinator_stale_tenants",
                             float(len(self._stale_tenants)))

    def _alive(self):
        return [(w, h) for w, h in enumerate(self.workers)
                if w not in self._dead]

    def _broadcast(self, op: int) -> dict:
        """Send ``op`` to every live worker, then collect the responses
        (send-all-then-recv-all: flushes/exports run concurrently across
        workers).  A worker that errors on either leg is marked dead and
        dropped from the result -- the cycle continues for the rest."""
        sent = []
        for w, h in self._alive():
            try:
                h.send(op)
                sent.append((w, h))
            except ConnectionError:
                self._mark_dead(w)
        out = {}
        for w, h in sent:
            try:
                out[w] = h.recv()
            except ConnectionError:
                self._mark_dead(w)
        return out

    # -- ingest path ----------------------------------------------------
    def ingest(self, name: str, records) -> int:
        """Route one tenant's records to the owning worker (buffered,
        fire-and-forget -- no round-trip on the record path)."""
        w = shard_of(name, self.n_workers)
        m = self.obs.metrics
        arr = np.asarray(records)
        n = int(arr.shape[0])
        if w in self._dead:
            m.inc("coordinator_lost_ingest_records_total", value=float(n),
                  worker=str(w))
            return 0
        body = encode_ingest(name, arr)
        try:
            self.workers[w].send(OP_INGEST, body)
        except ConnectionError:
            self._mark_dead(w)
            m.inc("coordinator_lost_ingest_records_total", value=float(n),
                  worker=str(w))
            return 0
        if self._unsynced_since is None:
            self._unsynced_since = time.perf_counter()
        m.inc("coordinator_ingest_records_total", value=float(n),
              worker=str(w))
        return n

    def flush(self) -> dict:
        return {w: json.loads(r) for w, r in self._broadcast(OP_FLUSH).items()}

    # -- the merge cycle ------------------------------------------------
    def sync(self) -> dict:
        """Export every worker's deltas and merge them into the replicas.

        Per worker: decode the bundle (the zero-byte heartbeat short-
        circuits -- no version check, no merge work), move each decoded
        state to the replicas' devices and apply it through the replica
        services' merge algebra, timing the whole apply under
        ``coordinator_merge_seconds{worker=}``.  The replica freshness lag
        -- how old the oldest unmerged ingest was when this sync landed --
        is observed per cycle."""
        m = self.obs.metrics
        stats = {"deltas": 0, "heartbeats": 0, "workers": 0}
        for w, payload in self._broadcast(OP_EXPORT).items():
            stats["workers"] += 1
            t0 = time.perf_counter()
            msgs = wire.decode_bundle(payload)
            if msgs is wire.HEARTBEAT:
                stats["heartbeats"] += 1
                m.inc("coordinator_heartbeats_total", worker=str(w))
                continue
            for msg in msgs:
                mode = wire.mode_name(msg.mode)
                moved = {}
                for svc in self.replicas:
                    if svc.device not in moved:
                        moved[svc.device] = wire.state_to(msg.state, svc.device)
                    svc.apply_remote_delta(msg.stream, mode, moved[svc.device])
            # device-inclusive merge latency: absorbing a delta enqueues
            # asynchronous work on the card; wait for it before the clock
            # stops (the service-flush timing discipline)
            for dev in {svc.device for svc in self.replicas}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            stats["deltas"] += len(msgs)
            m.observe("coordinator_merge_seconds", dt, worker=str(w))
            m.inc("coordinator_merges_total", value=float(len(msgs)),
                  worker=str(w))
        if self._unsynced_since is not None:
            m.observe("coordinator_freshness_lag_seconds",
                      time.perf_counter() - self._unsynced_since)
            self._unsynced_since = None
        return stats

    def advance_epoch(self) -> None:
        """Close the epoch everywhere: workers first (they rotate their
        own rings), then the replicas -- callers must sync() first so the
        closing slots are fully mirrored (export-before-advance)."""
        self._broadcast(OP_ADVANCE)
        for svc in self.replicas:
            svc.advance_epoch()

    # -- serving --------------------------------------------------------
    def _replica(self):
        svc = self.replicas[self._rr % len(self.replicas)]
        self._rr += 1
        return svc

    def _staleify(self, res):
        from ..service import QueryResult
        if isinstance(res, QueryResult):
            if any(s in self._stale_tenants for s in res.streams):
                return res._replace(stale=True)
            return res
        return {k: self._staleify(r) for k, r in res.items()}

    def snapshot(self, names=None):
        """A query snapshot from the next replica (round-robin).  Results
        touching a lost worker's tenants are served from the last merged
        state -- marked via :meth:`stale_tenants`, which the caller (or
        :meth:`poll`) folds into ``stale=True``."""
        return self._replica().snapshot(names)

    def self_join(self, name: str, s: int | None = None):
        return self._staleify(self.snapshot([name]).self_join(name, s))

    def join(self, a: str, b: str, s: int | None = None):
        return self._staleify(self.snapshot([a, b]).join(a, b, s))

    def register_continuous(self, query) -> None:
        for svc in self.replicas:
            svc.register_continuous(query)

    def poll(self) -> dict:
        """Evaluate the standing queries on one replica (planner path:
        fusion + admission thread through untouched); lost-worker tenants
        come back ``stale=True`` on top of any admission staleness."""
        out = self._replica().poll()
        return {k: self._staleify(r) for k, r in out.items()}

    @property
    def stale_tenants(self) -> frozenset:
        return frozenset(self._stale_tenants)

    # -- observability ---------------------------------------------------
    def aggregate_metrics(self) -> dict:
        """Pull every live worker's metric snapshot and absorb it into
        the coordinator registry under a ``worker=<idx>`` label; returns
        the raw per-worker payloads (stats included)."""
        out = {}
        for w, payload in self._broadcast(OP_METRICS).items():
            rep = json.loads(payload)
            out[w] = rep
            self.obs.metrics.absorb(rep.get("metrics", {}), worker=str(w))
            for k, v in rep.get("stats", {}).items():
                self.obs.metrics.set(f"worker_stats:{k}", float(v),
                                     worker=str(w))
        return out

    def metrics_report(self) -> str:
        """One Prometheus text exposition for the whole cluster: replica-0
        service metrics, coordinator merge/failure series, and every
        worker's absorbed snapshot."""
        self.aggregate_metrics()
        self.replicas[0].refresh_gauges()
        return self.obs.metrics.to_prometheus()

    def close(self) -> None:
        for w, h in self._alive():
            try:
                h.close()
            except ConnectionError:
                pass
