"""Sketch registry: many named streams (tenants), grouped by shared hashes,
ported from the JAX package's ``service/registry.py``.

A **hash group** owns one ``SJPCConfig`` and one draw of ``SJPCParams``
(bucket/sign hash coefficients + fingerprint bases).  Every SJPC stream
registered into the group sketches with those exact parameters, which is
the paper's §6 precondition: the similarity-*join* estimator is the sketch
inner product, and inner products are only meaningful between sketches
built with identical hash functions.  Streams in different groups can use
different configs (dimensionality, threshold, width, ...) but are not
pairwise joinable -- the registry enforces this at query time.

Per-stream **estimator choice**: each stream picks an estimator kind from
:mod:`repro_torch.estimators` ("sjpc" by default); the group's
``SJPCConfig`` seeds every kind's derived configuration, so a reservoir or
LSH-SS stream created next to an SJPC stream is equal-space with it by
construction.  One estimator instance per (group, kind) is cached on the
group, so cohort streams share hash params and one construction.

Every group's params and every stream's states live on the registry's
device (the service's: the CUDA card unless the caller asks for the CPU).
Each stream carries its own :class:`~repro_torch.service.window.WindowedSketch`,
so tenants in one group may still have different window lengths.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import estimators as est_mod
from .. import platform
from ..core import sjpc
from ..core.sjpc import SJPCConfig, SJPCParams
from ..estimators import Estimator
from ..obs import Observability
from .window import WindowedSketch


@dataclasses.dataclass(frozen=True)
class HashGroup:
    group_id: str
    cfg: SJPCConfig
    params: SJPCParams
    # per-kind construction overrides (the service's impl / use_fused /
    # shards for "sjpc") and the per-kind instance cache
    estimator_opts: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    device: torch.device | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _estimators: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def estimator(self, kind: str = "sjpc",
                  estimator_cfg=None) -> Estimator:
        """The group's shared estimator instance for ``kind`` (constructed
        on first use; an explicit ``estimator_cfg`` bypasses the cache).
        ``estimator_opts[kind]`` (the service's dispatch flags) apply
        either way."""
        if estimator_cfg is not None:
            return est_mod.make(kind, self.cfg, params=self.params,
                                estimator_cfg=estimator_cfg,
                                opts=self.estimator_opts.get(kind),
                                device=self.device)
        if kind not in self._estimators:
            self._estimators[kind] = est_mod.make(
                kind, self.cfg, params=self.params,
                opts=self.estimator_opts.get(kind), device=self.device)
        return self._estimators[kind]

    def cached_estimator(self, kind: str) -> Estimator | None:
        """The group's cfg-derived instance for ``kind`` if one has been
        constructed -- the planner's cross-group fusion eligibility test
        (an ``estimator_cfg``-overridden stream's instance is never this
        one, so it never fuses across groups)."""
        return self._estimators.get(kind)


@dataclasses.dataclass
class StreamEntry:
    name: str
    group_id: str
    uid: int                        # dense per-registry id (keys, stacking order)
    window: WindowedSketch
    estimator_kind: str = "sjpc"
    flushes: int = 0                # ingest rounds consumed (the key grid's coordinate)
    records: int = 0                # total records ever ingested

    @property
    def estimator(self) -> Estimator:
        return self.window.estimator


class StreamRegistry:
    def __init__(self, obs: Observability | None = None, *, device=None):
        self.obs = obs if obs is not None else Observability.disabled()
        self.device = platform.resolve(device)
        self._groups: dict[str, HashGroup] = {}
        self._streams: dict[str, StreamEntry] = {}
        self._next_uid = 0
        # topology version: bumped on every group/stream registration.
        # Cohort membership -- which streams stack into which batched
        # launch -- is a pure function of the registered streams, so this
        # is the invalidation key for the query planner's cached fusion
        # plan (estimator-cfg choices happen at registration too, so they
        # are covered)
        self.version = 0

    # ------------------------------------------------------------------
    def create_group(self, group_id: str, cfg: SJPCConfig, *,
                     estimator_opts: dict | None = None) -> HashGroup:
        if group_id in self._groups:
            raise ValueError(f"group {group_id!r} already exists")
        params, _ = sjpc.init(cfg, device=self.device)
        group = HashGroup(group_id=group_id, cfg=cfg, params=params,
                          estimator_opts=dict(estimator_opts or {}),
                          device=self.device)
        self._groups[group_id] = group
        self.version += 1
        return group

    def register(self, name: str, group_id: str,
                 window_epochs: int | None = None, *,
                 estimator: str = "sjpc",
                 estimator_cfg=None,
                 backing_epochs: int = 0,
                 uid: int | None = None) -> StreamEntry:
        """``uid`` pins the stream's per-registry id instead of taking the
        next dense one.  The uid keys the per-(stream, round) ingest key
        grid (``ingest.ingest_key``), so a service that pins its tenants'
        uids sketches bit-identically to any other run over the same
        stream.  Pinned uids must be unique; the dense counter skips past
        them."""
        if name in self._streams:
            raise ValueError(f"stream {name!r} already registered")
        if uid is None:
            uid = self._next_uid
        elif any(e.uid == uid for e in self._streams.values()):
            raise ValueError(f"uid {uid} already taken (pinned uids must "
                             "be unique per registry)")
        group = self.group(group_id)
        est = group.estimator(estimator, estimator_cfg)
        entry = StreamEntry(
            name=name, group_id=group_id, uid=uid,
            window=WindowedSketch(est, est.init(sid=0), window_epochs,
                                  backing_epochs=backing_epochs,
                                  obs=self.obs, name=name),
            estimator_kind=estimator)
        self._next_uid = max(self._next_uid, uid) + 1
        self._streams[name] = entry
        self.version += 1
        return entry

    # ------------------------------------------------------------------
    def group(self, group_id: str) -> HashGroup:
        if group_id not in self._groups:
            raise KeyError(f"unknown group {group_id!r}")
        return self._groups[group_id]

    def stream(self, name: str) -> StreamEntry:
        if name not in self._streams:
            raise KeyError(f"unknown stream {name!r}")
        return self._streams[name]

    def group_of(self, name: str) -> HashGroup:
        return self.group(self.stream(name).group_id)

    def streams(self, group_id: str | None = None) -> list[StreamEntry]:
        entries = list(self._streams.values())
        if group_id is not None:
            entries = [e for e in entries if e.group_id == group_id]
        return entries

    def groups(self) -> list[HashGroup]:
        return list(self._groups.values())

    def joinable(self, a: str, b: str) -> bool:
        """Two streams support the §6 join estimator iff they share hashes
        AND both run a kind whose spec declares ``join_capable`` (built
        in: SJPC)."""
        ea, eb = self.stream(a), self.stream(b)
        return (ea.group_id == eb.group_id
                and ea.estimator_kind == eb.estimator_kind
                and est_mod.spec_of(ea.estimator).join_capable)

    def require_joinable(self, a: str, b: str) -> HashGroup:
        ea, eb = self.stream(a), self.stream(b)
        if ea.group_id != eb.group_id:
            raise ValueError(
                f"streams {a!r} ({ea.group_id}) and {b!r} "
                f"({eb.group_id}) are in different hash groups; "
                "the join estimator needs identical hash params (paper §6)")
        if not self.joinable(a, b):
            raise ValueError(
                f"streams {a!r} ({ea.estimator_kind}) and {b!r} "
                f"({eb.estimator_kind}) must both run a join-capable "
                "estimator kind to answer §6 join queries")
        return self.group_of(a)
