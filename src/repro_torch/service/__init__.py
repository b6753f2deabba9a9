"""repro_torch.service -- the multi-tenant streaming estimation service,
ported from the JAX package's ``service/``.

Sliding-window sketches behind a registry of named streams, batched
per-cohort ingest, a snapshot query engine with error bars, and a query
planner with cross-group fusion and per-tenant admission.
"""
from .client import MonitorServiceClient
from .ingest import (IngestPipeline, ingest_key, ingest_key_grid,
                     multi_round_update, multi_stream_update)
from .planner import PlannerConfig, QueryPlanner
from .query import ContinuousQuery, QueryEngine, QueryResult, Snapshot
from .registry import HashGroup, StreamEntry, StreamRegistry
from .service import EstimationService, ServiceConfig
from .window import WindowedSketch

__all__ = [
    "ContinuousQuery", "EstimationService", "HashGroup", "IngestPipeline",
    "MonitorServiceClient", "PlannerConfig", "QueryEngine", "QueryPlanner",
    "QueryResult", "ServiceConfig", "Snapshot", "StreamEntry",
    "StreamRegistry", "WindowedSketch", "ingest_key", "ingest_key_grid",
    "multi_round_update", "multi_stream_update",
]
