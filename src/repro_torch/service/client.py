"""Service client for the stream monitor, ported from the JAX package's
``service/client.py``.

Turns the whole-stream ``sketchstream.monitor`` into a tenant of the
estimation service: each ``publish`` takes the monitor's current cumulative
state, derives the *delta* since the previous publish by linearity
(new - old is exactly the sketch of the records seen in between), ingests
that delta into the stream's open epoch, and closes the epoch.  The window
then answers "how much near-duplication in the last K publish intervals"
-- the time-windowed continuous query the whole-stream monitor cannot.

The stream's hash group is created from the monitor's own SJPCConfig, so a
second monitored corpus (e.g. eval) published into the same group supports
the §6 contamination join, windowed.
"""
from __future__ import annotations

from ..core import sjpc
from ..sketchstream.monitor import MonitorState, SketchMonitorConfig, merge_monitor

from .query import QueryResult
from .service import EstimationService


class MonitorServiceClient:
    def __init__(self, service: EstimationService, stream: str,
                 monitor_cfg: SketchMonitorConfig, *, group_id: str | None = None,
                 window_epochs=None):
        self.service = service
        self.stream = stream
        self.monitor_cfg = monitor_cfg
        gid = group_id or f"monitor/{monitor_cfg.seed:#x}"
        existing = {g.group_id: g for g in service.registry.groups()}
        if gid not in existing:
            service.create_group(gid, monitor_cfg.sjpc)
        elif existing[gid].cfg != monitor_cfg.sjpc:
            # same params draw (seed) does NOT imply the same lattice: merging
            # deltas sketched under a different config silently corrupts the
            # group, so refuse rather than reuse
            raise ValueError(
                f"group {gid!r} exists with config {existing[gid].cfg}, "
                f"incompatible with this monitor's {monitor_cfg.sjpc}; pass "
                "an explicit group_id")
        self.group_id = gid
        kw = {} if window_epochs is None else {"window_epochs": window_epochs}
        service.create_stream(stream, gid, **kw)
        self._last: sjpc.SJPCState | None = None

    # ------------------------------------------------------------------
    def publish(self, monitor_state: MonitorState) -> None:
        """Ingest the monitor's progress since the last publish as one epoch."""
        merged = merge_monitor(monitor_state)
        delta = merged if self._last is None else sjpc.subtract(merged, self._last)
        self.service.ingest_state_delta(self.stream, delta)
        self.service.advance_epoch(self.stream)
        self._last = merged

    def resync(self, monitor_state: MonitorState) -> None:
        """Re-base the delta after a checkpoint restore: the monitor rolled
        back, so the next publish must cover only post-restore progress.
        Batches replayed between the restore point and the last publish were
        already ingested into earlier epochs; they age out with the window
        (expiry-by-subtraction), so the windowed estimate self-heals."""
        self._last = merge_monitor(monitor_state)

    def query(self, *, clamp: bool = True) -> dict[int, QueryResult]:
        """Windowed g_k (+ error bars) for every monitored threshold.

        Served by the fused batched query engine: the whole all-thresholds
        table comes out of one batched call, cached by window version
        until the next publish changes the window."""
        return self.service.snapshot([self.stream]).all_thresholds(
            self.stream, clamp=clamp)

    def metrics_report(self) -> str:
        """The owning service's Prometheus text dump -- a training loop
        scrapes its monitor tenant like any other."""
        return self.service.metrics_report()

    def log_entry(self, step: int) -> dict:
        """A flat dict for a training loop's sketch log: g_k +/- stderr per k."""
        res = self.query()
        entry = {"step": step,
                 "window_epochs": self.service.registry.stream(
                     self.stream).window.window_epochs}
        for k, r in res.items():
            entry[k] = r.estimate
            entry[f"stderr_{k}"] = r.stderr
        return entry
