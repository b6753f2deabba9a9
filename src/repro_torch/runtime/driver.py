"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler policy.  The JAX package's ``runtime/driver.py``.

The driver owns the train loop around ``launch.train.make_train_step``:

- **Checkpoint/restart**: the whole TrainState (parameters, optimizer
  moments, SJPC monitor counters, step) is committed atomically every
  ``ckpt_every`` steps (``checkpoint.chunked``); on any step failure the
  driver restores the last committed state and replays -- ``make_batch``
  is deterministic in the step, so replayed batches are identical.
- **Failure injection**: ``inject_failure_at={step: exc}`` raises inside
  the loop to exercise the recovery path.
- **Straggler policy**: a step slower than ``straggler_factor`` x the
  trailing median is recorded; after ``straggler_limit`` consecutive
  offenders the driver records a mitigation and re-bases the deadline.
- **Sketch telemetry**: with ``monitor_cfg`` alone the driver queries the
  whole-stream monitor; a ``service_client``
  (``service.MonitorServiceClient``) publishes the monitor's delta to the
  estimation service each interval instead.

The step's end is a read of its loss (the JAX package waits with
``jax.block_until_ready``).  Restored leaves go to the template's
devices.

On a mesh every rank runs its own driver on the same ``ckpt_dir`` and
the same steps: the state's DTensors are checkpointed whole by rank 0
(``checkpoint.save_checkpoint``, a collective), ``shardings`` (the
reference's keyword: ``launch.train.state_shardings``' tree) gives each
rank its block back on restore, and the monitor reaches the telemetry as
the whole (global) state, as the reference's global array does.  A
failure must strike every rank at the same step, as
``inject_failure_at`` does, since the restore's collectives run on all.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

from torch.distributed.tensor import DTensor

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..optim.adamw import local
from ..sketchstream.monitor import MonitorState, monitor_estimate


class SimulatedFailure(RuntimeError):
    pass


def _whole(monitor: MonitorState) -> MonitorState:
    """The monitor with each DTensor leaf gathered whole (every rank)."""
    return MonitorState(*(x.full_tensor() if isinstance(x, DTensor) else x for x in monitor))


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    sketch_log_every: int = 50
    straggler_factor: float = 3.0
    straggler_limit: int = 3
    max_restarts: int = 5


class TrainDriver:
    def __init__(self, step_fn, init_state, make_batch: Callable[[int], Any],
                 cfg: DriverConfig, *, monitor_cfg=None, state_template=None,
                 shardings=None, service_client=None):
        """``make_batch(step) -> batch`` must be deterministic in step;
        ``shardings`` places the restored state (module docstring)."""
        self.step_fn = step_fn
        self.cfg = cfg
        self.make_batch = make_batch
        self.monitor_cfg = monitor_cfg
        self.service_client = service_client
        self.shardings = shardings
        self.state = init_state
        self.template = state_template if state_template is not None else init_state
        self.metrics_log: list[dict] = []
        self.sketch_log: list[dict] = []
        self.events: list[dict] = []
        self.restarts = 0
        self._step_times: list[float] = []
        self._consecutive_slow = 0
        self.inject_failure_at: dict[int, Exception] = {}

    # ------------------------------------------------------------------
    @property
    def step(self) -> int:
        return int(local(self.state.step))

    def _checkpoint(self):
        save_checkpoint(self.cfg.ckpt_dir, self.step, self.state, keep=self.cfg.keep)
        self.events.append({"kind": "checkpoint", "step": self.step})

    def _restore(self):
        state, man = restore_checkpoint(self.cfg.ckpt_dir, self.template,
                                        shardings=self.shardings)
        self.state = state
        if self.service_client is not None and self.state.monitor is not None:
            self.service_client.resync(_whole(self.state.monitor))
        self.events.append({"kind": "restore", "step": man.step})
        return man.step

    def _straggler_check(self, dt: float, step: int):
        self._step_times.append(dt)
        window = self._step_times[-20:]
        if len(window) < 5:
            return
        med = statistics.median(window[:-1])
        if dt > self.cfg.straggler_factor * med:
            self._consecutive_slow += 1
            self.events.append({"kind": "straggler", "step": step, "dt": dt, "median": med})
            if self._consecutive_slow >= self.cfg.straggler_limit:
                # mitigation: on a real cluster evict the host and restore
                # elastically; one process re-bases the deadline.
                self.events.append({"kind": "straggler_mitigation", "step": step})
                self._step_times = [med]
                self._consecutive_slow = 0
        else:
            self._consecutive_slow = 0

    # ------------------------------------------------------------------
    def run(self, num_steps: int, *, slow_step_hook: Callable | None = None):
        """Run to self.step + num_steps with recovery; returns the metrics log."""
        target = self.step + num_steps
        if latest_step(self.cfg.ckpt_dir) is None:
            self._checkpoint()                      # step-0 baseline
        while self.step < target:
            step = self.step
            try:
                if step in self.inject_failure_at:
                    raise self.inject_failure_at.pop(step)
                t0 = time.time()
                if slow_step_hook is not None:
                    slow_step_hook(step)
                batch = self.make_batch(step)
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])       # waits for the step
                dt = time.time() - t0
                self._straggler_check(dt, step)
                if step % self.cfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["loss"], m["step"], m["dt"] = loss, step, dt
                    self.metrics_log.append(m)
                if ((self.service_client is not None or self.monitor_cfg is not None)
                        and getattr(self.state, "monitor", None) is not None
                        and step % self.cfg.sketch_log_every == 0):
                    if self.service_client is not None:
                        self.service_client.publish(_whole(self.state.monitor))
                        self.sketch_log.append(self.service_client.log_entry(step))
                    else:
                        est = monitor_estimate(self.monitor_cfg, _whole(self.state.monitor))
                        self.sketch_log.append({"step": step, **est["g"]})
                if step > 0 and step % self.cfg.ckpt_every == 0:
                    self._checkpoint()
            except Exception as e:                   # noqa: BLE001
                self.restarts += 1
                self.events.append({"kind": "failure", "step": step, "error": repr(e)})
                if self.restarts > self.cfg.max_restarts:
                    raise
                self._restore()
        self._checkpoint()
        return self.metrics_log
