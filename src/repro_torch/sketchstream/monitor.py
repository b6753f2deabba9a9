"""SJPC as an LM-stack feature: the stream monitor.

Every batch's sequences are reduced to d-column super-shingle records
(``data.recordize``) and absorbed into shard-local Fast-AGMS sketches.
Sketches are linear, so the merge across data-parallel shards is a plain
sum that can be deferred: counters live as a (shards, levels, t, w) stack
whose leading shard axis is summed on merge (``merge_monitor``).  A query
at any step pulls the merged counters and runs the Eq. 4 inversion, giving
g_s for every s in [s, d].

Two-stream mode (``contamination_estimate``): sketch two corpora with the
SAME hash parameters; the join estimator (Eq. 7) gives their
near-duplicate count.

The JAX package's ``sketchstream/monitor.py``.  The training step
(``launch/train.py``) runs the merged mode, one shard updated with the
whole batch, or on a mesh with a shard per batch rank the deferred mode,
each rank's block updated with its own rows (the JAX package's
``shard_map`` call site).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import sjpc
from ..core.sjpc import SJPCConfig, SJPCParams, SJPCState
from ..data.recordize import records_from_tokens


@dataclasses.dataclass(frozen=True)
class SketchMonitorConfig:
    d: int = 6                 # super-shingle columns per sequence
    s: int = 3                 # minimum similarity threshold monitored
    ratio: float = 0.5
    width: int = 1024
    depth: int = 3
    shards: int = 1            # data-parallel shard count (leading axis)
    merge_every_step: bool = False
    seed: int = 0xD5

    @property
    def sjpc(self) -> SJPCConfig:
        return SJPCConfig(d=self.d, s=self.s, ratio=self.ratio,
                          width=self.width, depth=self.depth, seed=self.seed)


class MonitorState(NamedTuple):
    counters: torch.Tensor     # (shards, levels, t, w) int32
    n: torch.Tensor            # (shards,) float32 records seen per shard
    step: torch.Tensor         # () int32


def init_monitor(cfg: SketchMonitorConfig, device=None) -> tuple[SJPCParams, MonitorState]:
    """Hash parameters and an empty state on ``device`` (None: the CUDA
    card)."""
    params, st = sjpc.init(cfg.sjpc, device=device)
    dev = st.counters.device
    counters = torch.zeros((cfg.shards,) + tuple(st.counters.shape), dtype=torch.int32,
                           device=dev)
    return params, MonitorState(counters=counters,
                                n=torch.zeros((cfg.shards,), dtype=torch.float32, device=dev),
                                step=torch.zeros((), dtype=torch.int32, device=dev))


def monitor_update_local(cfg: SketchMonitorConfig, params: SJPCParams,
                         local_counters, local_n, tokens, step, *, update_fn=None,
                         impl: str | None = None):
    """Shard-local update: local_counters (levels, t, w), tokens this
    shard's (b, S) slice.  Returns (counters, n).

    ``update_fn`` is ``sjpc.update``'s counter scatter (None: the plain
    ``sketch.sketch_update``, as in the JAX package; the train step passes
    ``kernels.ops.make_sjpc_update_fn()``, the ``sketch_update`` op);
    ``impl`` names the implementation of the sampling and fingerprint
    ops (None: by device)."""
    records = records_from_tokens(torch.as_tensor(tokens, device=local_counters.device), cfg.d)
    st = SJPCState(counters=local_counters, n=local_n, step=step)
    st = sjpc.update(cfg.sjpc, params, st, records, update_fn=update_fn, impl=impl)
    return st.counters, st.n


def merge_monitor(state: MonitorState) -> SJPCState:
    """Deferred merge: sum the shard axis (linearity)."""
    return SJPCState(counters=state.counters.sum(dim=0, dtype=torch.int32),
                     n=state.n.sum(), step=state.step)


def monitor_estimate(cfg: SketchMonitorConfig, state: MonitorState):
    """Continuous query: g_s for every monitored threshold s..d."""
    merged = merge_monitor(state)
    est = sjpc.estimate(cfg.sjpc, merged)
    return {
        "n": est.n,
        "per_level_pairs": est.x,           # X_k for k = s..d
        "g": {k: float(est.x[k - cfg.s:].sum() + est.n)
              for k in range(cfg.s, cfg.d + 1)},
    }


def contamination_estimate(cfg: SketchMonitorConfig, train_state: MonitorState,
                           eval_state: MonitorState):
    """Train<->eval similarity JOIN size (paper §6; Eq. 7 inversion)."""
    a = merge_monitor(train_state)
    b = merge_monitor(eval_state)
    est = sjpc.estimate_join(cfg.sjpc, a, b)
    return {
        "per_level_pairs": est.x,
        "join": {k: float(est.x[k - cfg.s:].sum())
                 for k in range(cfg.s, cfg.d + 1)},
    }
