"""Batched ingest: double-buffered submission, fixed-shape coalescing, one
batched ``Estimator.ingest_rounds`` per estimator cohort per flush, the
per-(stream, round) key grid and the multi-round, multi-stream SJPC update,
ported from the JAX package's ``service/ingest.py``.

:class:`IngestPipeline` stacks every stream of a hash group along a
leading axis -- states (S, ...), records (R, S, B, d), row masks (R, S, B),
keys (R, S, 2) -- and consumes all R coalesced rounds of a flush in one
``ingest_rounds`` call per **estimator cohort** (streams of one estimator
instance).  The records of a cohort are uploaded once per flush, as 4-byte
words (``core.hashing.as_field_tensor``), and so is its key grid.

The JAX package consumes all R coalesced rounds of a flush for S streams in
one jit'd dispatch: ``lax.scan`` over rounds, ``vmap`` over streams.  Here
that is a Python loop over rounds and over streams, since the SJPC kernels
take one stream's counters: each (round, stream) cell is one
``sjpc.update_fused`` (the ``sample_weights`` and ``fused_ingest`` kernels
on the card, the cell's key read there from one upload of the key grid) or, with
``use_fused=False``, one per-level ``sjpc.update`` whose scatter is the
``sketch_update`` op (the conformance path).  Both give the same counters
for the same keys.

Sharding: with ``shards > 1`` every round's B rows split into ``shards``
slices, each folded into a shard-local delta sketch under the key
``fold_in(round_key, shard)``; the deltas merge once after all rounds
(counters add, n and steps sum), as in the JAX package.

Shapes are static: records are coalesced into rounds of exactly
``batch_rows`` rows per stream, the tail round padded with zero rows that
carry row_mask 0 (contributing nothing to counters or n).

Double buffering: ``submit`` appends to the *front* buffer while ``flush``
drains the *back* buffer; the buffers swap at flush start.

Determinism: stream u's i-th consumed round uses ``ingest_key(cfg, uid,
i)``, a pure function, so a window can be rebuilt offline bit-exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng, sjpc
from ..core.hashing import as_field_tensor
from ..core.sjpc import SJPCConfig, SJPCParams, SJPCState
from ..estimators import index_state, stack_states
from ..kernels.ops import make_sjpc_update_fn
from ..obs import Observability
from .registry import HashGroup, StreamEntry

_INGEST_SALT = 0x5E41CE
_EMPTY = np.zeros((0,))          # shape probe for absent pending entries


def ingest_key(cfg: SJPCConfig, uid: int, round_idx: int) -> torch.Tensor:
    """The key stream u folds into its round_idx-th ingest round."""
    base = prng.PRNGKey(cfg.seed ^ _INGEST_SALT)
    return prng.fold_in(prng.fold_in(base, uid), round_idx)


def ingest_key_grid(seed: int, uids, round_idx) -> torch.Tensor:
    """Vectorized :func:`ingest_key`: uids (S,), round_idx (R, S) -> keys
    (R, S, 2) on the CPU, each ``fold_in(fold_in(PRNGKey(seed), uid),
    round)``."""
    round_idx = torch.tensor(np.asarray(round_idx), dtype=torch.int64)
    uids = torch.broadcast_to(torch.tensor(np.asarray(uids), dtype=torch.int64)[None, :],
                              round_idx.shape)
    base = torch.broadcast_to(prng.PRNGKey(seed), tuple(round_idx.shape) + (2,))
    return prng.fold_in(prng.fold_in(base, uids), round_idx)


def _one_stream(cfg, params, use_fused, impl, counters, n, step, values, mask, key):
    state = SJPCState(counters, n, step)
    if use_fused:
        state = sjpc.update_fused(cfg, params, state, values, key=key, row_mask=mask, impl=impl)
    else:
        state = sjpc.update(cfg, params, state, values, key=key, row_mask=mask, impl=impl,
                            update_fn=make_sjpc_update_fn(impl=impl))
    return state


def multi_stream_update(cfg: SJPCConfig, params: SJPCParams, counters, n, steps, values,
                        row_mask, keys, *, impl: str | None = None, use_fused: bool = False):
    """One round for every stream of a group: counters (S, L, t, w) int32,
    n (S,) float32, steps (S,) int32, values (S, B, d) uint32 data,
    row_mask (S, B), keys (S, 2).  Returns the updated (counters, n,
    steps)."""
    return multi_round_update(cfg, params, counters, n, steps,
                              as_field_tensor(values, counters.device)[None],
                              torch.as_tensor(row_mask)[None], torch.as_tensor(keys)[None],
                              impl=impl, use_fused=use_fused)


def multi_round_update(cfg: SJPCConfig, params: SJPCParams, counters, n, steps, values,
                       row_mask, keys, *, impl: str | None = None, use_fused: bool = True,
                       shards: int = 1):
    """Every round of a flush for every stream of a group.

    counters (S, L, t, w) int32; n (S,) float32; steps (S,) int32 on the
    device of the counters; values (R, S, B, d) uint32 data; row_mask
    (R, S, B); keys (R, S, 2).  Returns the updated (counters, n, steps).
    ``impl`` names the kernel implementation of every op (None resolves
    from the device).  ``shards > 1`` needs B % shards == 0.
    """
    device = counters.device
    values = as_field_tensor(values, device)
    row_mask = torch.as_tensor(row_mask).to(device=device, dtype=torch.int32)
    keys = torch.as_tensor(keys, dtype=torch.int64).cpu()
    R, S, B, _ = values.shape
    if shards == 1:
        keys = keys.to(device)   # one upload; the draws read each cell's key there
        for r in range(R):
            states = [_one_stream(cfg, params, use_fused, impl, counters[s], n[s], steps[s],
                                  values[r, s], row_mask[r, s], keys[r, s])
                      for s in range(S)]
            counters = torch.stack([st.counters for st in states])
            n = torch.stack([st.n for st in states])
            steps = torch.stack([st.step for st in states])
        return counters, n, steps

    if B % shards:
        raise ValueError(f"batch of {B} rows does not split into {shards} shards")
    per = B // shards
    # every shard's key fold_in(round_key, shard), for all cells at once
    # on the host, then one upload
    shard_keys = torch.stack([prng.fold_in(keys, torch.full(keys.shape[:-1], j))
                              for j in range(shards)]).to(device)
    delta = [[SJPCState(torch.zeros_like(counters[s]), torch.zeros_like(n[s]),
                        torch.zeros_like(steps[s])) for s in range(S)] for _ in range(shards)]
    for r in range(R):
        for j in range(shards):
            rows = slice(j * per, (j + 1) * per)
            for s in range(S):
                st = delta[j][s]
                delta[j][s] = _one_stream(cfg, params, use_fused, impl, st.counters, st.n,
                                          st.step, values[r, s, rows], row_mask[r, s, rows],
                                          shard_keys[j, r, s])
    # the deferred merge: one reduction over the shard axis for all rounds
    dc = torch.stack([torch.stack([st.counters for st in shard]) for shard in delta])
    dn = torch.stack([torch.stack([st.n for st in shard]) for shard in delta])
    dstep = torch.stack([torch.stack([st.step for st in shard]) for shard in delta])
    return counters + dc.sum(dim=0, dtype=torch.int32), n + dn.sum(dim=0), \
        steps + dstep.sum(dim=0, dtype=torch.int32)


class IngestPipeline:
    """Per-group ingest front end.  Not thread-safe by itself; the service
    serializes submit/flush (the double buffer is about fixed-shape
    coalescing, not about lock-free concurrency)."""

    def __init__(self, group: HashGroup, *, batch_rows: int = 256,
                 obs: Observability | None = None):
        assert batch_rows >= 1
        self.group = group
        self.batch_rows = batch_rows
        self.obs = obs if obs is not None else Observability.disabled()
        self._front: dict[str, list[np.ndarray]] = {}
        self._front_rows = 0                 # queue depth, kept incrementally
        self._back: dict[str, list[np.ndarray]] = {}
        self.stats = {"submitted_records": 0, "flushes": 0, "rounds": 0,
                      "dispatches": 0, "padded_rows": 0, "dispatch_rows": 0}

    # ------------------------------------------------------------------
    def submit(self, name: str, records) -> int:
        """Queue records ((n, d) integer array) for ``name``; returns n."""
        records = np.ascontiguousarray(np.asarray(records, dtype=np.uint32))
        if records.ndim != 2 or records.shape[1] != self.group.cfg.d:
            raise ValueError(
                f"records must be (n, d={self.group.cfg.d}); got {records.shape}")
        self._front.setdefault(name, []).append(records)
        self._front_rows += records.shape[0]
        self.stats["submitted_records"] += records.shape[0]
        m = self.obs.metrics
        if m.enabled:
            gid = self.group.group_id
            m.inc("ingest_submitted_records_total", records.shape[0],
                  group=gid)
            m.set("ingest_pending_rows", self._front_rows, group=gid)
            m.set_max("ingest_pending_rows_peak", self._front_rows, group=gid)
        return records.shape[0]

    def pending_rows(self) -> int:
        return self._front_rows

    # ------------------------------------------------------------------
    def flush(self, entries: list[StreamEntry]) -> dict:
        """Drain the queued records of ``entries`` (all streams of this
        group) and return each stream's new ingest state (cumulative window
        for linear estimators, open-epoch state for windowed sample
        estimators -- whatever ``window.ingest_base`` hands out).

        Streams dispatch in **estimator cohorts**: every stream of one
        estimator instance shares one batched ``ingest_rounds`` call;
        streams with no remaining records ride along fully masked.
        ``entry.flushes`` counts the rounds that carried the stream's OWN
        rows, and is the replay coordinate for :func:`ingest_key` -- cohort
        rounds that existed only for a busier cohort-mate are fully masked
        here, consume none of this stream's randomness, and do not advance
        it.  A stream with no pending records gets its ``ingest_base()``
        object back, so its window keeps its version.
        """
        self._front, self._back = self._back, self._front
        self._front_rows = 0
        pending = {name: (np.concatenate(chunks) if chunks else
                          np.zeros((0, self.group.cfg.d), np.uint32))
                   for name, chunks in self._back.items()}
        self._back = {}
        if self.obs.metrics.enabled:
            self.obs.metrics.set("ingest_pending_rows", 0,
                                 group=self.group.group_id)

        entries = sorted(entries, key=lambda e: e.uid)
        out = {e.name: e.window.ingest_base() for e in entries}
        # cohorts key on the estimator INSTANCE: streams of one kind but
        # with an explicit estimator_cfg override are distinct cohorts
        # (different state shapes / seeds must not share a call)
        cohorts: dict[int, list[StreamEntry]] = {}
        for e in entries:
            cohorts.setdefault(id(e.estimator), []).append(e)
        self.stats["flushes"] += 1
        for cohort in cohorts.values():
            self._flush_cohort(cohort, pending, out)
        return out

    def _flush_cohort(self, entries: list[StreamEntry], pending: dict,
                      out: dict) -> None:
        B, cfg = self.batch_rows, self.group.cfg
        est = entries[0].estimator
        counts = [pending.get(e.name, _EMPTY).shape[0] for e in entries]
        rounds = max((-(-c // B) for c in counts if c), default=0)
        if rounds == 0:
            return

        S = len(entries)
        values = np.zeros((rounds, S, B, cfg.d), np.uint32)
        mask = np.zeros((rounds, S, B), np.int32)
        round_idx = np.zeros((rounds, S), np.int32)
        for i, e in enumerate(entries):
            rows = pending.get(e.name, np.zeros((0, cfg.d), np.uint32))
            for r in range(rounds):
                chunk = rows[r * B:(r + 1) * B]
                values[r, i, :chunk.shape[0]] = chunk
                mask[r, i, :chunk.shape[0]] = 1
                self.stats["padded_rows"] += B - chunk.shape[0]
            # streams with no pending records ride along fully masked but
            # neither consume round keys nor commit the ride-along state
            # below: their window content is unchanged, and committing it
            # would bump the version and thrash version-keyed query
            # caches.  Each stream's replay coordinate advances only by
            # the rounds that carried ITS rows (ceil(c_i / B)), so window
            # content never depends on co-tenants' backlog sizes
            round_idx[:, i] = e.flushes + np.arange(rounds)
            if rows.shape[0]:
                e.flushes += -(-rows.shape[0] // B)
                e.records += int(rows.shape[0])

        gid, kind = self.group.group_id, entries[0].estimator_kind
        with self.obs.span("ingest.flush_cohort",
                           histogram="ingest_flush_seconds",
                           labels={"group": gid, "kind": kind},
                           group=gid, kind=kind, streams=S,
                           rounds=rounds) as sp:
            keys = ingest_key_grid(est.ingest_seed,
                                   np.asarray([e.uid for e in entries], np.int64),
                                   round_idx)
            states = stack_states([out[e.name] for e in entries])
            states = est.ingest_rounds(states, values, mask, keys)
            # device-time semantics: the span waits for the states before
            # its clock stops (trace events show dispatch vs compute)
            sp.sync(states)
        self.stats["rounds"] += rounds
        self.stats["dispatches"] += 1
        self.stats["dispatch_rows"] += S * B * rounds
        m = self.obs.metrics
        if m.enabled:
            m.inc("ingest_dispatches_total", group=gid, kind=kind)
            m.inc("ingest_rounds_total", rounds, group=gid, kind=kind)
            m.inc("ingest_dispatch_rows_total", S * B * rounds,
                  group=gid, kind=kind)
        for i, e in enumerate(entries):
            if pending.get(e.name, _EMPTY).shape[0]:
                out[e.name] = index_state(states, i)
