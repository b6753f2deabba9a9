"""Sliding-window estimator state: per-epoch ring with expiry, ported from
the JAX package's ``service/window.py``.

Generalized over the :class:`repro_torch.estimators.Estimator` protocol.
Two window strategies, chosen by the kind's declarative spec
(``EstimatorSpec.linear``):

**Linear estimators** (SJPC): expiry-by-subtraction.  Keep the cumulative
state of the live window (``total``) plus per-epoch *delta* states in a
ring of ``window_epochs`` slots; when an epoch rotates past the window
edge its delta is subtracted from ``total`` and the slot is recycled.
Queries read ``total`` directly.  Invariants (held in
tests/test_torch_service.py and by ``chip_smoke.py`` on the card):

  W1  total == sum of the live ring slots, bit-exactly, at all times.
  W2  after any number of rotations, total == a fresh sketch built from
      only the live epochs' batches (same per-batch keys) -- expiry by
      subtraction is exact, not approximate.
  W3  total.n >= 0 and (clamp=True) estimates stay non-negative.

**Sample estimators** (reservoir, lsh_ss): a uniform sample cannot be
"un-sampled" by arithmetic, so each epoch is sketched into its own ring
slot (states init'd with ``sid = epoch`` for provenance) and ``total`` is
the estimator's merge-fold over the live slots, recomputed when an epoch
expires.  Ingest targets the *open slot* (see :meth:`ingest_base`), and a
commit that changes it refreshes the fold.  Expired epochs drop whole
slots, so expiry is exact in n and provenance.

``backing_epochs = K`` (sample windows only) bounds the fold's
compression loss: the W live slots together retain up to W x capacity
records, but the plain fold shrinks them to ONE base-capacity total.
With K backing epochs each sample structure folds at capacity
cap + K * cap//2, so ``_refold`` refills the total from kept per-epoch
data instead of discarding it.

``window_epochs=None`` means an unbounded (whole-stream) window for
either strategy -- no ring, nothing expires, ingest goes straight into
``total``.

The open (current) epoch accumulates at ring position ``pos``;
``advance_epoch`` closes it.  ``version`` bumps whenever ``total``
changes (ingest commits; rotations that expire data) and is the query
engine's cache key -- a rotation that leaves ``total`` untouched must not
invalidate standing-query caches.

**No state is ever written in place.**  JAX arrays are immutable, and the
reference leans on it: a snapshot holds ``total``, a shipped export
baseline holds a ring slot, a commit holds a row of the stacked flush
output.  Here every update builds new tensors (``estimator.merge`` /
``subtract`` and leaf-wise ``+``), and the ring is a list of per-epoch
states whose slots are replaced, never added into, so a state anyone kept
reads back unchanged after later flushes and rotations.
"""
from __future__ import annotations

import torch

from ..estimators import Estimator, spec_of
from ..obs import Observability


def _leafwise(op, a, b):
    return type(a)(*(op(x, y) for x, y in zip(a, b)))


def _zeros_like(state):
    return type(state)(*(torch.zeros_like(leaf) for leaf in state))


class WindowedSketch:
    """Mutable host-side wrapper around the (device-resident) window state.

    Mutation here is per-epoch bookkeeping, off the ingest hot path (which
    batches through service.ingest -- one multi-stream ingest per
    estimator cohort -- and then calls :meth:`absorb_delta` once)."""

    def __init__(self, estimator: Estimator, init_state,
                 window_epochs: int | None = None,
                 backing_epochs: int = 0,
                 obs: Observability | None = None, name: str = ""):
        assert window_epochs is None or window_epochs >= 1
        self.obs = obs if obs is not None else Observability.disabled()
        self.name = name                     # metric label (stream name)
        self.estimator = estimator
        # the kind's declarative spec drives the window strategy:
        # ``spec.linear`` picks delta-ring vs slot-fold, and
        # ``spec.wire_mode`` the exported delta mode
        self.spec = spec_of(estimator)
        self.cfg = getattr(estimator, "cfg", None)
        self.window_epochs = window_epochs
        self.backing_epochs = int(backing_epochs)
        if self.backing_epochs:
            if self.spec.linear:
                raise ValueError(
                    "backing_epochs is a sample-window refill; linear "
                    f"estimators ({estimator.kind!r}) expire exactly by "
                    "subtraction and have nothing to refill")
            if window_epochs is None:
                raise ValueError(
                    "backing_epochs needs a bounded window (unbounded "
                    "sample windows never expire, so never shrink)")
        self.total = init_state
        self.epoch = 0                      # index of the open epoch
        self.version = 0                    # bumped whenever ``total`` changes
        # delta-export bookkeeping: the version last shipped and, for
        # linear windows, the open epoch's content at that point (the
        # shipped baseline the next delta is taken against).  Reset on
        # advance_epoch -- exports are per-open-epoch, never cumulative,
        # because expiry subtraction runs independently (and identically)
        # on the exporting and the receiving ring
        self._shipped_version = 0
        self._shipped_base = None
        if window_epochs is None:
            return
        if self.spec.linear:
            # ring of per-epoch DELTA states
            self._ring: list = [_zeros_like(init_state)
                                for _ in range(window_epochs)]
        else:
            # ring of per-epoch STATES; slot sid = epoch for provenance
            self._slots: list = [None] * window_epochs
            self._slots[0] = init_state
            if self.backing_epochs:
                # ``total`` folds at expanded capacity from version 0 so
                # its shapes never change across rotations
                self._refold()
        self._pos = 0                       # slot of the open epoch
        self._live = 1                      # live epochs incl. the open one

    # ------------------------------------------------------------------
    def ingest_base(self):
        """The state the ingest pipeline should update: the cumulative
        window for linear estimators (and unbounded windows), the open
        epoch's own state for windowed sample estimators."""
        if self.window_epochs is not None and not self.spec.linear:
            return self._slots[self._pos]
        return self.total

    def absorb_delta(self, new_state) -> None:
        """Commit the post-ingest state for :meth:`ingest_base`.  Linear:
        the delta vs the previous total is credited to the open epoch's
        ring slot.  Sample: the open slot is replaced and the live-window
        fold refreshed."""
        base = self.ingest_base()
        if new_state is base or (
                len(new_state) == len(base)
                and all(a is b for a, b in zip(new_state, base))):
            # no-op flush: nothing changed, keep the version.  The leaf
            # check hardens the identity test against pipelines that
            # re-wrap unchanged leaves in a new container -- an
            # equal-but-new state must not thrash version-keyed caches
            return
        self.version += 1
        if self.window_epochs is None or self.spec.linear:
            if self.window_epochs is not None:
                delta = self.estimator.subtract(new_state, self.total)
                self._ring[self._pos] = _leafwise(
                    torch.add, self._ring[self._pos], delta)
            self.total = new_state
        else:
            self._slots[self._pos] = new_state
            self._refold()

    def _refold(self) -> None:
        """total = merge-fold of the live ring slots (sample windows).

        With ``backing_epochs = K`` the fold runs at *expanded* capacity
        (each sample structure gains K half-capacity backing slots, see
        ``Estimator.refill_capacity``): the refold refills the expanded
        total from the data the slots kept, so an expiry no longer shrinks
        the served sample to 1/W of what the window retains."""
        self.obs.metrics.inc("window_refolds_total", stream=self.name,
                             refill=str(bool(self.backing_epochs)))
        live = [s for s in self._slots if s is not None]
        K = self.backing_epochs
        if K and len(live) == 1:
            # singleton fold still expands (stable total shape): merge
            # with an empty state of the same kind
            live = live + [self.estimator.init(sid=0)]
        total = live[0]
        for s in live[1:]:
            total = (self.estimator.merge(total, s, backing=K) if K
                     else self.estimator.merge(total, s))
        self.total = total

    # -- delta export ---------------------------------------------------
    def export_delta(self):
        """What this stream ships since its last export: ``None`` when
        nothing changed, else ``(mode, state)``:

        * linear windows -> ``("merge", delta)``: the leaf-wise difference
          of the open epoch's accumulated state against the shipped
          baseline (the receiver applies it through the estimator's merge,
          crediting its own open ring slot);
        * sample windows -> ``("replace", state)``: the open slot's full
          state (provenance tags included) -- a uniform sample has no
          arithmetic delta, so the receiver replaces its slot and refolds.

        Epoch alignment is the caller's contract: export from every
        service BEFORE advancing the epoch, so a slot is fully mirrored
        when it closes (advance_epoch resets the baseline).
        """
        if self.version == self._shipped_version:
            return None
        self._shipped_version = self.version
        if not self.spec.linear:
            return (self.spec.wire_mode, self.ingest_base())
        acc = (self.total if self.window_epochs is None
               else self._ring[self._pos])
        base = self._shipped_base
        self._shipped_base = acc
        delta = acc if base is None else _leafwise(torch.sub, acc, base)
        if "step" in getattr(delta, "_fields", ()):
            # ``step`` is the exporter's key-stream position, not window
            # data; a receiver never ingests records, so it has no key
            # position to advance.  Shipping zero keeps the receiver a pure
            # data mirror: counters and n bit-equal, step pinned at 0
            delta = delta._replace(step=torch.zeros_like(delta.step))
        return ("merge", delta)

    def advance_epoch(self) -> None:
        """Close the open epoch.  If the ring is full, the oldest epoch
        expires: subtracted from ``total`` (linear) or dropped from the
        fold (sample)."""
        self.epoch += 1
        if self.window_epochs is None:
            return
        self._pos = (self._pos + 1) % self.window_epochs
        expiring = self._live >= self.window_epochs
        if not expiring:
            self._live += 1
        with self.obs.span("window.rotate",
                           histogram="window_rotate_seconds",
                           labels={"stream": self.name},
                           stream=self.name, expiring=expiring) as sp:
            if self.spec.linear:
                if expiring:
                    # the slot we are about to reuse holds the expiring
                    # epoch; version bumps only here -- a rotation that
                    # leaves ``total`` untouched must not invalidate
                    # version-keyed query caches
                    expired = self._with_total_step(self._ring[self._pos])
                    self.total = self.estimator.subtract(self.total, expired)
                    self.version += 1
                self._ring[self._pos] = _zeros_like(self._ring[self._pos])
            else:
                self._slots[self._pos] = self.estimator.init(sid=self.epoch)
                if expiring:
                    self._refold()
                    self.version += 1
            sp.sync(self.total)
        # re-arm the export baseline for the new open epoch: the version
        # bump an expiry causes must not read as "new data to ship".
        # Unbounded windows never take this path: their exports stay
        # cumulative against the standing baseline.
        self._shipped_base = None
        self._shipped_version = self.version
        m = self.obs.metrics
        if m.enabled:
            m.inc("window_rotations_total", stream=self.name)
            if expiring:
                m.inc("window_expirations_total", stream=self.name)
            self._export_gauges()

    def _export_gauges(self) -> None:
        """Refresh the per-stream window gauges (live ring slots, version,
        refill depth) -- called on rotation and by metrics_report()."""
        m = self.obs.metrics
        if not m.enabled:
            return
        m.set("window_live_epochs", self.live_epochs, stream=self.name)
        m.set("window_version", self.version, stream=self.name)
        if self.backing_epochs:
            m.set("window_backing_epochs", self.backing_epochs,
                  stream=self.name)

    def _with_total_step(self, state):
        """Epoch deltas carry no meaningful key position: expiry removes
        old *data*, not key history (see sjpc.subtract), so reconstructed
        ring states borrow the cumulative state's step."""
        if "step" not in getattr(state, "_fields", ()):
            return state
        return state._replace(step=self.total.step)

    # ------------------------------------------------------------------
    def window_state(self):
        """The state of exactly the live window (linear W1: == ring sum)."""
        return self.total

    def n_live(self) -> float:
        """Host-side record count of the live window, cached per version so
        snapshot construction pays one device read per changed stream."""
        if getattr(self, "_n_cache_version", None) != self.version:
            self._n_cache = float(self.total.n)
            self._n_cache_version = self.version
        return self._n_cache

    @property
    def live_epochs(self) -> int:
        return self._live if self.window_epochs is not None else self.epoch + 1

    def ring_sum(self):
        """Recompute total from the ring (diagnostics / invariant W1;
        linear estimators only -- sample windows fold via merge)."""
        assert self.window_epochs is not None, "unbounded window has no ring"
        assert self.spec.linear, "sample windows have no delta ring"
        acc = self._ring[0]
        for slot in self._ring[1:]:
            acc = _leafwise(torch.add, acc, slot)
        return self._with_total_step(acc)

    def memory_bytes(self) -> int:
        base = self.estimator.memory_bytes()
        if self.window_epochs is None:
            return base
        # backing-epoch refill: the expanded total carries K extra
        # half-capacity backing slots per sample structure
        return (base * (1 + self.window_epochs)
                + self.backing_epochs * (base // 2))
