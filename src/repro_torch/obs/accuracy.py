"""Accuracy telemetry: sampled exact replay of queried windows, ported
from the JAX package's ``obs/accuracy.py`` (host numpy, unchanged).

The paper's Figs. 4/8 accuracy story -- relative error and bound coverage
per estimator -- is pinned offline by tests and benchmarks, but a served
system should *measure* it on live traffic: drifting workloads (skew,
cluster structure, window churn) move the error in ways a seeded
regression suite cannot see.  The :class:`AccuracyAuditor` turns that
story into a live signal:

* **Mirror** (opt-in, the memory cost of auditing): ``record`` keeps the
  raw record batches of each stream's live window, rotated in lockstep
  with the window's epochs, so the auditor can reconstruct exactly the
  data behind any snapshot.
* **Sampled replay**: at rate ``rate`` per polled query, the mirrored
  window is pushed through the estimator kind's declared
  ``exact_oracle`` (``EstimatorSpec``; for the pairwise
  kinds that is ``core/exact.py``'s O(2^d n) group-by oracle -- exact,
  not an estimate) and compared to the served
  :class:`~repro_torch.service.query.QueryResult`:

    ``accuracy_rel_err{kind,s}``        histogram of |est - g|/max(g, 1)
    ``accuracy_audits_total{kind}``     audited query count
    ``accuracy_ci_covered_total{kind}`` audits whose 95% CI covered g

  CI-coverage over time *is* the served calibration curve: for
  "analytic" bars it should sit at/above 95% (the bounds are
  conservative), for bootstrap bars near it.
* **Honesty guards**: streams fed by ``ingest_state_delta`` (no raw
  records to mirror) are marked unauditable; windows whose mirrored
  record count disagrees with the served ``n`` (a mirror bug, never
  silent), windows above ``max_records`` (the exact oracle is
  quadratic in lattice width, not free), and kinds whose spec declares
  no exact oracle (a plugin estimating something the replay cannot
  check) skip with a reason-labeled ``accuracy_audit_skipped_total``
  counter instead of lying.

Sampling uses a dedicated seeded generator, so audit cost is
deterministic per workload and replayable in tests (rate=1 audits
everything).
"""
from __future__ import annotations

import numpy as np

from .metrics import MetricsRegistry


class AccuracyAuditor:
    def __init__(self, registry: MetricsRegistry, *, rate: float,
                 max_records: int = 65536, seed: int = 0xA0D17):
        assert 0.0 <= rate <= 1.0, f"audit rate must be in [0, 1]: {rate}"
        self.registry = registry
        self.rate = rate
        self.max_records = max_records
        self._rng = np.random.default_rng(seed)
        # per stream: list of epochs (open epoch last), each a list of
        # record batches -- the window mirror
        self._epochs: dict[str, list[list[np.ndarray]]] = {}
        self._window: dict[str, int | None] = {}
        self._blocked: set[str] = set()

    # -- mirror maintenance (driven by the service) ---------------------
    def record(self, name: str, records: np.ndarray,
               window_epochs: int | None) -> None:
        """Mirror one ingested batch into ``name``'s open epoch."""
        self._window[name] = window_epochs
        eps = self._epochs.setdefault(name, [[]])
        eps[-1].append(np.asarray(records))

    def advance_epoch(self, name: str) -> None:
        """Rotate the mirror with the stream's window: open a new epoch,
        drop epochs the ring expired (the window keeps the open epoch
        plus window_epochs - 1 closed ones)."""
        eps = self._epochs.setdefault(name, [[]])
        eps.append([])
        w = self._window.get(name)
        if w is not None and len(eps) > w:
            del eps[:len(eps) - w]

    def mark_unauditable(self, name: str) -> None:
        """Streams ingesting pre-sketched state deltas carry no raw
        records; exact replay is impossible and must say so."""
        self._blocked.add(name)

    def live_records(self, name: str) -> np.ndarray | None:
        batches = [b for ep in self._epochs.get(name, []) for b in ep]
        if not batches:
            return None
        return np.concatenate(batches)

    # -- audit ----------------------------------------------------------
    def _skip(self, reason: str) -> None:
        self.registry.inc("accuracy_audit_skipped_total", reason=reason)

    def _mirror(self, name: str, n_served: float) -> np.ndarray | None:
        if name in self._blocked:
            self._skip("state_delta_stream")
            return None
        recs = self.live_records(name)
        if recs is None:
            self._skip("no_mirror")
            return None
        if recs.shape[0] > self.max_records:
            self._skip("window_too_large")
            return None
        if recs.shape[0] != int(round(n_served)):
            # the served window and the mirror disagree -- audit would
            # compare against the wrong population; fail loudly in the
            # metrics rather than emit a bogus rel-err
            self._skip("mirror_mismatch")
            return None
        return recs

    def _observe(self, result, g_exact: float, kind: str) -> None:
        rel = abs(result.estimate - g_exact) / max(g_exact, 1.0)
        self.registry.observe("accuracy_rel_err", rel, kind=kind,
                              s=str(result.s))
        self.registry.inc("accuracy_audits_total", kind=kind)
        lo, hi = result.ci(1.96)
        if lo <= g_exact <= hi:
            self.registry.inc("accuracy_ci_covered_total", kind=kind)

    def _oracle_for(self, kind: str):
        """The estimator kind's exact-replay oracle from its spec;
        ``None`` when the kind declares none (or is
        unregistered) -- the audit skips with a reason instead of
        replaying an estimand the kind does not estimate."""
        from .. import estimators
        try:
            return estimators.spec(kind).exact_oracle
        except KeyError:
            return None

    def maybe_audit(self, result, kind: str) -> bool:
        """Sampled audit of one served result: a QueryResult or an
        all-thresholds dict (one replay covers every threshold).  Returns
        whether an audit ran (tests drive this with rate=1)."""
        if self.rate <= 0.0 or self._rng.random() >= self.rate:
            return False
        results = list(result.values()) if isinstance(result, dict) \
            else [result]
        if not results:
            return False
        r0 = results[0]
        oracle = self._oracle_for(kind)
        if oracle is None:
            self._skip("no_exact_oracle")
            return False
        records = []
        for i, name in enumerate(r0.streams):
            recs = self._mirror(name, r0.n[i])
            if recs is None:
                return False
            records.append(recs)
        # one exact replay answers every threshold of the dict
        g_of_s = oracle(r0.kind, tuple(records))
        for r in results:
            self._observe(r, g_of_s(r.s), kind)
        return True
