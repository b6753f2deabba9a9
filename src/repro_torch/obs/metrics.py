"""Metrics core, copied from the JAX package's ``obs/metrics.py`` (which
imports no jax): labeled counters, gauges, and fixed-bucket latency
histograms in an injectable :class:`MetricsRegistry`.

* **Counters** -- monotone totals (``inc``): kernel dispatches per
  implementation (``kernel_dispatch_total{kernel, impl}``), bootstrap
  replicates (``bootstrap_replicates_total{method}``).
* **Gauges** -- last-written values (``set``; ``set_max`` keeps the
  high-water mark).
* **Histograms** -- fixed log-spaced buckets (``observe``) with
  p50/p95/p99 read-out.

Every series is keyed by (family name, sorted label items); families are
created on first write.  Every mutator begins with a single ``enabled``
check and returns at once when the registry is disabled.  One
process-global default registry (:func:`default_registry`) serves call
sites with no handle of their own (kernel dispatch, bootstrap replicates).
"""
from __future__ import annotations

import math
import threading

# Log-spaced latency buckets (seconds): 10us .. 10s, ~2.5x steps.  The
# same geometry works for the accuracy auditor's relative errors (ratios
# in [0, ~10]); +inf is implicit (the overflow bucket).
DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _parse_labels(s: str) -> tuple:
    """Inverse of :func:`_fmt_labels` for the collect() label strings
    (``_`` = no labels).  Label values never contain quotes or commas in
    this codebase (stream/group/kind names), so a split suffices."""
    if s in ("", "_"):
        return ()
    if not (s.startswith("{") and s.endswith("}")):
        raise ValueError(f"unparseable label string {s!r}")
    out = []
    for part in s[1:-1].split(","):
        k, _, v = part.partition("=")
        out.append((k, v.strip('"')))
    return tuple(out)


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + sum + count."""

    __slots__ = ("bounds", "counts", "overflow", "total", "count")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)
        self.overflow = 0
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.count += 1
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                return
        self.overflow += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolved quantile: the upper bound of the bucket holding
        the q-th observation (0 when empty; the last finite bound for
        overflow mass) -- the standard Prometheus-style read-out, biased
        at most one bucket width."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.bounds[i]
        return self.bounds[-1]


class MetricsRegistry:
    """Process-local metric store.  Injectable (the service takes one);
    :func:`default_registry` is the shared fallback for module-level
    instrumentation (kernel dispatch counts, bootstrap replicates)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, Histogram]] = {}

    # -- mutators (each starts with the one-branch disabled check) ------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        key = _labelkey(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            fam[key] = fam.get(key, 0.0) + value

    def set(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges.setdefault(name, {})[_labelkey(labels)] = float(value)

    def set_max(self, name: str, value: float, **labels) -> None:
        """Gauge that only moves up: high-water marks (peak queue depth)."""
        if not self.enabled:
            return
        key = _labelkey(labels)
        with self._lock:
            fam = self._gauges.setdefault(name, {})
            fam[key] = max(fam.get(key, -math.inf), float(value))

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = _labelkey(labels)
        with self._lock:
            fam = self._hists.setdefault(name, {})
            h = fam.get(key)
            if h is None:
                h = fam[key] = Histogram()
            h.observe(value)

    # -- readers (always live; a disabled registry just stays empty) ----
    def counter(self, name: str, **labels) -> float:
        return self._counters.get(name, {}).get(_labelkey(labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter family over all label sets."""
        return sum(self._counters.get(name, {}).values())

    def gauge(self, name: str, **labels) -> float | None:
        return self._gauges.get(name, {}).get(_labelkey(labels))

    def histogram(self, name: str, **labels) -> Histogram | None:
        return self._hists.get(name, {}).get(_labelkey(labels))

    def quantile(self, name: str, q: float, **labels) -> float:
        h = self.histogram(name, **labels)
        return h.quantile(q) if h is not None else 0.0

    def series(self, name: str) -> dict[tuple, float]:
        """Every (labelkey -> value) of a counter or gauge family."""
        if name in self._counters:
            return dict(self._counters[name])
        return dict(self._gauges.get(name, {}))

    def collect(self) -> dict:
        """Plain-dict snapshot: {family: {label-string: value}}; histograms
        flatten to count/sum/p50/p95/p99 (the benchmark emit format)."""
        out: dict = {}
        with self._lock:
            for name, fam in self._counters.items():
                out[name] = {_fmt_labels(k) or "_": v for k, v in fam.items()}
            for name, fam in self._gauges.items():
                out[name] = {_fmt_labels(k) or "_": v for k, v in fam.items()}
            for name, fam in self._hists.items():
                out[name] = {
                    _fmt_labels(k) or "_": {
                        "count": h.count, "sum": h.total,
                        "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                        "p99": h.quantile(0.99)}
                    for k, h in fam.items()}
        return out

    def absorb(self, collected: dict, **labels) -> None:
        """Fold another registry's :meth:`collect` snapshot into this one
        (a coordinator's per-worker aggregation).  ``labels`` are appended
        to every absorbed series (``worker="2"``), so re-absorbing a newer snapshot from the same
        source *overwrites* rather than double-counts: every absorbed
        value lands as a gauge (scrape semantics -- the worker's counters
        stay cumulative on the worker).  Flattened histograms land as
        ``name:count/sum/p50/p95/p99`` gauges."""
        if not self.enabled:
            return
        extra = _labelkey(labels)
        with self._lock:
            for name, fam in collected.items():
                if not isinstance(fam, dict):
                    continue
                for labelstr, value in fam.items():
                    key = tuple(sorted(_parse_labels(labelstr) + extra))
                    if isinstance(value, dict):     # flattened histogram
                        for stat, v in value.items():
                            self._gauges.setdefault(
                                f"{name}:{stat}", {})[key] = float(v)
                    else:
                        self._gauges.setdefault(name, {})[key] = float(value)

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (counters get a _total
        suffix if they lack one; histograms emit cumulative _bucket /
        _sum / _count series)."""
        lines: list[str] = []
        with self._lock:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(self._counters[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                for key, v in sorted(self._gauges[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for key, h in sorted(self._hists[name].items()):
                    cum = 0
                    for bound, c in zip(h.bounds, h.counts):
                        cum += c
                        lk = _fmt_labels(key + (("le", f"{bound:g}"),))
                        lines.append(f"{name}_bucket{lk} {cum}")
                    lk = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lk} {h.count}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {h.total:g}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_DEFAULT = MetricsRegistry(enabled=True)
NULL_REGISTRY = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    """The process-global registry (kernel/estimator instrumentation and
    the service's default sink)."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev
