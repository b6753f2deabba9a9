"""Observability of the port, ported from the JAX package's ``obs/``.

Three parts, composable and individually injectable:

  metrics.py   labeled counters / gauges / fixed-bucket latency
               histograms in a :class:`MetricsRegistry`; process-global
               default + Prometheus text / plain-dict export
  trace.py     nested :class:`Tracer` spans with wall *and* device time
               (``Span.sync`` waits for the registered tensors' device
               work before the clock stops), JSON-lines events, optional
               ``torch.profiler.record_function`` bracketing
  accuracy.py  :class:`AccuracyAuditor` -- opt-in sampled replay of
               queried windows through ``core/exact.py``, serving live
               rel-err and CI-coverage counters per estimator kind

:class:`Observability` bundles a registry + tracer (+ optional auditor)
for the service layers; ``Observability.disabled()`` is the shared no-op
bundle.

The kernel path (``core/sjpc.py``'s ``update_fused`` and batched
estimates) has a tracer of its own, ``trace.path_tracer()``, kept out of
``__all__`` (the export list matches the JAX package's): off by default,
armed while a ``torch.profiler`` records, or switched on by an operator
(``path_tracer().switch(True, sink=...)``, JSON-lines events).  Live, its
spans and their stages observe their host seconds into
``sjpc_span_seconds{span=<path>}`` of the default registry (a few
microseconds a span); off, a public call pays one profiler check and a
few no-op calls.
"""
from __future__ import annotations

import dataclasses

from .accuracy import AccuracyAuditor
from .metrics import (DEFAULT_BUCKETS, Histogram, MetricsRegistry,
                      NULL_REGISTRY, default_registry, set_default_registry)
from .trace import (NULL_SPAN, NULL_TRACER, Span, Tracer, default_tracer,
                    set_default_tracer)


@dataclasses.dataclass
class Observability:
    """The bundle the service threads through its layers."""

    metrics: MetricsRegistry
    tracer: Tracer
    auditor: AccuracyAuditor | None = None

    def span(self, name: str, *, histogram: str | None = None,
             labels: dict | None = None, **attrs):
        """A tracer span whose ``histogram=`` observation lands in THIS
        bundle's registry (device-time semantics, see trace.Span)."""
        return self.tracer.span(name, histogram=histogram, labels=labels,
                                registry=self.metrics, **attrs)

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    @classmethod
    def default(cls) -> "Observability":
        return cls(metrics=default_registry(), tracer=default_tracer())

    @classmethod
    def disabled(cls) -> "Observability":
        return _DISABLED


_DISABLED = Observability(metrics=NULL_REGISTRY, tracer=NULL_TRACER)

__all__ = [
    "AccuracyAuditor", "DEFAULT_BUCKETS", "Histogram", "MetricsRegistry",
    "NULL_REGISTRY", "NULL_SPAN", "NULL_TRACER", "Observability", "Span",
    "Tracer", "default_registry", "default_tracer", "set_default_registry",
    "set_default_tracer",
]
