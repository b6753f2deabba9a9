"""Nested spans with wall *and* device time, JSON-lines trace events, and
optional ``torch.profiler`` annotation, ported from the JAX package's
``obs/trace.py``.

CUDA launches are asynchronous, so ``t1 - t0`` around a call that
launches kernels times the *enqueue*, not the compute.  A :class:`Span`
records two durations:

  ``dispatch_s``   t(body exit) - t(enter): host time to build and
                   enqueue the work (plus any synchronous host compute)
  ``total_s``      the same interval measured after waiting for the
                   device work of every tensor the body registered via
                   :meth:`Span.sync` -- device-inclusive time, the number
                   a latency objective is about

A span whose body does no device work has ``total_s == dispatch_s``; a
span around kernel launches shows the gap.  Registered tensors that all
live on the CPU wait for nothing.

Spans nest (a thread-local stack); each close emits one JSON-lines event
``{"name", "path", "ts", "dispatch_ms", "total_ms", "depth", ...attrs}``
to the configured sink (a path or file-like) and into a bounded
in-memory ring (:attr:`Tracer.events`).  With ``annotate=True`` every span
body also runs inside ``torch.profiler.record_function(path)``, so the
service's stages appear as named regions in a ``torch.profiler`` trace.

Spans observe their ``total_s`` into a :class:`MetricsRegistry` latency
histogram when given one (``histogram=``), which is how every
``*_seconds`` histogram of the service carries device-time semantics.

Disabled tracers hand out one shared no-op span: no allocation, no clock
reads.
"""
from __future__ import annotations

import collections
import json
import threading
import time

import torch

from .metrics import MetricsRegistry

_EVENT_RING = 1024           # in-memory events kept per tracer


def _cuda_devices(tree, out: set) -> None:
    """Add the CUDA device of every tensor in ``tree`` (tensors, and
    NamedTuples, tuples, lists and dicts of them) to ``out``."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _cuda_devices(leaf, out)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            _cuda_devices(leaf, out)


class Span:
    """One timed region.  Use via ``Tracer.span`` (context manager)."""

    __slots__ = ("name", "path", "attrs", "_tracer", "_registry",
                 "_histogram", "_labels", "_sync", "_t0", "_ts",
                 "dispatch_s", "total_s", "_annotation")

    def __init__(self, tracer: "Tracer", registry: MetricsRegistry,
                 name: str, path: str, histogram: str | None, labels: dict,
                 attrs: dict):
        self.name = name
        self.path = path
        self.attrs = attrs
        self._tracer = tracer
        self._registry = registry
        self._histogram = histogram
        self._labels = labels
        self._sync: set = set()
        self._annotation = None

    def sync(self, *tensors) -> None:
        """Register outputs whose device work must finish before the clock
        stops: the span's ``total_s`` then covers their compute (NamedTuples
        and other containers are walked; None and host values are
        ignored)."""
        _cuda_devices(tensors, self._sync)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    # -- context manager ------------------------------------------------
    def __enter__(self):
        self._tracer._stack().append(self.name)
        if self._tracer.annotate:
            self._annotation = torch.profiler.record_function(self.path)
            self._annotation.__enter__()
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dispatch_s = time.perf_counter() - self._t0
        if self._sync and exc_type is None:
            for device in self._sync:
                torch.cuda.synchronize(device)
        self.total_s = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is None:
            self._tracer._emit(self)
            if self._histogram:
                self._registry.observe(
                    self._histogram, self.total_s, **self._labels)
        return False


class _NullSpan:
    """Shared do-nothing span for disabled tracers."""

    dispatch_s = 0.0
    total_s = 0.0
    attrs: dict = {}

    def sync(self, *tensors) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + JSON-lines event sink.

    ``sink`` is a filesystem path (opened append, line-buffered on first
    event) or any object with ``write``.  ``registry`` receives the
    ``histogram=`` observations of spans (defaults to a throwaway
    disabled registry; the service injects its own)."""

    def __init__(self, *, sink=None, enabled: bool = True,
                 annotate: bool = False,
                 registry: MetricsRegistry | None = None):
        self.enabled = enabled
        self.annotate = annotate
        self.registry = registry if registry is not None else \
            MetricsRegistry(enabled=False)
        self.events: collections.deque = collections.deque(maxlen=_EVENT_RING)
        self._sink_path = sink if isinstance(sink, str) else None
        self._sink = sink if (sink is not None
                              and not isinstance(sink, str)) else None
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def span(self, name: str, *, histogram: str | None = None,
             labels: dict | None = None,
             registry: MetricsRegistry | None = None, **attrs):
        """Open a nested span.  ``histogram``/``labels`` route the span's
        device-inclusive duration into ``registry`` (default: the
        tracer's own); ``attrs`` ride the trace event verbatim."""
        if not self.enabled:
            return NULL_SPAN
        path = "/".join(self._stack() + [name])
        return Span(self, registry if registry is not None else self.registry,
                    name, path, histogram, labels or {}, attrs)

    def _emit(self, span: Span) -> None:
        event = {"name": span.name, "path": span.path,
                 "ts": round(span._ts, 6),
                 "dispatch_ms": round(1e3 * span.dispatch_s, 4),
                 "total_ms": round(1e3 * span.total_s, 4),
                 "depth": span.path.count("/")}
        event.update(span.attrs)
        self.events.append(event)
        with self._lock:
            if self._sink is None and self._sink_path is not None:
                self._sink = open(self._sink_path, "a", buffering=1)
            if self._sink is not None:
                self._sink.write(json.dumps(event, default=str) + "\n")

    def close(self) -> None:
        with self._lock:
            if self._sink is not None and self._sink_path is not None:
                self._sink.close()
                self._sink = None


NULL_TRACER = Tracer(enabled=False)
_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT


def set_default_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests); returns the previous."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tracer
    return prev
