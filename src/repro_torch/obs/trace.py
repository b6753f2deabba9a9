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

:func:`path_tracer` is the one process-global tracer of the kernel path
(``core/sjpc.py``'s ``update_fused`` and batched estimates).  It is off
unless something asks for it: while a ``torch.profiler.profile`` records
(``torch.autograd._profiler_enabled()``), or while an operator switches
it on (``path_tracer().switch(True, sink=<path or file>)``, the sink
optional and JSON-lines).  A public call opens one root span, which makes
the call's one liveness check; its stages (:meth:`PathSpan.stage`) check
nothing, and under the shared null span they do nothing.  A live span
observes its host seconds into the histogram family
``sjpc_span_seconds{span=<path>}`` of :func:`~.metrics.default_registry`;
while a profiler records (and only then) its body runs inside a profiler
range named ``<path>`` (the C++ ``_RecordFunctionFast`` range, a
``cpu_op`` in the trace); while switched on, it emits its event, whose
``ts`` is the Unix clock, as the profiler's Chrome trace stamps are.  Off,
a call pays one profiler check, one no-op ``with`` block and a no-op call
a stage; live, a few microseconds a span, so the operator switch is for
diagnosis, not steady serving.
"""
from __future__ import annotations

import collections
import json
import threading
import time

import torch

from .metrics import MetricsRegistry, default_registry

_EVENT_RING = 1024           # in-memory events kept per tracer
PATH_HISTOGRAM = "sjpc_span_seconds"


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


class PathSpan:
    """A live span of :func:`path_tracer` (use via ``PathTracer.span``): its
    host seconds go to ``sjpc_span_seconds{span=<path>}`` of the registry it
    was given, its event to the tracer while an operator has switched it on;
    while ``profiling``, its body runs inside a profiler range named
    ``path``.  :meth:`stage` splits the body into consecutive stages, each
    such a span of its own at ``<path>/<stage>``."""

    __slots__ = ("name", "path", "attrs", "_tracer", "_registry", "_profiling",
                 "_range", "_stage", "_t0", "_ts", "dispatch_s", "total_s")

    def __init__(self, tracer: "Tracer", registry: MetricsRegistry, name: str, path: str,
                 profiling: bool, attrs: dict):
        self.name = name
        self.path = path
        self.attrs = attrs
        self._tracer = tracer
        self._registry = registry
        self._profiling = profiling
        self._range = None
        self._stage = None

    def stage(self, name: str) -> None:
        """End the running stage, if any, and start ``name``: the part of
        the body up to the next stage or the span's end.  A stage is live as
        its span is, with no check of its own."""
        self._end_stage(None, None, None)
        self._stage = PathSpan(self._tracer, self._registry, name, f"{self.path}/{name}",
                               self._profiling, {})
        self._stage.__enter__()

    def _end_stage(self, *exc) -> None:
        if self._stage is not None:
            self._stage.__exit__(*exc)
            self._stage = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def wait(self, *tensors) -> None:
        """Block now until the current stream of every CUDA device that
        ``tensors`` live on has finished its queued work (host tensors wait
        for nothing)."""
        devices: set = set()
        _cuda_devices(tensors, devices)
        for device in devices:
            torch.cuda.current_stream(device).synchronize()

    def __enter__(self):
        if self._profiling:
            # the profiler's C++ range: about a tenth of record_function's
            # host cost under a recording profiler
            self._range = torch._C._profiler._RecordFunctionFast(self.path)
            self._range.__enter__()
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._end_stage(exc_type, exc, tb)
        self.dispatch_s = self.total_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            if self._tracer.enabled:
                self._tracer._emit(self)
            self._registry.observe(PATH_HISTOGRAM, self.total_s, span=self.path)
        return False


class _NullSpan:
    """Shared do-nothing span for disabled tracers (and an off path span,
    whose stages and waits do nothing)."""

    dispatch_s = 0.0
    total_s = 0.0
    attrs: dict = {}

    def sync(self, *tensors) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def stage(self, name: str) -> None:
        pass

    def wait(self, *tensors) -> None:
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


class PathTracer(Tracer):
    """The kernel path's tracer (see the module docstring): off by default,
    live while a ``torch.profiler`` records or while ``enabled`` is set."""

    def switch(self, enabled: bool, *, sink=None) -> None:
        """An operator's switch: live (or not) without a profiler, its
        events from now on to ``sink`` (a path, opened on the first event,
        or a file-like; None: the in-memory ring only).  A path sink opened
        before is closed."""
        self.close()
        self.enabled = enabled
        self._sink_path = sink if isinstance(sink, str) else None
        self._sink = None if isinstance(sink, str) else sink

    def span(self, name: str, **attrs):
        """A root :class:`PathSpan` of ``name`` when live, else the shared
        null span: the one liveness check of a public call."""
        profiling = torch.autograd._profiler_enabled()
        if not (self.enabled or profiling):
            return NULL_SPAN
        return PathSpan(self, default_registry(), name, name, profiling, attrs)


_PATH = PathTracer(enabled=False)


def path_tracer() -> PathTracer:
    """The process-global tracer of the kernel path."""
    return _PATH
