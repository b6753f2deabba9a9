"""The program's own spans, as the metric readers see them: the histogram
family ``sjpc_span_seconds{span=<path>}`` of the program's default
registry (``repro_torch.obs.metrics.default_registry()``).  The program
fills it only while a profiler records, so in a run it holds the traced
segment alone; a program without these spans leaves it absent, and every
reader then reads nothing."""
from __future__ import annotations

FAMILY = "sjpc_span_seconds"
ESTIMATES = ("sjpc.estimate_batch", "sjpc.estimate_join_batch")


def stat(path: str) -> tuple[int, float] | None:
    """(spans, their host seconds) of the spans at ``path``, or None."""
    from repro_torch.obs.metrics import default_registry
    h = default_registry().histogram(FAMILY, span=path)
    return (h.count, h.total) if h is not None and h.count else None


def mean_us(path: str) -> float | None:
    """The mean host microseconds of the spans at ``path``."""
    s = stat(path)
    return None if s is None else s[1] / s[0] * 1e6


def estimates_ms() -> tuple[float, float] | None:
    """(wait, host) milliseconds per job, a job being one
    ``sjpc.estimate_batch``: the two estimates' ``wait`` spans summed, and
    both estimates' spans less those waits."""
    spans = [stat(p) for p in ESTIMATES]
    waits = [stat(f"{p}/wait") for p in ESTIMATES]
    if None in spans or None in waits:
        return None
    jobs = spans[0][0]
    wait = sum(w[1] for w in waits)
    return wait / jobs * 1e3, (sum(s[1] for s in spans) - wait) / jobs * 1e3
