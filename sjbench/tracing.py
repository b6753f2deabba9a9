"""Spans on the host clock, and the device trace of a profiled segment.

:class:`Spans` times the benchmark's own calls into the program with
``time.perf_counter`` (no synchronise: a span that ends before the card
does measures what the host spent).  Inside :func:`profiled`, each span is
also a ``torch.profiler.record_function`` range, and :func:`read` turns the
profiler's trace into a :class:`Trace`: every device operation (kernel,
copy, set) with its time, the range whose host code launched it (by the
launch's correlation id), the union of the device's busy time, and the
idle gaps with what the host was doing meanwhile.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

RANGE_PREFIX = "sjbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Durations (s) of named calls, and, while ``profiling``, a profiler
    range around each."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(RANGE_PREFIX + name) if self.profiling else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.times[name].append(dt)


@dataclasses.dataclass
class RangeStat:
    """The device operations one span launched: their time and count."""
    device_s: float = 0.0
    launches: int = 0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ranges: dict            # name -> [RangeStat] in order
    top_ops: list           # [[name, seconds]] by total device time
    idle_gaps: list         # [[host activity, seconds]] by total idle time
    device_ops: int
    unattributed: int       # device ops whose launch lay in no range


def profiled(run_segment):
    """Run ``run_segment()`` under ``torch.profiler`` (host and device
    activity) between two synchronises; return (the segment's host-clock
    seconds, the profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_segment()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return window, prof


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, window_s: float, top: int = 10) -> Trace:
    """The :class:`Trace` of a profiled segment of ``window_s`` seconds."""
    evs = [e for e in _events(prof) if e.get("ph") == "X"]
    ops = [e for e in evs if e.get("cat") in DEVICE_CATS]
    ranges = sorted((e for e in evs if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(RANGE_PREFIX)), key=lambda e: e["ts"])
    host = [e for e in evs if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                                "cuda_driver")]
    launch = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    stats = {id(r): RangeStat() for r in ranges}
    by_name = defaultdict(list)
    for r in ranges:
        by_name[r["name"][len(RANGE_PREFIX):]].append(stats[id(r)])
    starts = [r["ts"] for r in ranges]
    unattributed = 0
    for op in ops:
        ln = launch.get(op.get("args", {}).get("correlation"))
        owner = None
        if ln is not None:
            # the spans wrap single calls and never nest: the latest range
            # that starts before the launch holds it, if it has not ended
            i = bisect.bisect_right(starts, ln["ts"]) - 1
            if i >= 0 and ln["ts"] <= ranges[i]["ts"] + ranges[i]["dur"] \
                    and ranges[i].get("tid") == ln.get("tid"):
                owner = ranges[i]
        if owner is None:
            unattributed += 1
            continue
        st = stats[id(owner)]
        st.device_s += op["dur"] / 1e6
        st.launches += 1
    busy = _union((op["ts"], op["ts"] + op["dur"]) for op in ops)
    busy_s = sum(e - s for s, e in busy) / 1e6
    per_op = defaultdict(float)
    for op in ops:
        per_op[op["name"]] += op["dur"] / 1e6
    top_ops = sorted(([k[:120], v] for k, v in per_op.items()), key=lambda kv: -kv[1])[:top]
    gaps = defaultdict(float)
    host_sorted = sorted(host, key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host_sorted]
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        label = "other host work"
        i = bisect.bisect_right(host_starts, mid) - 1
        # the innermost host event covering the gap's middle
        best = None
        for j in range(i, max(i - 200, -1), -1):
            h = host_sorted[j]
            if h["ts"] <= mid <= h["ts"] + h["dur"]:
                if best is None or h["dur"] < best["dur"]:
                    best = h
        if best is not None:
            label = best["name"][:120]
        gaps[label] += (s1 - e0) / 1e6
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]
    return Trace(window_s=window_s, busy_s=busy_s, ranges=dict(by_name), top_ops=top_ops,
                 idle_gaps=idle, device_ops=len(ops), unattributed=unattributed)
