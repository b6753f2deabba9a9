"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (sizes, guarantees, source);
* ``traffic/<traffic>.json``: the mix's parameters and its ``kind``;
* ``kinds/<kind>.py``: the driver of that kind of traffic (``Driver``);
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names no run may hold once its window has closed: the
# JAX stack, the JAX package and its benchmark runner.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# Seconds of steady work the traced run profiles after its window.
TRACE_SECONDS = 2.0


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, imported by its path."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"sjbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and traffic."""

    def __init__(self, spec: dict, name, config_overrides: dict | None = None,
                 traffic_overrides: dict | None = None):
        """``name`` is a workload of ``spec``, or a workload entry itself
        (a cell that ``spec`` does not list, as the tests drive)."""
        if isinstance(name, dict):
            entry = name
        else:
            entries = {w["name"]: w for w in spec["workloads"]}
            if name not in entries:
                raise KeyError(f"no workload {name!r} in BENCHMARK.json")
            entry = entries[name]
        self.spec, self.name, self.entry = spec, entry["name"], entry
        self.chips = int(self.entry["chips"])
        self.config = load_json("configs", self.entry["config"])
        self.config.update(config_overrides or {})
        self.traffic = load_json("traffic", self.entry["traffic"])
        self.traffic.update(traffic_overrides or {})

    def metrics(self, section: str) -> list[dict]:
        """The metrics of ``section`` ('end_to_end' or 'per_layer') this cell
        reports: those that list it, or, without a list, every cell (an end-
        to-end metric) or every cell reporting the metric it moves."""
        e2e = [m for m in self.spec["end_to_end"] if self.reports(m, None)]
        if section == "end_to_end":
            return e2e
        return [m for m in self.spec[section] if self.reports(m, {m["name"] for m in e2e})]

    def reports(self, metric: dict, e2e: set | None) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return e2e is None or metric.get("moves") in e2e


class Run:
    """What the metric readers read: the window's spans and counts, the
    traced segment, the driver's work bounds."""

    def __init__(self):
        self.spans = tracing.Spans()
        self.counts: dict[str, float] = {}
        self.window_spans: dict[str, list[float]] = {}
        self.setup_s = 0.0
        self.window_s = 0.0
        self.steps = 0
        self.trace: tracing.Trace | None = None
        self.bounds: dict[str, list[float]] = {}

    def span_mean(self, name: str) -> float | None:
        vals = self.window_spans.get(name)
        return sum(vals) / len(vals) if vals else None


def loop(driver, seconds: float) -> tuple[int, float]:
    """Steps of ``driver`` back to back until ``seconds`` have passed: (the
    steps, the seconds they took)."""
    steps = 0
    t0 = time.perf_counter()
    while True:
        driver.step()
        steps += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return steps, elapsed


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among ``names`` (default: the modules
    this process holds), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({exc})"


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> tuple[dict, Run]:
    """Run ``cell`` once on ``device``; return (the result line's object,
    the run)."""
    run = Run()
    kind = load_module("kinds", cell.traffic["kind"])
    on_cuda = torch.device(device).type == "cuda"
    driver = kind.Driver(cell, seed, device, run.spans)
    if on_cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.spans.times.clear()
    run.setup_s = time.perf_counter() - t_start
    run.steps, run.window_s = loop(driver, seconds)
    run.counts = dict(driver.counts)
    run.window_spans = {k: list(v) for k, v in run.spans.times.items()}
    if traced and on_cuda:
        run.spans.times.clear()
        run.spans.profiling = True
        window, prof = tracing.profiled(lambda: loop(driver, min(TRACE_SECONDS, seconds)))
        run.spans.profiling = False
        t_read = time.perf_counter()
        run.trace = tracing.read(prof, window)
        del prof
        log(f"trace: read in {time.perf_counter() - t_read:.3f} s")
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    driver.release()
    t_check = time.perf_counter()
    checks, attempted, failed = driver.check()
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    run.bounds = driver.bounds()
    correct = all(v <= lim for v, lim in checks.values())
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = load_module("metrics", m["name"]).read(run)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops,
                               "idle_gaps": run.trace.idle_gaps}
        log(f"trace: {run.trace.device_ops} device ops, {run.trace.unattributed} launched "
            f"outside the spans; ranges "
            + ", ".join(f"{k} x{len(v)}" for k, v in run.trace.ranges.items()))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, run


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    cell = Cell(load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"card: {card_line()}")
    # one host thread for the program's few CPU-side ops: the run's host
    # work, which paces the host-bound parts, then varies less
    torch.set_num_threads(1)
    result, run = execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        log(f"the process holds forbidden modules: {', '.join(found)}")
        return 3
    log(f"{cell.name} seed {args.seed}: {run.steps} steps in {run.window_s:.3f} s, "
        f"set-up {run.setup_s:.3f} s")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
