"""ingest_roofline: the least time of the traced ``update_fused`` calls'
work (each call's draws and fused ingest, from its own inputs, by the
frozen formulas of ``sjbench/work.py``) over the device time of every
operation those calls launched, in percent."""


def read(run):
    calls = run.trace.ranges.get("update_fused") if run.trace else None
    bounds = run.bounds.get("update_fused")
    if not calls or not bounds:
        return None
    device_ms = sum(c.device_s for c in calls) * 1e3
    if device_ms <= 0:
        return None
    bound_ms = sum(bounds[i % len(bounds)] for i in range(len(calls)))
    return 100.0 * bound_ms / device_ms
