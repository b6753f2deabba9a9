"""pairs_roofline: the least time of the traced queries' pair histograms
(each sample's and each bootstrap replicate's, by the frozen formulas of
``sjbench/work.py``) over the device time of every operation the
``estimate_batch`` calls launched, in percent."""


def read(run):
    calls = run.trace.ranges.get("estimate_batch") if run.trace else None
    bounds = run.bounds.get("estimate_batch")
    if not calls or not bounds:
        return None
    device_ms = sum(c.device_s for c in calls) * 1e3
    if device_ms <= 0:
        return None
    bound_ms = sum(bounds[i % len(bounds)] for i in range(len(calls)))
    return 100.0 * bound_ms / device_ms
