"""ingest.launches_per_call: device operations (kernels, copies, sets)
launched inside each ``update_fused`` call of the traced segment, per call."""


def read(run):
    calls = run.trace.ranges.get("update_fused") if run.trace else None
    return sum(c.launches for c in calls) / len(calls) if calls else None
