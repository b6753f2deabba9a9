"""reservoir.query_host_ms: a query's mean latency in the window minus the
mean device time of the operations a traced query launched: the copies
back, the bootstrap's keys and the numpy table while the card waits."""


def read(run):
    latency = run.span_mean("estimate_batch")
    calls = run.trace.ranges.get("estimate_batch") if run.trace else None
    if latency is None or not calls:
        return None
    return (latency - sum(c.device_s for c in calls) / len(calls)) * 1e3
