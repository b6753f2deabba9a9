"""reservoir.ingest_device_ms: the device time of the operations each traced
``ingest_rounds`` call launched, per step."""


def read(run):
    calls = run.trace.ranges.get("ingest_rounds") if run.trace else None
    return sum(c.device_s for c in calls) / len(calls) * 1e3 if calls else None
