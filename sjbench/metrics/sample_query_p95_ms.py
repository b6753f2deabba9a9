"""sample_query_p95_ms: the 95th percentile of every query's latency in the
window, from the ``estimate_batch`` call to the table on the host (host
clock; linear interpolation between order statistics)."""
import numpy as np


def read(run):
    lat = run.window_spans.get("estimate_batch")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
