"""sjpc.enqueue_us: the mean host time of one ``update_fused`` call in the
window (host clock, no synchronise: what the host spends to enqueue it)."""


def read(run):
    mean = run.span_mean("update_fused")
    return None if mean is None else mean * 1e6
