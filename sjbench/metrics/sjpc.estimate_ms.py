"""sjpc.estimate_ms: the mean host time of a job's estimation in the window,
from ``subtract`` to both tables on the host."""


def read(run):
    mean = run.span_mean("estimate")
    return None if mean is None else mean * 1e3
