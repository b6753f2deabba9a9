"""sjpc.estimate_wait_ms: the host time a traced job's two estimates spend
blocked on the card at their start, until the counters' stream has run the
job's queued work (the program's ``wait`` spans of ``estimate_batch`` and
``estimate_join_batch`` summed), per job: device work, not host work."""
from sjbench import program_spans


def read(run):
    ms = program_spans.estimates_ms()
    return None if ms is None else ms[0]
