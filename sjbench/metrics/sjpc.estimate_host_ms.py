"""sjpc.estimate_host_ms: the host time of a traced job's two estimates
(the program's ``estimate_batch`` and ``estimate_join_batch`` spans) less
their ``wait`` spans, per job: the host's own tail once the card has run
the job's ingest, while the card idles but for the estimates' small ops."""
from sjbench import program_spans


def read(run):
    ms = program_spans.estimates_ms()
    return None if ms is None else ms[1]
