"""sample_query_step_ms: the window's milliseconds over its completed steps
(one ingest round and one query, ending with the table on the host)."""


def read(run):
    return run.window_s * 1e3 / run.steps if run.steps else None
