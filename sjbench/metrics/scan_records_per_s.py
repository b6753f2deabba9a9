"""scan_records_per_s: the records of every job completed in the window,
over the window's seconds (host clock; each job ends with its tables on
the host)."""


def read(run):
    records = run.counts.get("records")
    return records / run.window_s if records else None
