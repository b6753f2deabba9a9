"""sjpc.ingest_us: the mean host time of the ``ingest`` stage of the traced
``update_fused`` calls (``ops.fused_ingest``: the records narrowed to
words, the checks and the launch; then ``advance``), from the program's
own span ``sjpc.update_fused/ingest`` (host clock, inside the program)."""
from sjbench import program_spans


def read(run):
    return program_spans.mean_us("sjpc.update_fused/ingest")
