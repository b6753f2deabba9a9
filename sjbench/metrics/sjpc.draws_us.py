"""sjpc.draws_us: the mean host time of the ``draws`` stage of the traced
``update_fused`` calls (``ops.sample_weights``: its argument conversions
and its launch), from the program's own span ``sjpc.update_fused/draws``
(host clock, inside the program)."""
from sjbench import program_spans


def read(run):
    return program_spans.mean_us("sjpc.update_fused/draws")
