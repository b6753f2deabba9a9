"""sjpc.prepare_us: the mean host time of the ``prepare`` stage of the
traced ``update_fused`` calls (``_prepare``: the records widened to int64
field data, the key and the step), from the program's own span
``sjpc.update_fused/prepare`` (host clock, inside the program)."""
from sjbench import program_spans


def read(run):
    return program_spans.mean_us("sjpc.update_fused/prepare")
