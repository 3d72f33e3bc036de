"""Cache planner readback (``train/trainer.py`` ``train``): the median over the
timed window's windows of the span ``cache.readback_wait``, the host blocked
until the plan's readback has landed, in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "cache.readback_wait")
