"""Cache admits' accumulators, host part (``cache/manager.py``
``finish_prepare`` under row-wise Adagrad on the device planner): the median
over the timed window's windows of the span ``cache.admit_accum`` (the
admits' accumulators gathered from the host store and their copies and
scatters enqueued, inside ``cache.admit``), in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "cache.admit_accum")
