"""Cache admits and writebacks, host part (``cache/manager.py``
``finish_prepare``): the median over the timed window's windows of the span
``cache.admit`` (the admits gathered from the host table, their copies and
scatters and the writeback gathers enqueued), in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "cache.admit")
