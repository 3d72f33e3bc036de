"""Cache planner, host part (``cache/manager.py`` ``begin_prepare``): the median
over the timed window's windows of the span ``cache.plan_host`` (the ids'
range check, their copy, the plan, remap and readback enqueued), in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "cache.plan_host")
