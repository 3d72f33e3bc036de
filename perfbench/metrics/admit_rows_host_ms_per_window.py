"""Cache admits' rows, host part (``cache/manager.py`` ``finish_prepare`` on
the device planner): the median over the timed window's windows of the span
``cache.admit_rows`` (each chunk's admitted rows gathered from the host
table by one multithreaded native pass into the window's pinned buffer,
the wait for the host table's lock included; inside ``cache.admit``), in
ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "cache.admit_rows")
