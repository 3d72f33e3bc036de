"""Trainer dispatch (``train/trainer.py`` ``_dispatch_window``): the median over
the timed window's windows of the span ``trainer.dispatch``, the host seconds
that enqueue a window's steps, in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "trainer.dispatch")
