"""Trainer host window, its data part (``train/trainer.py``): the median over
the timed window's windows of the spans ``trainer.fetch`` (the batches pulled)
and ``trainer.stage`` (ids concatenated, dense features and labels stacked
and copied to the card), in ms."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms(run, "trainer.fetch", "trainer.stage")
