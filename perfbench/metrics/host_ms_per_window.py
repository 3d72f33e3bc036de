"""Trainer host window (``train/trainer.py``: data, host planner, staging,
wire): the median over the run's windows of ``TrainReport.window_host_s``,
in ms. The median, so that the traced part of the run, where the profiler
adds host time, moves it little."""

import statistics


def read(run):
    s = run.report.window_host_s
    return statistics.median(s) * 1e3 if s else None
