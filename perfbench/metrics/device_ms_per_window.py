"""Trainer device window (``_dispatch_window``): the median over the run's
windows of ``TrainReport.window_device_s`` (CUDA events around a window's
launches, idle gaps between them included), in ms."""

import statistics


def read(run):
    s = run.report.window_device_s
    return statistics.median(s) * 1e3 if s else None
