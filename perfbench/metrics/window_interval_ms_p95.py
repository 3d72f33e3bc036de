"""Whole step: the 95th percentile, in ms, of the host-clock time from one
training window's first batch pull to the next over the timed window.
The cell's pace is the host's, and the host's speed varies from minute to
minute and from process to process, so this tail is read per layer."""

from perfbench import stats


def read(run):
    iv = run.window_intervals
    return stats.percentile(iv, 95) * 1e3 if iv else None
