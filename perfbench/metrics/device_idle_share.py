"""Device: the share of the timed window in which the card ran nothing.
Busy seconds a step are read from the trace (the union of the card's
kernel, copy and fill intervals over the traced steps, a step being one
Kernel 1 launch) and set against the timed window's seconds a step: the
traced windows' own length is stretched by the profiler's host cost, so
``1 - busy / traced span`` (``trace.idle_share``, which the result's
``device`` block gives as ``busy_s`` and ``window_s``) reads high."""

from perfbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    steps, _ = trace.kernel_time(run.trace, "gather_rows")
    if not steps:
        return None
    return 1.0 - (trace.busy_seconds(run.trace) / steps) / (run.seconds / run.steps)
