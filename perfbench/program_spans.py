"""What the readers of the program's own spans read: ``TrainReport.
window_spans``, the host seconds of each of the timed window's windows by
span name (``cachedembedding_tpu_torch/utils/spans.py``), and the span
records that a traced run's profiler holds beside the card's operations.
Each returns None where the program recorded no such span, as a program
without spans records none."""

from __future__ import annotations

import statistics
from typing import Optional

from perfbench import trace


def median_ms(run, *names: str) -> Optional[float]:
    """The median over the timed window's windows of ``names``' summed host
    seconds (a window without one counting 0), in ms."""
    ws = getattr(run.report, "window_spans", None)
    if not ws or not any(n in w for w in ws for n in names):
        return None
    return statistics.median(sum(w.get(n, 0.0) for n in names) for w in ws) * 1e3


def idle_outside(run, name: str) -> Optional[float]:
    """Of the card's idle time between its busy intervals in the traced
    windows, the share that no host span ``name`` covers."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    held = trace.busy_intervals([o for o in tr.host if o[0] == name])
    busy = trace.busy_intervals(tr.device)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    idle = sum(b - a for a, b in gaps)
    if not held or idle <= 0:
        return None
    inside = sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in held)
    return 1.0 - inside / idle
