"""Reduction of a device trace to the numbers the per-layer metrics read.

A trace is two lists of ``(name, start_s, end_s)``: the device's operations
(kernels, copies, fills) and the host's (torch operations and the
benchmark's own spans). ``from_profiler`` takes them from a
``torch.profiler`` run; the arithmetic below takes any such lists, so the
tests can hand it a trace made by hand.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

from perfbench import roofline

Op = Tuple[str, float, float]
# device-side waits, and the host's annotations mirrored on the device's
# timeline (the benchmark's spans, the profiler's steps): not work
_NOT_WORK = re.compile(r"sync|wait|^bench\.|^ProfilerStep", re.IGNORECASE)


class Trace(NamedTuple):
    device: List[Op]
    host: List[Op]
    spans: List[Op]  # the benchmark's own spans, a subset of ``host``


def from_profiler(prof) -> Trace:
    """The device and host operations of a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        op = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not _NOT_WORK.search(e.name):
                device.append(op)
        elif e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            host.append(op)
            if e.name.startswith("bench."):
                spans.append(op)
    return Trace(device, host, spans)


def window(trace: Trace) -> Tuple[float, float]:
    """The traced window: from the first to the last operation, host or device."""
    ops = trace.device + trace.host
    return min(o[1] for o in ops), max(o[2] for o in ops)


def busy_intervals(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in busy_intervals(trace.device))


def idle_share(trace: Trace) -> Optional[float]:
    """1 - busy seconds over the traced window's length; None without device work."""
    if not trace.device:
        return None
    lo, hi = window(trace)
    return 1.0 - busy_seconds(trace) / (hi - lo) if hi > lo else None


def kernel_time(trace: Trace, kernel: str) -> Tuple[int, float]:
    """(launches, seconds) of the device operations that belong to ``kernel``
    (``roofline.kernel_of``)."""
    n, s = 0, 0.0
    for name, a, b in trace.device:
        if roofline.kernel_of(name) == kernel:
            n += 1
            s += b - a
    return n, s


def _label(trace: Trace, t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and the
    innermost torch operation that hold it."""
    def inner(ops):
        hold = [o for o in ops if o[1] <= t <= o[2]]
        return min(hold, key=lambda o: o[2] - o[1])[0] if hold else None

    span = inner(trace.spans)
    op = inner([o for o in trace.host if not o[0].startswith("bench.")])
    return " / ".join(x for x in (span, op) if x) or "host outside any torch operation"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps of the device, each labelled by what the host was
    doing at its middle."""
    by_name = defaultdict(float)
    for name, a, b in trace.device:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.device)
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_label(trace, (a + b) / 2), b - a] for a, b in gaps]}


def steps_and_time(tr: Trace, kernel: str) -> Tuple[int, float]:
    """(traced steps, device seconds of ``kernel``): a step is one Kernel 1
    launch, every step of every cell gathers its rows once. (0, 0) where
    either is missing."""
    steps, _ = kernel_time(tr, "gather_rows")
    n, s = kernel_time(tr, kernel)
    return (steps, s) if steps and n and s > 0 else (0, 0.0)
