"""Named host spans of the training loop (the counterpart of the JAX
trainer's ``cache_prepare`` and ``train_window_dispatch`` annotations).

A ``Spans`` recorder is shared by a trainer and its cache. ``spans(name)``
is a context: on exit it adds the host seconds it held
(``time.perf_counter_ns``) to the recorder's current ``entry`` (a dict of
seconds by name; nothing where it is None), and keeps them in the context's
``s``. While a ``torch.profiler`` records, it also holds a FUNCTION-scope
record function of the same name, so that its start and end sit on the
profiler's clock beside the card's kernels. ``torch.profiler.record_function``
is not used: it is a user annotation, which the profiler mirrors onto the
device's timeline, where a trace reader would take it for device work. With
the profiler off, no record function is entered. Spans are opened on the
training thread only (the writeback drain thread opens none), and a child's
seconds are counted in its parent's too.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import torch

# every span the port records; the profiler's records carry the same names
FETCH = "trainer.fetch"                    # the window's batches pulled from the data
STAGE = "trainer.stage"                    # ids concatenated, dense features and labels stacked and copied
ENCODE = "trainer.encode_ids"              # host planner: the id block of the window wire
PACK = "trainer.pack"                      # host planner: dense, labels and admit blocks
SORT_PLANS = "trainer.sort_plans"          # host planner: the update plans
SHIP = "trainer.ship"                      # host planner: the buffer assembled and copied
DISPATCH = "trainer.dispatch"              # a window's steps enqueued
PLAN_HOST = "cache.plan_host"              # the cache's plan, host part
CHECK_RANGE = "cache.check_range"          # child of PLAN_HOST: the ids' range check
READBACK_WAIT = "cache.readback_wait"      # device planner: the host blocked on the plan's readback
ADMIT = "cache.admit"                      # admits and writebacks gathered and enqueued
FORWARD_BACKWARD = "step.forward_backward"  # children of DISPATCH, a step each
EMBEDDING_UPDATE = "step.embedding_update"
DENSE_UPDATE = "step.dense_update"
NAMES = (FETCH, STAGE, ENCODE, PACK, SORT_PLANS, SHIP, DISPATCH, PLAN_HOST, CHECK_RANGE, READBACK_WAIT, ADMIT,
         FORWARD_BACKWARD, EMBEDDING_UPDATE, DENSE_UPDATE)
# the parts of a window's host time (``TrainReport.window_host_s``): no two overlap
HOST_PARTS = (FETCH, STAGE, PLAN_HOST, ENCODE, PACK, SORT_PLANS, SHIP, READBACK_WAIT, ADMIT)

_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("_rec", "_name", "_t0", "_rf", "s")

    def __init__(self, rec: "Spans", name: str):
        self._rec, self._name, self.s = rec, name, 0.0

    def __enter__(self) -> "_Span":
        self._rf = None
        if _profiling():
            self._rf = torch._C._profiler._RecordFunctionFast(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.s = (time.perf_counter_ns() - self._t0) * 1e-9
        if self._rf is not None:
            self._rf.__exit__(*exc)
        e = self._rec.entry
        if e is not None:
            e[self._name] = e.get(self._name, 0.0) + self.s


class Spans:
    """The recorder: ``entry`` is the dict the spans add to (the trainer
    points it at the window whose work runs)."""

    def __init__(self):
        self.entry: Optional[Dict[str, float]] = None

    def __call__(self, name: str) -> _Span:
        return _Span(self, name)


def median_ms(entries: List[Dict[str, float]]) -> Dict[str, float]:
    """Each span's median host ms over ``entries`` (windows), a window
    without the span counting 0, for every name some entry holds."""
    names = sorted({k for e in entries for k in e})
    return {k: 1e3 * statistics.median(e.get(k, 0.0) for e in entries) for k in names}
