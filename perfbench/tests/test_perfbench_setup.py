"""``setup_s`` leaves out the harness's own batch making: on the tiny cell
on the CPU, with ``Stream.batches`` made to sleep a fixed time a call, the
time from process start to the first timed step exceeds ``setup_s`` by at
least those sleeps, and by no more than the seconds spent in
``Stream.batches`` and a margin for the step's start."""

import time

import torch

from perfbench import run
from perfbench.tests.tiny import CELL, tiny
from perfbench.traffic import Stream

SLEEP_S = 1.5  # a Stream.batches call
MARGIN_S = 2.0  # from the set-up stamp to the trainer's pull of the first timed batch


def test_setup_leaves_out_batch_making(monkeypatch):
    made = Stream.batches
    spent = []

    def slow_batches(self, *a, **k):
        t = time.perf_counter()
        time.sleep(SLEEP_S)
        out = made(self, *a, **k)
        spent.append(time.perf_counter() - t)
        return out

    feeds = []

    class Feed(run.Feed):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            feeds.append(self)

    monkeypatch.setattr(Stream, "batches", slow_batches)
    monkeypatch.setattr(run, "Feed", Feed)
    start = time.perf_counter()
    monkeypatch.setattr(run, "T_START", start)
    config, mix, limits = tiny("cached")
    out, _ = run.run_cell(CELL, 2**31 + 23, 0.5, False, torch.device("cpu"), config=config, mix=mix,
                          limits=limits, warmup_iters=8)
    setup_s = out["metrics"]["setup_s"]["value"]
    timed = [f for f in feeds if f.on_window is not None]
    assert len(timed) == 1 and len(spent) == 2  # the warm-up's batches, the window's
    to_first_step = timed[0].stamps[0] - start
    left_out = to_first_step - setup_s
    assert left_out >= len(spent) * SLEEP_S
    assert left_out <= sum(spent) + MARGIN_S
    assert setup_s > 0
