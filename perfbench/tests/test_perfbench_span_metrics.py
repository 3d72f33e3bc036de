"""The readers of the program's spans and link counters on a hand-made
``Run`` and ``Trace``: each reads its number, and None where its span or
counter is absent (a program that records none); and on a tiny cell run on
the CPU, the readers of the timed window's spans and counters read the
program's."""

import types

import pytest
import torch

from perfbench import run, spec, trace
from perfbench.tests.tiny import CELL, tiny

MS = {
    "stage_host_ms_per_window": ("trainer.fetch", "trainer.stage"),
    "plan_host_ms_per_window": ("cache.plan_host",),
    "readback_wait_ms_per_window": ("cache.readback_wait",),
    "admit_host_ms_per_window": ("cache.admit",),
    "dispatch_host_ms_per_window": ("trainer.dispatch",),
    "admit_rows_host_ms_per_window": ("cache.admit_rows",),
}
# the metrics added together with the program's spans, in their order in BENCHMARK.json
SPAN_METRICS = ["stage_host_ms_per_window", "plan_host_ms_per_window", "readback_wait_ms_per_window",
                "admit_host_ms_per_window", "dispatch_host_ms_per_window", "link_mb_per_window",
                "idle_outside_dispatch_share"]
CACHED_CELLS = [CELL, "dcnv2-mlperf-s050"]


def _run(window_spans=None, stats=None, tr=None, cached=True, windows=4):
    report = types.SimpleNamespace(window_host_s=[0.02] * 3)
    if window_spans is not None:
        report.window_spans = window_spans
    if stats is None:
        stats = types.SimpleNamespace(num_hits_history=[9] * windows)
    return run.Run(cfg=None, cached=cached, batch_size=8, steps=8 * windows, windows=windows, seconds=1.0,
                   examples_per_s=256.0, report=report, stats=stats, row_bytes=2, lookups_per_step=8 * 26,
                   example_flops=1, trace=tr)


def _spans():
    names = {n for ns in MS.values() for n in ns}
    # three windows: 1, 2, 3 ms of each span; the second lacks cache.readback_wait
    out = [{n: k * 1e-3 for n in names} for k in (1, 2, 3)]
    del out[1]["cache.readback_wait"]
    return out


@pytest.mark.parametrize("metric", sorted(MS))
def test_span_readers(metric):
    read = spec.reader(metric)
    want = {"stage_host_ms_per_window": 4.0, "readback_wait_ms_per_window": 1.0}.get(metric, 2.0)
    assert read(_run(_spans())) == pytest.approx(want)
    # a program without spans, and one without this span
    assert read(_run()) is None
    assert read(_run([{"other.span": 1.0}] * 3)) is None


def test_link_reader():
    read = spec.reader("link_mb_per_window")
    st = types.SimpleNamespace(num_hits_history=[9] * 4, h2d_bytes=88_000_000, d2h_bytes=21_000_000)
    assert read(_run(stats=st)) == pytest.approx(27.25)
    assert read(_run()) is None  # a program without the counters
    assert read(_run(stats=st, cached=False)) is None
    assert read(_run(stats=types.SimpleNamespace(num_hits_history=[], h2d_bytes=1, d2h_bytes=1))) is None


def test_idle_outside_dispatch_reader():
    read = spec.reader("idle_outside_dispatch_share")
    # busy [0, 1], [3, 4], [6, 7], [9, 10]: gaps [1, 3], [4, 6], [7, 9], 6 s idle
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 7.0), ("k", 9.0, 10.0)]
    # dispatch spans hold [2, 4.5] (1 s of gap one, 0.5 of gap two) and, twice over, [8, 12] (1 s of gap three)
    host = [("trainer.dispatch", 2.0, 4.5), ("trainer.dispatch", 8.0, 12.0), ("trainer.dispatch", 8.5, 11.0),
            ("cache.plan_host", 4.5, 6.0), ("aten::copy_", 1.0, 3.0)]
    t = trace.Trace(device=dev, host=host, spans=[])
    assert read(_run(tr=t)) == pytest.approx(1.0 - 2.5 / 6.0)
    # no dispatch span (a program without spans), no device work, no trace
    assert read(_run(tr=trace.Trace(device=dev, host=host[3:], spans=[]))) is None
    assert read(_run(tr=trace.Trace(device=[], host=host, spans=[]))) is None
    assert read(_run()) is None
    # one busy interval: no idle time between busy intervals
    assert read(_run(tr=trace.Trace(device=dev[:1], host=host, spans=[]))) is None


def test_the_new_metrics_are_appended_entries():
    """The span metrics stand together, in their order, wherever later
    entries put them; each moves the rate, and each that lists its cells
    lists both cells of the cached trainer, where its span or counter is
    read."""
    bench = spec.load_benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    at = names.index(SPAN_METRICS[0])
    assert names[at:at + len(SPAN_METRICS)] == SPAN_METRICS
    for m in bench["per_layer"][at:at + len(SPAN_METRICS)]:
        assert m["moves"] == "examples_per_s"
        assert m.get("workloads", CACHED_CELLS) == CACHED_CELLS


def test_span_readers_read_a_tiny_cell():
    """A traced run of the tiny cached cell on the CPU: the timed window's
    spans and counters read; the card's trace is not taken there."""
    config, mix, limits = tiny("cached")
    out, _ = run.run_cell(CELL, 2**31 + 21, 0.5, True, torch.device("cpu"), config=config, mix=mix,
                          limits=limits, warmup_iters=8)
    m = out["metrics"]
    for name in MS:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert m["link_mb_per_window"]["value"] > 0
    assert "idle_outside_dispatch_share" not in m
