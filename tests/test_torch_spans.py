"""The port's host spans (``utils/spans.py``) and link counters
(``CacheStats.h2d_bytes``, ``d2h_bytes``) through the trainer, on the CPU,
with the device planner and the host planner:

  * every window's ``TrainReport.window_spans`` entry carries its path's
    span names, entry i the work of window i, and its host parts sum to no
    more than ``window_host_s[i]``;
  * the stopwatches the spans replaced read the spans: ``window_plan_s``,
    the wire's ``encode_s`` and ``pack_s``, the readback's ``wait_s``;
  * under a CPU ``torch.profiler`` every span is a CPU event of FUNCTION
    scope, no user annotation, nested as the code nests them; with the
    profiler off no record function is entered;
  * a window's link bytes equal the sum its shapes give."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cachedembedding_tpu_torch.cache.manager import CacheStats
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer
from cachedembedding_tpu_torch.utils import spans

TABLES = [50, 300, 4000, 20000]
B, P, DIN, D = 64, 2, 13, 16
WINDOWS = 4
STEPS = ("step.forward_backward", "step.embedding_update", "step.dense_update")
# each planner's spans in every training window
NAMES = {
    "device": {"trainer.fetch", "trainer.stage", "cache.plan_host", "cache.check_range", "cache.readback_wait",
               "cache.admit", "trainer.dispatch", *STEPS},
    "host": {"trainer.fetch", "trainer.stage", "cache.plan_host", "cache.check_range", "trainer.encode_ids",
             "trainer.pack", "trainer.sort_plans", "trainer.ship", "cache.admit", "trainer.dispatch", *STEPS},
}


def _trainer(planner: str, **cache_kw) -> CachedDLRMTrainer:
    cache = dict(cache_ratio=0.05, prefetch_num=P, planner=planner, ship_sort_perm=planner == "host")
    cache.update(cache_kw)
    cfg = DLRMConfig(num_embeddings_per_feature=TABLES, embedding_dim=D, dense_in_features=DIN,
                     dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1), batch_size=B,
                     cache=CacheConfig(**cache))
    return CachedDLRMTrainer(cfg, id_freq_map=_data(64).id_freq_map(), device="cpu")


def _data(windows: int, seed: int = 7):
    return SyntheticLongTailDataset(TABLES, B, windows * P, dense_in_features=DIN, skew=0.5, seed=seed)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for planner in NAMES:
        tr = _trainer(planner)
        out[planner] = (tr, tr.train(_data(WINDOWS), num_iters=WINDOWS * P))
        tr.close()
    return out


@pytest.mark.parametrize("planner", sorted(NAMES))
def test_every_window_carries_its_spans(planner, runs):
    tr, rep = runs[planner]
    assert len(rep.window_spans) == len(rep.window_host_s) == WINDOWS
    for entry in rep.window_spans:
        assert set(entry) == NAMES[planner]
        assert all(v >= 0.0 for v in entry.values())
    # the recorder records into no window once train returns
    assert tr.spans.entry is None


@pytest.mark.parametrize("planner", sorted(NAMES))
def test_host_parts_fit_in_the_host_window(planner, runs):
    _, rep = runs[planner]
    for entry, host_s in zip(rep.window_spans, rep.window_host_s):
        parts = sum(entry.get(k, 0.0) for k in spans.HOST_PARTS)
        assert 0.0 < parts <= host_s + 1e-4
        # children within their parents
        assert entry["cache.check_range"] <= entry["cache.plan_host"]
        assert sum(entry[k] for k in STEPS) <= entry["trainer.dispatch"]


def test_replaced_stopwatches_read_the_spans(runs):
    _, rep = runs["host"]
    for entry, plan_s, w in zip(rep.window_spans, rep.window_plan_s, rep.window_wire):
        assert plan_s == entry["trainer.sort_plans"]
        assert w["encode_s"] == entry["trainer.encode_ids"]
        assert w["pack_s"] == pytest.approx(entry["trainer.pack"] + entry["trainer.ship"], rel=1e-12)
    _, rep = runs["device"]
    assert [r["wait_s"] for r in rep.window_readback] == [e["cache.readback_wait"] for e in rep.window_spans]
    assert rep.window_plan_s == [0.0] * WINDOWS


def _events(planner: str):
    tr = _trainer(planner)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(_data(2), num_iters=2 * P)
    tr.close()
    return [e for e in prof.events() if e.name in spans.NAMES]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("planner", sorted(NAMES))
def test_spans_are_function_records_under_the_profiler(planner):
    from torch.autograd import DeviceType

    ev = _events(planner)
    assert {e.name for e in ev} == NAMES[planner]
    for e in ev:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation and e.scope == 0
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append(e)
    assert len(by["trainer.dispatch"]) == 2
    for name in STEPS:
        assert len(by[name]) == 2 * P
        assert all(_ancestors(e)[0] == "trainer.dispatch" for e in by[name])
    assert all("cache.plan_host" in _ancestors(e) for e in by["cache.check_range"])
    # the window's parts are top-level spans: none inside another span
    for name in ("trainer.fetch", "cache.plan_host", "cache.admit", "trainer.dispatch"):
        assert all(not set(_ancestors(e)) & set(spans.NAMES) for e in by[name])


def test_no_record_function_without_the_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    tr = _trainer("device")
    tr.train(_data(2), num_iters=2 * P)
    assert entered == []
    # the counter is live: with the profiler reported on, every span enters one
    monkeypatch.setattr(spans, "_profiling", lambda: True)
    rep = tr.train(_data(1, seed=8), num_iters=P)
    tr.close()
    assert set(entered) == NAMES["device"]
    assert len(entered) == sum(entered.count(k) for k in rep.window_spans[0])


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
def test_link_bytes_of_a_window(transfer):
    """The device planner's window: ids (int32), dense features and labels
    (f32), the admits (``transfer_dtype``) and the evicted rows' slots
    (int64, for their gathers) to the card; the plan's six scalars and its
    (3, U) block, and the writebacks (bf16 under bf16 transfers, else the
    rows' dtype) back."""
    tr = _trainer("device", transfer_dtype=transfer, cache_dtype="bfloat16", buffer_size=40, cache_ratio=0.02,
                  warmup_ratio=1.0)
    tr.train(_data(1), num_iters=P)  # warmed full: every miss evicts
    tr.embed.stats = CacheStats()
    tr.train(_data(1, seed=11), num_iters=P)
    tr.embed._drain_writebacks()
    st = tr.embed.stats
    n_miss, n_wb = st.num_miss_history[-1], st.num_write_back_history[-1]
    assert n_miss > 0 and n_wb > 0
    F, C = len(TABLES), tr.embed.capacity
    elt = 2 if transfer == "bfloat16" else 4
    assert st.h2d_bytes == P * B * F * 4 + P * B * DIN * 4 + P * B * 4 + n_miss * D * elt + n_wb * 8
    U = min(P * B * F, C)
    assert st.d2h_bytes == 6 * 4 + 3 * U * 4 + n_wb * D * 2
    tr.close()


def test_median_ms():
    assert spans.median_ms([]) == {}
    got = spans.median_ms([{"a": 0.001, "b": 0.004}, {"a": 0.003}, {"a": 0.002, "b": 0.002}])
    assert got == pytest.approx({"a": 2.0, "b": 2.0})
