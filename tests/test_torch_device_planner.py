"""The device planner (``planner="device"``) of the port against the JAX
package's, on the CPU, on inputs made from a seed with numpy:

  * ``cache/state.py::plan_ids`` over chained windows (LFU and DATASET, a
    cold and a warmed state, unique-budget overflow and capacity
    exhaustion): every state array and the Plan equal bit for bit;
  * the update plan that the trainer makes where the ids are
    (``ops/binned_scatter.sort_plan``) equal to ``sort_plan_np``;
  * ``tests/test_cache.py``'s cases on the bare module against JAX's
    device-planner bag: the same slot ids, cache rows, counts and flushed
    rows;
  * the trainer: losses and flushed tables against JAX's trainer on the same
    synthetic stream (f32 rows: losses rtol 1e-5, rows atol 1e-5; bf16 rows:
    losses rtol 2e-2, rows within one bf16 step), the refusals JAX makes.

``approx_evict``: JAX selects victims with ``lax.approx_min_k``, whose CPU
result orders equal scores otherwise than a stable sort; the port selects
exactly, which equals JAX's ``approx_evict=False`` (ROADMAP Queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
import torch_parity as tp
from cachedembedding_tpu.cache import state as jax_state
from cachedembedding_tpu.cache.manager import CachedEmbeddingBag as JaxBag
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synth import SynthTraceDataset as JaxTraces
from cachedembedding_tpu_torch.cache import state as port_state
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synth import SynthTraceDataset
from cachedembedding_tpu_torch.ops import launch_counts
from cachedembedding_tpu_torch.ops import rounding as port_rounding
from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan, sort_plan_np

N_ROWS, CAP = 600, 48


def _windows(seed, n=8, L=70, rows=N_ROWS, overflow_at=(), exhaust_at=()):
    """n windows of Zipf ids; at ``exhaust_at`` a window of more distinct ids
    than the cache holds, at ``overflow_at`` one whose distinct ids exceed a
    unique budget of 16."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        if w in exhaust_at:
            ids = rng.permutation(rows)[: CAP + 9].astype(np.int32)
        else:
            ids = (rng.zipf(1.4, L) % rows).astype(np.int32)
        out.append((ids, 16 if w in overflow_at else L + CAP))
    return out


def _warm_state(freq, k):
    top = np.argsort(-freq, kind="stable")[:k]
    s2r = np.full((CAP,), -1, np.int32)
    r2s = np.full((N_ROWS,), -1, np.int32)
    s2r[:k], r2s[top] = top, np.arange(k, dtype=np.int32)
    sf = np.zeros((CAP,), np.int32)
    sf[:k] = freq[top]
    return s2r, r2s, sf


CHAINS = {
    "lfu_cold": ("lfu", False, {}),
    "dataset_cold": ("dataset", False, {}),
    "lfu_warm": ("lfu", True, {}),
    "dataset_warm": ("dataset", True, {}),
    "lfu_overflow_and_exhaustion": ("lfu", False, dict(overflow_at=(2,), exhaust_at=(5,))),
    "dataset_overflow_and_exhaustion": ("dataset", True, dict(overflow_at=(6,), exhaust_at=(3,))),
}


def _chain(name, approx_port=False, approx_jax=False):
    strat, warm, kw = CHAINS[name]
    freq = np.random.default_rng(3).integers(0, 50, N_ROWS).astype(np.int32)
    if warm:
        arrays = _warm_state(freq, 30)
        js = jax_state.CacheState(*(jnp.asarray(a) for a in arrays))
        ps = port_state.CacheState(*(torch.from_numpy(a.copy()) for a in arrays))
    else:
        js = jax_state.init_cache_state(N_ROWS, CAP)
        ps = port_state.init_cache_state(N_ROWS, CAP)
    out = []
    for ids, budget in _windows(11, **kw):
        js, jp = jax_state.plan_ids(js, jnp.asarray(ids), jnp.asarray(freq), unique_budget=budget,
                                    strategy=jax_state.EvictionStrategy(strat), approx_evict=approx_jax)
        ps, pp = port_state.plan_ids(ps, torch.from_numpy(ids), torch.from_numpy(freq), unique_budget=budget,
                                     strategy=port_state.EvictionStrategy(strat), approx_evict=approx_port)
        jr = jax_state.remap_ids(js, jnp.asarray(ids))
        pr = port_state.remap_ids(ps, torch.from_numpy(ids))
        out.append(([np.asarray(x) for x in (*js, *jp, jr)], [x.numpy() for x in (*ps, *pp, pr)]))
    return out


@pytest.mark.parametrize("name", list(CHAINS))
def test_plan_ids_chain_matches_jax(name):
    """Eight chained windows: the new state's three arrays, the plan's index
    block and scalars and the remapped ids, bit for bit."""
    over = []
    for w, (want, got) in enumerate(_chain(name)):
        for a, b, what in zip(got, want, ("slot_to_row", "row_to_slot", "slot_freq", "indices", "scalars",
                                          "slot_ids")):
            assert a.dtype == b.dtype == np.int32, (w, what)
            np.testing.assert_array_equal(a, b, err_msg=f"window {w} {what}")
        over.append(int(got[4][1]))  # n_unique
    _, _, kw = CHAINS[name]
    for w in kw.get("overflow_at", ()):  # more distinct ids than the budget of 16
        assert over[w] > 16
    for w in kw.get("exhaust_at", ()):  # more distinct ids than the cache's slots
        assert over[w] > CAP


def test_approx_evict_selects_exactly():
    """approx_evict=True in the port equals JAX's exact selection bit for
    bit; JAX's own approximate selection orders equal scores otherwise
    (the difference ROADMAP Queue 3 records)."""
    exact = _chain("lfu_cold", approx_port=True)
    for want, got in exact:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    approx = _chain("lfu_cold", approx_jax=True)
    assert any(not np.array_equal(want[3], got[3]) for want, got in approx)
    # the counts of the first window, whose victims are all empty slots, agree
    np.testing.assert_array_equal(approx[0][0][4], approx[0][1][4])


@pytest.mark.parametrize("num_rows,shape", [(1000, (5000,)), (64, (1,)), (65, (300,)), (90_000, (7, 4096)),
                                            (3000, (0,))])
def test_update_plan_matches_sort_plan_np(num_rows, shape):
    """The trainer's update plan made where the ids are (the card, in the
    device planner) equals the host's, on the (N, F)-order stream too."""
    ids = np.random.default_rng(num_rows).integers(0, num_rows, shape).astype(np.int32)
    stream = ids.T.reshape(-1) if ids.ndim == 2 else ids
    got = sort_plan(torch.from_numpy(ids).t().reshape(-1) if ids.ndim == 2 else torch.from_numpy(ids), num_rows)
    for a, b in zip(got, sort_plan_np(stream, num_rows)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)


# -- the bare module: tests/test_cache.py's cases against JAX's device planner --

def _bags(N=64, D=8, C=16, strategy="lfu", freq=None, warmup=0.0, **kw):
    common = dict(cuda_row_num=C, ids_freq_mapping=freq, warmup_ratio=warmup, buffer_size=0, planner="device",
                  **kw)
    j = JaxBag(N, D, evict_strategy=jax_state.EvictionStrategy(strategy), **common)
    p = CachedEmbeddingBag(N, D, evict_strategy=port_state.EvictionStrategy(strategy), device="cpu", **common)
    return j, p


def _lookup(bags, ids):
    """Each bag's prepare_ids, then its cache rows at the slots: the slots
    and rows must agree, and equal the host rows of ``ids``."""
    j, p = bags
    ids = np.asarray(ids, np.int32)
    js = np.asarray(j.prepare_ids(ids))
    ps = p.prepare_ids(ids)
    np.testing.assert_array_equal(ps.numpy(), js)
    rows = p.cache_weight[ps.long()].numpy()
    np.testing.assert_array_equal(rows, np.asarray(j.cache_weight)[js])
    np.testing.assert_array_equal(rows, p.host_table.gather(ids.astype(np.int64)))
    return ps


def _same_state(bags):
    j, p = bags
    for a, b in zip(j.state, p.state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for k in ("num_hits_history", "num_miss_history", "num_write_back_history", "swap_in_bytes",
              "prepare_calls"):
        assert getattr(p.stats, k) == getattr(j.stats, k), k


def _resident(bag):
    return set(bag.resident()[1].tolist())


def _set_rows(bags, slots, values):
    """Write ``values`` into the cache rows at ``slots`` in both bags."""
    j, p = bags
    cw = np.asarray(j.cache_weight).copy()
    cw[slots] = values
    j.set_param(jnp.asarray(cw))
    p.cache_weight[torch.as_tensor(slots, dtype=torch.long)] = torch.as_tensor(values, dtype=torch.float32)


def test_miss_then_hit():
    bags = _bags()
    _lookup(bags, [3, 7, 3])
    _lookup(bags, [3, 7, 3])
    _same_state(bags)
    assert bags[1].stats.num_miss_history == [2, 0] and bags[1].stats.num_hits_history == [0, 2]
    bags[1].close()


def test_eviction_lfu_dataset_and_protection():
    bags = _bags(C=4)
    _lookup(bags, [0, 1, 2, 3])
    _lookup(bags, [10, 11])  # evicts two
    assert {10, 11} <= _resident(bags[1]) and len(_resident(bags[1])) == 4
    _lookup(bags, [10, 11, 0, 1])  # all needed again: nothing it hits is evicted
    _same_state(bags)
    bags[1].close()
    bags = _bags(C=4)
    _lookup(bags, [0, 0, 0, 1, 1, 2, 2, 3])  # LFU: row 3 is the least frequent
    _lookup(bags, [9])
    assert _resident(bags[1]) == {0, 1, 2, 9}
    _same_state(bags)
    bags[1].close()
    freq = np.zeros(64, np.int64)
    freq[[0, 1, 2, 3, 9]] = [100, 50, 10, 1, 5]
    bags = _bags(C=4, strategy="dataset", freq=freq)
    _lookup(bags, [0, 1, 2, 3])
    _lookup(bags, [9])  # evicts row 3 (dataset frequency 1)
    assert _resident(bags[1]) == {0, 1, 2, 9}
    _same_state(bags)
    bags[1].close()


def test_errors_match_jax():
    """An out-of-range id raises ValueError before the plan; a window of
    more distinct ids than slots raises RuntimeError naming the capacity;
    both as JAX raises them."""
    bags = _bags(C=4)
    for bag in bags:
        with pytest.raises(ValueError, match="range"):
            bag.prepare_ids(np.array([1, 64], np.int32))
        with pytest.raises(RuntimeError, match="capacity 4|more than 4 slots"):
            bag.prepare_ids(np.arange(5, dtype=np.int32))
    bags[1].close()


def test_writeback_flush_and_updates_survive_eviction():
    """Trained rows go back to the host table on eviction and on flush, and
    come back with their values; the mirror of a fake update agrees."""
    bags = _bags(N=200, D=4, C=16)
    mirror = bags[1].host_table.gather(np.arange(200, dtype=np.int64)).copy()
    rng = np.random.default_rng(7)
    for step in range(30):
        ids = rng.integers(0, 200, int(rng.integers(1, 8))).astype(np.int32)
        slots = _lookup(bags, ids).numpy() if step == 0 else bags[1].prepare_ids(ids).numpy()
        js = np.asarray(bags[0].prepare_ids(ids)) if step else slots
        np.testing.assert_array_equal(slots, js)
        np.testing.assert_array_equal(bags[1].cache_weight[torch.from_numpy(slots).long()].numpy(), mirror[ids])
        uniq, first = np.unique(ids, return_index=True)
        trained = bags[1].cache_weight[torch.from_numpy(slots[first]).long()].numpy() + (step + 1.0)
        _set_rows(bags, slots[first], trained)
        mirror[uniq] += step + 1
    _same_state(bags)
    assert sum(bags[1].stats.num_write_back_history) > 0
    bags[0].flush()
    np.testing.assert_array_equal(bags[1].dense_weight(), mirror)
    np.testing.assert_array_equal(bags[0].host_weight, mirror)
    bags[1].close()


def test_warmup_preloads_hottest():
    freq = np.zeros(64, np.int64)
    freq[[10, 20, 30, 40]] = [9, 8, 7, 6]
    bags = _bags(C=4, strategy="dataset", freq=freq, warmup=1.0)
    assert _resident(bags[1]) == {10, 20, 30, 40}
    _lookup(bags, [10, 20])
    assert bags[1].stats.num_miss_history[-1] == 0
    _same_state(bags)
    bags[1].close()
    bags = _bags(C=8, strategy="dataset", freq=np.arange(64, dtype=np.int64), warmup=0.5)
    assert _resident(bags[1]) == {60, 61, 62, 63}
    _same_state(bags)
    bags[1].reset_cache()  # back to the warmed state
    assert _resident(bags[1]) == {60, 61, 62, 63}
    bags[1].close()


@pytest.mark.parametrize("strategy", ["lfu", "dataset"])
def test_lookup_equivalence_under_pressure(strategy):
    rng = np.random.default_rng(42)
    freq = rng.integers(0, 100, 500).astype(np.int64)
    bags = _bags(N=500, D=4, C=32, strategy=strategy, freq=freq, warmup=0.5)
    for _ in range(20):
        _lookup(bags, (rng.zipf(1.5, size=int(rng.integers(1, 32))) % 500).astype(np.int32))
    _same_state(bags)
    bags[1].close()


def test_forward_pooling_offsets_weights_and_cache_op():
    """forward: uniform pooling, ragged offsets, per-sample weights, and
    set_cache_op(False) on slot ids, against JAX's device-planner bag."""
    bags = _bags(N=100, D=8, C=32)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, (4, 3)).astype(np.int32).T.reshape(-1)
    np.testing.assert_allclose(bags[1].forward(vals, num_features=3, batch_size=4).numpy(),
                               np.asarray(bags[0].forward(vals, num_features=3, batch_size=4)), rtol=1e-6)
    values, offsets = np.array([1, 2, 3, 4, 5], np.int32), np.array([0, 2, 2, 5], np.int32)
    w = np.array([0.5, 2.0, 3.0, 1.0, -1.0], np.float32)
    for kw in ({}, {"per_sample_weights": w}):
        got = bags[1].forward(values, offsets, num_features=1, batch_size=3, **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(bags[0].forward(values, offsets, num_features=1, batch_size=3,
                                                                   **kw)), rtol=1e-6)
    ids = np.array([11, 12, 13], np.int32)
    slots = _lookup(bags, ids)
    bags[1].set_cache_op(False)
    out = bags[1].forward(slots.numpy(), num_features=3, batch_size=1)
    np.testing.assert_array_equal(out.numpy().reshape(3, 8), bags[1].host_table.gather(ids.astype(np.int64)))
    _same_state(bags)
    bags[1].close()


def test_refusals_match_jax():
    """What JAX's device planner refuses, with the same exception type:
    resident tables, row-wise Adagrad, device_init="on"; and an unknown
    planner."""
    for kw in ({"table_sizes": [30, 34], "resident_tables": [0]}, {"optimizer": "rowwise_adagrad"},
               {"device_init": "on"}, {"planner": "gpu"}):
        full = {"planner": "device", **kw}
        with pytest.raises(ValueError) as je:
            JaxBag(64, 8, cuda_row_num=8, **full)
        with pytest.raises(ValueError) as pe:
            CachedEmbeddingBag(64, 8, cuda_row_num=8, device="cpu", **full)
        key = str(je.value).split(" ")[0]
        assert key in str(pe.value), (je.value, pe.value)


# -- the trainer --------------------------------------------------------------

DEVICE = dict(planner="device", resident_threshold=0)


@pytest.mark.parametrize("case", ["f32", "f32_churn", "bf16", "bf16_sparse"])
def test_trainer_matches_jax(case, monkeypatch):
    """planner="device" at the parity width: counts equal (the eval batches
    planned one by one, as JAX does), losses, AUROC and flushed rows. f32
    rows: losses rtol 1e-5, rows atol 1e-5; bf16 rows: losses rtol 2e-2,
    rows within one bf16 step. The CPU tensors take the plain versions:
    no kernel launches."""
    kw = {"f32": dict(cache_dtype="float32", cache_ratio=0.5),
          "f32_churn": dict(cache_dtype="float32", cache_ratio=0.025),
          "bf16": dict(compute="bfloat16", cache_ratio=0.5),
          "bf16_sparse": dict(use_sparse_embed_grad=True)}[case]
    before = launch_counts()
    ref = tp.run(False, monkeypatch, **DEVICE, **kw)
    got = tp.run(True, monkeypatch, **DEVICE, **kw)
    assert launch_counts() == before
    assert got["stats"] == ref["stats"] and len(got["stats"]["num_miss_history"]) == 2 + 4
    if case == "f32_churn":
        assert sum(got["stats"]["num_write_back_history"]) > 0, "this config must evict"
    assert np.isfinite(got["losses"]).all() and got["losses"].shape == (8,)
    f32 = kw.get("cache_dtype") == "float32"
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5 if f32 else 2e-2)
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= (1e-5 if f32 else 2e-2)
    if f32:
        np.testing.assert_allclose(got["rows"], ref["rows"], rtol=0, atol=1e-5)
    else:
        assert tp.storage_steps(got["rows"], ref["rows"], torch.bfloat16).max() <= 1
    tr = got["trainer"]
    assert tr.device_planner and tr.embed._dir is None


def test_trainer_branch_rule():
    """The device planner's windows take JAX's unstaged branch rule: sparse
    or dense, never the plan branch (JAX ships no plans there), whatever
    ship_sort_perm says."""
    tables = [50, 300, 4000]
    base = dict(num_embeddings_per_feature=tables, embedding_dim=16, dense_in_features=4,
                dense_arch_layer_sizes=(16,), over_arch_layer_sizes=(8, 1), batch_size=64)
    for cache_kw, kw, want in [({"ship_sort_perm": True, "cache_ratio": 0.15}, {}, "dense"),
                               ({"cache_ratio": 0.15}, {"use_sparse_embed_grad": True}, "sparse"),
                               ({"cache_ratio": 1.0}, {}, "sparse")]:
        cfg = DLRMConfig(**base, **kw, cache=CacheConfig(planner="device", **cache_kw))
        tr = port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
        win = tr._begin_window(list(tp.SyntheticLongTailDataset(tables, 64, 1, dense_in_features=4)))
        tr._finish_window(win)
        assert tr.branch_of(win) == want, (cache_kw, kw)
        tr.close()


def test_fp8_rows_with_rounding_match_jax(monkeypatch):
    """float8_e4m3fn rows with stochastic rounding (the dense branch's
    rounding: Kernel 3's f32 grad, Kernel 4), JAX's uniforms shared: counts
    equal, losses rtol 1e-4, at most 8 flushed elements one e4m3 step off."""
    monkeypatch.setattr(port_rounding, "philox_uniform", tp.jax_uniform)
    kw = dict(cache_dtype="float8_e4m3fn", **DEVICE)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    steps = tp.storage_steps(got["rows"], ref["rows"], torch.float8_e4m3fn)
    assert int((steps > 0).sum()) <= 8 and int(steps.max()) <= 1


def _ragged(port: bool, monkeypatch, steps=6):
    """Ragged batches (tests/test_ragged_window.py's traces) through the
    device planner: JAX's per-step path. Returns losses, scores, counts and
    the flushed rows."""
    mod = port_trainer_mod if port else jax_trainer_mod
    rng = np.random.default_rng(5)
    traces, sizes = [], [500, 500, 500]
    for n in sizes:
        offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 6, 4096))])
        traces.append((np.minimum((n * rng.random(offsets[-1]) ** 2).astype(np.int64), n - 1), offsets))
    cache_cls, cfg_cls = (CacheConfig, DLRMConfig) if port else (JaxCacheConfig, JaxDLRMConfig)
    cfg = cfg_cls(num_embeddings_per_feature=sizes, embedding_dim=16, dense_in_features=4,
                  dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1), batch_size=64,
                  learning_rate=0.5, cache=cache_cls(cache_ratio=0.9, warmup_ratio=0.0, buffer_size=0,
                                                     prefetch_num=2, use_lfu_eviction=True, use_freq=False,
                                                     planner="device", cache_dtype="float32"))
    scores = []

    class Recording(mod.StreamingMetrics):
        def update(self, s, labels):
            scores.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)
    ds = SynthTraceDataset if port else JaxTraces
    train = ds(traces, sizes, batch_size=64, num_batches=steps, dense_in_features=4)
    tr = mod.CachedDLRMTrainer(cfg, **({"device": "cpu"} if port else {}))
    rep = tr.train(train, num_iters=steps)
    ev = tr.evaluate(ds(traces, sizes, batch_size=64, num_batches=2, dense_in_features=4, seed=99))
    ids = np.unique(np.concatenate([np.asarray(b.sparse_features.values) for b in train])).astype(np.int64)
    tr.embed.flush()
    out = dict(losses=np.asarray(rep.losses), scores=np.concatenate(scores), ev=ev,
               stats={k: getattr(tr.embed.stats, k) for k in tp.STATS},
               rows=np.asarray(tr.embed.host_table.gather(ids), np.float32))
    if port:
        tr.close()
    return out


def test_ragged_windows_match_jax(monkeypatch):
    """Ragged batches on the device planner: JAX's per-step function (the
    dense ragged branch, Kernel 5's ordered_grad_update on the card), f32
    rows: counts equal, losses and scores rtol 1e-5, rows atol 1e-5."""
    ref = _ragged(False, monkeypatch)
    got = _ragged(True, monkeypatch)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["rows"], ref["rows"], rtol=0, atol=1e-5)
