"""The port's own native host library (cachedembedding_tpu_torch/_native)
against the JAX package's: the directory plans, the sort plan and the virtual
table must agree exactly on the same inputs (they are copies of one C++)."""

import numpy as np
import pytest

from cachedembedding_tpu._native import hostops as jax_hostops
from cachedembedding_tpu.cache.host_directory import HostDirectory as JaxDirectory
from cachedembedding_tpu.cache.host_table import VirtualHostTable as JaxVirtual
from cachedembedding_tpu.cache.state import EvictionStrategy as JaxStrategy
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.host_directory import CapacityError, HostDirectory
from cachedembedding_tpu_torch.cache.host_table import DenseHostTable, VirtualHostTable
from cachedembedding_tpu_torch.cache.state import EvictionStrategy


def test_gxx_build_succeeds():
    path, _, _ = hostops.build_lib()
    assert path.exists() and path.parent.name == "build"
    lib = hostops.load_lib()
    assert lib.dir_plan.restype is not None


def _zipf_windows(rng, num_rows, n_windows, L):
    return [
        np.minimum(rng.zipf(1.3, size=L) - 1, num_rows - 1).astype(np.int32)
        for _ in range(n_windows)
    ]


@pytest.mark.parametrize("strategy", ["lfu", "dataset"])
def test_directory_plan_matches_jax(strategy):
    """Same warmup, same Zipf stream, capacity small enough for eviction
    churn: every plan field and statistic is equal."""
    rng = np.random.default_rng(0)
    N, C, L = 5000, 600, 1200
    port = HostDirectory(N, C, EvictionStrategy(strategy))
    ref = JaxDirectory(N, C, JaxStrategy(strategy))
    freq = rng.integers(0, 1000, size=N).astype(np.int64)
    if strategy == "dataset":
        port.set_dataset_freq(freq)
        ref.set_dataset_freq(freq)
    top = np.argsort(-freq, kind="stable")[:300].astype(np.int64)
    port.warmup(top, freq[top])
    ref.warmup(top, freq[top])
    n_evicted = 0
    for ids in _zipf_windows(rng, N, 12, L):
        a, b = port.plan(ids), ref.plan(ids)
        for name in ("slot_ids", "admit_rows", "admit_slots", "evict_rows"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.n_unique, a.n_hit_unique, a.n_hit_weighted, a.n_ids) == (
            b.n_unique, b.n_hit_unique, b.n_hit_weighted, b.n_ids)
        n_evicted += int((a.evict_rows >= 0).sum())
    assert n_evicted > 0, "the stream must churn the cache"
    s1, r1 = port.resident()
    s2, r2 = ref.resident()
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(r1, r2)
    assert port.num_free == ref.num_free


def test_directory_errors():
    d = HostDirectory(100, 4, EvictionStrategy.LFU)
    with pytest.raises(ValueError, match="out of range"):
        d.plan(np.array([0, 100], np.int32))
    with pytest.raises(CapacityError):
        d.plan(np.arange(10, dtype=np.int32))


@pytest.mark.parametrize("block_rows", [64, 512])
@pytest.mark.parametrize("L,num_rows", [(1000, 700), (4096, 2048), (777, 1000)])
def test_sort_plan_matches_jax(L, num_rows, block_rows):
    rng = np.random.default_rng(L + block_rows)
    ids = rng.integers(0, num_rows, size=L).astype(np.int32)
    mine = hostops.sort_plan(ids, num_rows, block_rows)
    ref = jax_hostops.sort_plan(ids, num_rows, block_rows)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


def test_virtual_table_matches_jax():
    sizes = [64, 1000, 5000]
    port = VirtualHostTable(sizes, dim=16, seed=11, capacity_hint=64)
    ref = JaxVirtual(sizes, dim=16, seed=11, capacity_hint=64)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, sum(sizes), size=700).astype(np.int64)
    np.testing.assert_array_equal(port.gather(ids), ref.gather(ids))
    # scatters past the overlay's initial capacity force it to grow
    for k in range(3):
        w = np.unique(rng.integers(0, sum(sizes), size=200)).astype(np.int64)
        vals = rng.standard_normal((w.shape[0], 16)).astype(np.float32)
        port.scatter(w, vals)
        ref.scatter(w, vals)
        np.testing.assert_array_equal(port.gather(ids), ref.gather(ids))
        np.testing.assert_array_equal(port.written_mask(ids), ref.written_mask(ids))
    np.testing.assert_array_equal(np.sort(port.written_rows()), np.sort(ref.written_rows()))


def test_dense_table_canonical_fill_matches_jax():
    arr = np.empty((300, 8), np.float32)
    ref = np.empty((300, 8), np.float32)
    hostops.fill_rows_canonical(arr, 50, seed=7, bound=0.3)
    jax_hostops.fill_rows_canonical(ref, 50, seed=7, bound=0.3)
    np.testing.assert_array_equal(arr, ref)
    t = DenseHostTable(arr, procedural_seed=7, table_sizes=[300])
    t.scatter(np.array([2, 5]), np.ones((2, 8), np.float32))
    assert t.written_mask(np.array([1, 2, 5])).tolist() == [False, True, True]
    np.testing.assert_array_equal(t.gather(np.array([5, 1])), np.stack([np.ones(8, np.float32), arr[1]]))
