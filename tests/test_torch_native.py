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


def _check_plan_against_jax(ids, num_rows, block_rows):
    """The port's plan is JAX's bin grouping re-sorted stably by id inside
    each bin: bin_starts equal bit for bit, perm the stable sort by id, and
    ids_grouped == ids[perm]."""
    perm, grouped, bins = hostops.sort_plan(ids, num_rows, block_rows)
    jperm, _, jbins = jax_hostops.sort_plan(ids, num_rows, block_rows)
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(perm, jperm[np.argsort(ids[jperm], kind="stable")])
    np.testing.assert_array_equal(grouped, ids[perm])
    np.testing.assert_array_equal(perm, np.argsort(ids, kind="stable"))
    assert perm.dtype == grouped.dtype == bins.dtype == np.int32


@pytest.mark.parametrize("block_rows", [64, 512])
@pytest.mark.parametrize("L,num_rows", [(1000, 700), (4096, 2048), (777, 1000)])
def test_sort_plan_matches_jax(L, num_rows, block_rows):
    rng = np.random.default_rng(L + block_rows)
    ids = rng.integers(0, num_rows, size=L).astype(np.int32)
    _check_plan_against_jax(ids, num_rows, block_rows)


def _skewed_stream(case, rng):
    if case == "one_row_most":  # one row holds 90% of the stream
        n = 5000
        ids = np.where(rng.random(n) < 0.9, 321, rng.integers(0, 2000, n))
        return ids.astype(np.int32), 2000
    if case == "empty_bins":  # four rows far apart: most bins empty
        return rng.choice([3, 4, 700, 1999], size=900).astype(np.int32), 2000
    if case == "unaligned_rows":  # num_rows not a multiple of 64, the last row used
        return np.concatenate([rng.integers(0, 1001, 600), [1000, 1000]]).astype(np.int32), 1001
    return np.zeros((0,), np.int32), 700  # empty stream


@pytest.mark.parametrize("case", ["one_row_most", "empty_bins", "unaligned_rows", "empty"])
def test_sort_plan_sorts_skewed_streams(case):
    ids, num_rows = _skewed_stream(case, np.random.default_rng(9))
    _check_plan_against_jax(ids, num_rows, 64)


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
