"""The port's data layer (``data/npy_dataset.py``, ``criteo.py``, ``avazu.py``,
``feature_counter.py``) against the JAX package's on the same npy files:
batches equal value for value, frequency maps equal, and a frequency-map file
written by either package read by the other. Also the native ``bincount`` and
the update plan (a radix sort by id) against numpy."""

import os

import numpy as np
import pytest

from cachedembedding_tpu.data import avazu as jax_avazu
from cachedembedding_tpu.data import criteo as jax_criteo
from cachedembedding_tpu.data import feature_counter as jax_fc
from cachedembedding_tpu.data import npy_dataset as jax_npy
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.data import avazu, criteo, feature_counter, npy_dataset

TABLES = [10, 300, 7, 5000]


def write_files(d, names, rows, seed=0):
    """npy shards ``{name}_{dense,sparse,labels}.npy`` of raw values."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for name, n in zip(names, rows):
        np.save(d / f"{name}_dense.npy", rng.random((n, 13)).astype(np.float32))
        np.save(d / f"{name}_sparse.npy", rng.integers(0, 1 << 30, (n, len(TABLES))).astype(np.int64))
        np.save(d / f"{name}_labels.npy", rng.integers(0, 2, (n, 1)).astype(np.int32))
    return d


def assert_same_batches(port_ds, jax_ds):
    got, want = list(port_ds), list(jax_ds)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        fa, fb = a.sparse_features, b.sparse_features
        assert a.sparse_features.values.dtype.itemsize == 4 and a.labels.dtype.itemsize == 4
        np.testing.assert_array_equal(fa.values.numpy(), np.asarray(fb.values))
        assert (fa.num_features, fa.batch_size, fa.pooling, fa.offsets) == (
            fb.num_features, fb.batch_size, fb.pooling, None)
        np.testing.assert_array_equal(a.dense_features.numpy(), np.asarray(b.dense_features))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


@pytest.mark.parametrize("stage", ["train", "val", "test"])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_criteo_batches_match_jax(tmp_path, stage, rank, world, shuffle):
    """Kaggle layout (7 days, the last split into val/test): the % hash remap,
    global offsets, rank/world row ranges, the unison shuffle seeded by
    seed + rank and the dropped partial batch agree with JAX."""
    d = write_files(tmp_path / "criteo_kaggle", ["day_0", "day_1", "day_6"], [150, 101, 90])
    kw = dict(rank=rank, world_size=world, shuffle_batches=shuffle, hashes=TABLES, seed=5)
    assert_same_batches(criteo.get_dataloader(str(d), stage, 8, **kw),
                        jax_criteo.get_dataloader(str(d), stage, 8, **kw))


def test_assigned_tables_and_default_hashes_match_jax(tmp_path):
    d = write_files(tmp_path / "criteo_kaggle", ["day_0", "day_6"], [40, 20])
    kw = dict(assigned_tables=[3, 1])
    assert_same_batches(criteo.get_dataloader(str(d), "train", 8, hashes=TABLES, **kw),
                        jax_criteo.get_dataloader(str(d), "train", 8, hashes=TABLES, **kw))
    # without hashes: the Kaggle table sizes (a path holding "kaggle")
    assert_same_batches(criteo.get_dataloader(str(d), "val", 4), jax_criteo.get_dataloader(str(d), "val", 4))
    assert criteo.table_sizes_for(str(d)) == jax_criteo.table_sizes_for(str(d))
    assert (criteo.DAYS, criteo.KAGGLE_DAYS, criteo.STAGES) == (jax_criteo.DAYS, jax_criteo.KAGGLE_DAYS,
                                                                 jax_criteo.STAGES)


@pytest.mark.parametrize("layout", [["train", "val"], ["train"]])
@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_avazu_batches_match_jax(tmp_path, layout, stage):
    """Avazu's split: train files, then the halves of the eval files (or of
    the train files when there are none)."""
    d = write_files(tmp_path / "avazu", layout, [70, 30][: len(layout)])
    kw = dict(hashes=TABLES, seed=3, shuffle_batches=True)
    assert_same_batches(avazu.get_dataloader(str(d), stage, 8, **kw), jax_avazu.get_dataloader(str(d), stage, 8, **kw))


def test_row_ranges_and_stage_files_match_jax(tmp_path):
    for lengths in ([10], [4, 4], [7, 0, 13, 5]):
        for world in (1, 2, 3, 5):
            for rank in range(world):
                assert npy_dataset.rank_row_ranges(lengths, rank, world) == jax_npy.rank_row_ranges(
                    lengths, rank, world)
    d = write_files(tmp_path / "c", ["day_0", "day_1", "day_2"], [8, 8, 8])
    for stage in ("train", "val", "test"):
        assert npy_dataset.stage_files(str(d), stage, 2) == jax_npy.stage_files(str(d), stage, 2)


def test_freq_map_matches_jax_and_files_are_shared(tmp_path):
    """The counts equal JAX's; a map cached by either package is read by the
    other (same file name, same format)."""
    a = write_files(tmp_path / "a_kaggle", ["day_0", "day_1", "day_6"], [64, 33, 20])
    want = np.asarray(jax_fc.GlobalFeatureCounter(sorted(str(p) for p in a.glob("*sparse*")), TABLES).compute())
    got = feature_counter.get_id_freq_map(str(a), TABLES)  # computes and caches
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.shape == (sum(TABLES),)
    assert (a / "id_freq_map.npy").exists()
    np.testing.assert_array_equal(np.asarray(jax_criteo.get_id_freq_map(str(a), table_sizes=TABLES)), want)
    b = write_files(tmp_path / "b_kaggle", ["day_0"], [50], seed=1)
    want_b = np.asarray(jax_avazu.get_id_freq_map(str(b), table_sizes=TABLES))  # JAX writes the file
    mtime = os.path.getmtime(b / "id_freq_map.npy")
    np.testing.assert_array_equal(avazu.get_id_freq_map(str(b), table_sizes=TABLES), want_b)
    np.testing.assert_array_equal(criteo.get_id_freq_map(str(b), table_sizes=TABLES), want_b)
    assert os.path.getmtime(b / "id_freq_map.npy") == mtime  # read, not rewritten
    with pytest.raises(FileNotFoundError):
        feature_counter.get_id_freq_map(str(tmp_path), TABLES)


def test_bincount_matches_numpy():
    rng = np.random.default_rng(2)
    n = 1000
    ids = np.concatenate([[0, n - 1, n - 1], rng.integers(0, n, 5000), np.full(300, 17), [-1, n, n + 5]])
    out = np.zeros(n, np.int64)
    hostops.bincount(ids, n, out=out)
    hostops.bincount(ids[:100], n, out=out)  # accumulates
    keep = (ids >= 0) & (ids < n)
    want = np.bincount(ids[keep], minlength=n) + np.bincount(ids[:100][keep[:100]], minlength=n)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(hostops.bincount(ids[keep].astype(np.int32), n), np.bincount(ids[keep], minlength=n))


@pytest.mark.parametrize("num_rows", [1, 2, 64, 1000, 65537, 901_228, (1 << 20) + 1, 33_762_577])
def test_sort_plan_matches_a_stable_argsort(num_rows):
    """The radix-sorted plan: perm a stable argsort of the ids, ids_grouped
    the sorted ids, bin_starts by searchsorted at every 64th row; ids at 0,
    at num_rows - 1, and heavy duplicates, over one and two radix passes."""
    rng = np.random.default_rng(num_rows)
    L = 5000
    ids = np.concatenate([
        np.minimum(rng.zipf(1.2, L) - 1, num_rows - 1), rng.integers(0, num_rows, L),
        np.zeros(40, np.int64), np.full(40, num_rows - 1), np.full(300, num_rows // 2),
    ])
    ids = rng.permutation(ids).astype(np.int32)
    perm, grouped, bins = hostops.sort_plan(ids, num_rows, 64)
    want = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(grouped, ids[want])
    bounds = np.minimum(64 * np.arange(-(-num_rows // 64) + 1, dtype=np.int64), num_rows)
    np.testing.assert_array_equal(bins, np.searchsorted(ids[want], bounds))
    assert perm.dtype == grouped.dtype == bins.dtype == np.int32
