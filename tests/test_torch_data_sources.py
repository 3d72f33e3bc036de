"""The port's data sources and their plumbing against the JAX package's, on
the CPU, batch for batch on the same seeds and files: every source of
``data/dispatch.py::get_dataloader`` (random, custom, synth, criteo,
criteo_parquet, avazu), ``DictBatchTransform``, ``PrefetchIterator`` and
``FiniteDataIter`` (order, and an upstream error raised in the consumer),
``ParquetDataReader``'s rank sharding and ``SampledParquetCounter`` (behind
pyarrow, which the card machine lacks: there the reader raises an
ImportError naming it), and ``utils/timer.py``'s ``Timer`` on the CPU."""

import logging
import sys

import numpy as np
import pytest
import torch

from cachedembedding_tpu.data import dispatch as jax_dispatch
from cachedembedding_tpu.data import feature_counter as jax_fc
from cachedembedding_tpu.data.prefetch import PrefetchIterator as JaxPrefetch
from cachedembedding_tpu.data.transform import DictBatchTransform as JaxTransform
from cachedembedding_tpu_torch.data import dispatch, feature_counter, parquet
from cachedembedding_tpu_torch.data.prefetch import FiniteDataIter, PrefetchIterator
from cachedembedding_tpu_torch.data.random_rec import RandomRecDataset
from cachedembedding_tpu_torch.data.transform import DictBatchTransform
from cachedembedding_tpu_torch.utils import Timer, get_time_elapsed

TABLES = [10, 300, 7, 5000]


def assert_same(port_batches, jax_batches):
    got, want = list(port_batches), list(jax_batches)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        fa, fb = a.sparse_features, b.sparse_features
        assert isinstance(fa.values, torch.Tensor) and fa.values.dtype == torch.int32
        np.testing.assert_array_equal(fa.values.numpy(), np.asarray(fb.values))
        assert (fa.num_features, fa.batch_size, fa.pooling) == (fb.num_features, fb.batch_size, fb.pooling)
        if fb.offsets is None:
            assert fa.offsets is None
        else:
            np.testing.assert_array_equal(fa.offsets.numpy(), np.asarray(fb.offsets))
        np.testing.assert_array_equal(a.dense_features.numpy(), np.asarray(b.dense_features))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


def write_npy(d, names, rows, seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for name, n in zip(names, rows):
        np.save(d / f"{name}_dense.npy", rng.random((n, 13)).astype(np.float32))
        np.save(d / f"{name}_sparse.npy", rng.integers(0, 1 << 30, (n, len(TABLES))).astype(np.int64))
        np.save(d / f"{name}_labels.npy", rng.integers(0, 2, (n, 1)).astype(np.int32))
    return d


def write_parquet(d, files=2, rows=100, groups=30, seed=0):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(files):
        cols = {"label": rng.integers(0, 2, rows).astype(np.int32)}
        cols.update({f"int_{k}": rng.integers(0, 50, rows).astype(np.int32) for k in range(3)})
        # cat_10 before cat_2 in the file: the reader sorts the columns by number
        for k in (10, 2, 0):
            cols[f"cat_{k}"] = rng.integers(0, 1 << 20, rows).astype(np.int64)
        pq.write_table(pa.table(cols), d / f"part{i}.parquet", row_group_size=groups)
    return d


def write_traces(d, seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for t, n in enumerate((300, 80, 2000)):
        offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 5, 64))])
        np.savez(d / f"table_{t}.npz", indices=rng.integers(0, n, offsets[-1]) * 7, offsets=offsets)
    return d


def _sources(tmp_path):
    """Each source's get_dataloader arguments (beyond source, stage, batch)."""
    crit = write_npy(tmp_path / "criteo_kaggle", ["day_0", "day_1", "day_6"], [70, 41, 50])
    avazu = write_npy(tmp_path / "avazu", ["train", "val"], [90, 40], seed=1)
    return {
        "random": dict(table_sizes=TABLES, num_batches=3, pooling_factor=2),
        "custom": dict(table_sizes=TABLES, num_batches=3, skew=0.4),
        "synth": dict(dataset_dir=str(write_traces(tmp_path / "traces")), num_batches=4, data_size="4M"),
        "criteo": dict(dataset_dir=str(crit), hashes=TABLES, shuffle_batches=True),
        "avazu": dict(dataset_dir=str(avazu), hashes=TABLES),
    }


@pytest.mark.parametrize("source", ["random", "custom", "synth", "criteo", "avazu"])
@pytest.mark.parametrize("stage", ["train", "val"])
def test_get_dataloader_matches_jax(tmp_path, source, stage):
    kw = _sources(tmp_path)[source]
    got = dispatch.get_dataloader(source, stage, 8, seed=3, **kw)
    want = jax_dispatch.get_dataloader(source, stage, 8, seed=3, **kw)
    assert_same(got, want)


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_parquet_reader_matches_jax(tmp_path, rank, world):
    """Row groups dealt round-robin to ranks, batches re-chunked across row
    groups and files, the tail dropped, log(x + 2) dense, % hash + offsets:
    equal to JAX's reader, through get_dataloader, with prefetching."""
    d = str(write_parquet(tmp_path / "pq"))
    tables = [100, 40, 7]
    kw = dict(dataset_dir=d, table_sizes=tables, rank=rank, world_size=world)
    got = list(dispatch.get_dataloader("criteo_parquet", "train", 16, prefetch_depth=2, **kw))
    assert_same(got, jax_dispatch.get_dataloader("criteo_parquet", "train", 16, **kw))
    assert_same(parquet.ParquetDataReader(d, 16, tables, rank=rank, world_size=world, limit_batches=2),
                jax_dispatch.get_dataloader("criteo_parquet", "train", 16, limit_batches=2, **kw))


def test_parquet_ranks_partition_the_row_groups(tmp_path):
    """Three ranks over six row groups of 20 rows take two groups each, and
    together every row of the file once."""
    d = str(write_parquet(tmp_path / "pq", files=1, rows=120, groups=20))

    def rows(batches):
        out = []
        for b in batches:
            f = b.sparse_features
            ids = f.values.numpy().reshape(f.num_features, f.batch_size).T
            out += [tuple(x) for x in np.concatenate([b.dense_features.numpy(), ids], axis=1).tolist()]
        return out

    per_rank = [list(parquet.ParquetDataReader(d, 20, [100, 40, 7], rank=r, world_size=3)) for r in range(3)]
    assert [len(b) for b in per_rank] == [2, 2, 2]
    whole = rows(parquet.ParquetDataReader(d, 20, [100, 40, 7]))
    assert sorted(sum((rows(b) for b in per_rank), [])) == sorted(whole) and len(whole) == 120


def test_sampled_parquet_counter_matches_jax(tmp_path):
    d = write_parquet(tmp_path / "pq", files=4)
    files = sorted(str(p) for p in d.glob("*.parquet"))
    for frac in (0.1, 0.5, 1.0):
        got = feature_counter.SampledParquetCounter(files, [100, 40, 7], subsample_fraction=frac).compute()
        want = jax_fc.SampledParquetCounter(files, [100, 40, 7], subsample_fraction=frac).compute()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64 and got.sum() == 3 * 100 * max(1, int(4 * frac))


def test_parquet_without_pyarrow_names_it(tmp_path, monkeypatch):
    """Where pyarrow is missing (the card machine) the reader and the
    counter raise an ImportError that names it."""
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        parquet.ParquetDataReader(str(tmp_path), 4, [10])
    with pytest.raises(ImportError, match="pyarrow"):
        feature_counter.SampledParquetCounter([str(tmp_path / "x.parquet")], [10]).compute()


def test_unknown_source_raises():
    for fn in (dispatch.get_dataloader, jax_dispatch.get_dataloader):
        with pytest.raises(ValueError, match="unknown data source"):
            fn("nope", "train", 4)


def test_random_dataset_and_freq_map_match_jax():
    from cachedembedding_tpu.data.random_rec import RandomRecDataset as JaxRandom

    got, want = RandomRecDataset(TABLES, 16, 3, seed=9, global_ids=False), JaxRandom(TABLES, 16, 3, seed=9,
                                                                                         global_ids=False)
    assert_same(got, want)
    assert len(got) == 3
    np.testing.assert_array_equal(RandomRecDataset(TABLES, 4).id_freq_map(), JaxRandom(TABLES, 4).id_freq_map())


@pytest.mark.parametrize("hash_ids,global_ids", [(True, True), (False, True), (True, False)])
def test_dict_transform_matches_jax(hash_ids, global_ids):
    rng = np.random.default_rng(4)
    cols = {"int_0": rng.random(6), "int_1": rng.random(6), "cat_0": rng.integers(0, 90, 6),
            "cat_1": rng.integers(0, 40, 6), "label": rng.integers(0, 2, 6)}
    args = (["int_0", "int_1"], ["cat_0", "cat_1"], [100, 50])
    kw = dict(hash_ids=hash_ids, global_ids=global_ids)
    assert_same([DictBatchTransform(*args, **kw)(cols)], [JaxTransform(*args, **kw)(cols)])
    with pytest.raises(ValueError):
        DictBatchTransform(["int_0"], ["cat_0"], [1, 2])


def test_prefetch_preserves_order_and_raises_upstream_errors():
    data = RandomRecDataset([50], 4, num_batches=5, dense_in_features=2)
    assert_same(PrefetchIterator(data, depth=2), JaxPrefetch(data, depth=2))
    assert_same(FiniteDataIter(data, depth=1), data)

    def boom():
        yield data.make_batch(0)
        raise RuntimeError("upstream died")

    it = iter(PrefetchIterator(boom(), depth=1))
    next(it)
    with pytest.raises(RuntimeError, match="upstream died"):
        list(it)


def test_timer_on_the_cpu(caplog):
    """No device to wait for on the CPU; the history, the mean with skip,
    reset, stop without start, and get_time_elapsed's log line."""
    t = Timer(device="cpu")
    for _ in range(3):
        t.start()
        sum(range(1000))
        assert t.stop() >= 0.0
    t.start()
    t.stop(keep_in_history=False)
    assert len(t.history) == 3 and t.mean(skip=1) == pytest.approx(sum(t.history[1:]) / 2)
    t.reset()
    assert t.history == [] and t.mean() == 0.0
    with pytest.raises(RuntimeError):
        t.stop()
    log = logging.getLogger("timer-test")
    with caplog.at_level(logging.INFO, logger="timer-test"):
        with get_time_elapsed(log, "a block", device="cpu"):
            pass
    assert "a block, time elapsed:" in caplog.text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Timer()
