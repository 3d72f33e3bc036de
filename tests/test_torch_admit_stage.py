"""The device planner's admits (``cache/manager.py`` ``finish_prepare``):
each chunk's rows gathered by one multithreaded native pass
(``_native/hostops.cpp`` ``overlay_gather_rows`` for a virtual table,
``gather_rows`` for a dense one) straight into a reused buffer in the rows'
transfer dtype, bf16 rounded to nearest even on the way; their row-wise
Adagrad accumulators by one call that fills in the store's default
(``overlay_gather_or_fill``).

On the CPU: the pass against a dense canonical table and against torch's
``.to(dtype)``; the rounding on every f32 of five low halves; the
accumulators against a numpy mirror; ``StagingTurns``' reuse and waits; the
trainer with evictions and re-admits under row-wise Adagrad against the
admit loop the pass replaced (``tests/admit_stage_ref.py``). The card test
is in ``tests/test_torch_id_stage.py``."""

import types

import numpy as np
import pytest
import torch

from admit_stage_ref import parent_finish_prepare
from cachedembedding_tpu_torch.cache.host_table import (
    DenseAccumStore,
    DenseHostTable,
    OverlayAccumStore,
    VirtualHostTable,
)
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag, StagingTurns, default_table_init
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

SIZES = [64, 1000, 5000, 37]
N, DIM, SEED = sum(SIZES), 16, 11
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tables(col_start: int = 0):
    """A virtual table and a dense table of the same canonical rows (columns
    from ``col_start``), with the same rows written back; the dense array
    as it should read."""
    virtual = VirtualHostTable(SIZES, DIM, seed=SEED, capacity_hint=64, col_start=col_start)
    arr = np.empty((N, DIM), np.float32)
    default_table_init(SIZES, SEED, col_start)(arr)
    dense = DenseHostTable(arr.copy(), procedural_seed=SEED, table_sizes=SIZES)
    rng = np.random.default_rng(4)
    written = np.unique(np.concatenate([rng.integers(0, N, 900), [0, N - 1, 63, 64]])).astype(np.int64)
    vals = (rng.standard_normal((written.size, DIM)) * 0.3).astype(np.float32)
    for t in (virtual, dense):
        t.scatter(written, vals)
    arr[written] = vals
    return virtual, dense, arr, written


def _ids(case: str, written: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(8)
    if case == "written":
        return rng.permutation(written)[:500]
    if case == "never_written":
        return np.setdiff1d(rng.integers(0, N, 3000), written)[:700]
    if case == "first_and_last_tables":
        return np.concatenate([np.arange(0, 64), np.arange(N - 37, N), [63, 64, N - 38]]).astype(np.int64)
    if case == "mixed":
        return rng.integers(0, N, 5000)
    return np.zeros((0,), np.int64)


CASES = ["written", "never_written", "first_and_last_tables", "mixed", "empty"]


@pytest.mark.parametrize("col_start", [0, 3], ids=["all_columns", "from_column_3"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["virtual", "dense"])
def test_rows_pass_equals_the_torch_cast(kind, dtype, case, col_start):
    """The pass into a (n, dim) tensor of the rows' dtype equals
    ``torch.from_numpy(host_table.gather(rows)).to(dtype)`` bit for bit, and
    the f32 gather equals the dense canonical table with the written rows
    in place (each unwritten row made with its own table's bound)."""
    virtual, dense, arr, written = _tables(col_start)
    table = virtual if kind == "virtual" else dense
    ids = _ids(case, written).astype(np.int64)
    np.testing.assert_array_equal(table.gather(ids), arr[ids])
    out = torch.full((ids.size, DIM), 7.0, dtype=DTYPES[dtype])
    assert table.gather(ids, out=out) is out
    want = torch.from_numpy(table.gather(ids)).to(DTYPES[dtype])
    assert torch.equal(out.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       want.view(torch.int16 if dtype == "bfloat16" else torch.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["virtual", "dense"])
def test_rows_pass_on_a_width_past_the_vector_and_unaligned_rows(kind, dtype):
    """20 columns (a vector's worth and a scalar tail) into rows that start
    at every alignment: the rows equal the torch cast of the f32 gather."""
    sizes = [700, 3000]
    virtual = VirtualHostTable(sizes, 20, seed=3, capacity_hint=64)
    arr = np.empty((sum(sizes), 20), np.float32)
    default_table_init(sizes, 3)(arr)
    table = virtual if kind == "virtual" else DenseHostTable(arr)
    rng = np.random.default_rng(6)
    written = np.unique(rng.integers(0, sum(sizes), 300)).astype(np.int64)
    table.scatter(written, rng.standard_normal((written.size, 20)).astype(np.float32))
    ids = np.concatenate([written[:100], rng.integers(0, sum(sizes), 100)]).astype(np.int64)
    buf = torch.zeros((ids.size + 1, 20), dtype=DTYPES[dtype])
    table.gather(ids, out=buf[1:])
    assert torch.equal(buf[1:], torch.from_numpy(table.gather(ids)).to(DTYPES[dtype]))
    assert not buf[0].any()


@pytest.mark.parametrize("kind", ["virtual", "dense"])
def test_rows_pass_writes_into_a_slice_and_refuses_bad_destinations(kind):
    """Rows land in a slice of a larger buffer, leaving the rest alone; a
    destination of another shape, dtype or layout raises."""
    virtual, dense, arr, written = _tables()
    table = virtual if kind == "virtual" else dense
    ids = written[:40]
    buf = torch.zeros((100, DIM), dtype=torch.bfloat16)
    table.gather(ids, out=buf[30:70])
    assert torch.equal(buf[30:70], torch.from_numpy(arr[ids]).to(torch.bfloat16))
    assert not buf[:30].any() and not buf[70:].any()
    for bad in (torch.empty((39, DIM), dtype=torch.bfloat16), torch.empty((40, DIM), dtype=torch.float16),
                torch.empty((DIM, 40), dtype=torch.float32).t(), np.empty((40, DIM), np.float64)):
        with pytest.raises(ValueError, match="out must be"):
            table.gather(ids, out=bad)


@pytest.mark.parametrize("low", [0x0000, 0x7FFF, 0x8000, 0x8001, 0xFFFF], ids=lambda v: f"low_{v:04x}")
def test_bf16_rounding_of_every_high_half(low):
    """Every f32 with these low 16 bits, over all 65,536 high halves (ties,
    infinities, subnormals and both signs among them): the bf16 rows of a
    dense gather and of an overlay's written rows equal torch's
    ``.to(torch.bfloat16)`` bit for bit on every non-NaN value; a NaN stays
    a NaN."""
    bits = (np.arange(65536, dtype=np.uint32) << 16) | np.uint32(low)
    rows = bits.view(np.float32).reshape(-1, DIM)
    ids = np.arange(rows.shape[0], dtype=np.int64)
    want = torch.from_numpy(rows).to(torch.bfloat16)
    nan = np.isnan(rows)
    assert nan.any() and np.isinf(rows).any() == (low == 0)
    overlay = VirtualHostTable([rows.shape[0]], DIM, seed=1, capacity_hint=rows.shape[0])
    overlay.scatter(ids, rows)
    for table in (DenseHostTable(rows.copy()), overlay):
        out = torch.empty(rows.shape, dtype=torch.bfloat16)
        table.gather(ids[::-1].copy(), out=out)
        out = out.flip(0)
        got, ref = out.view(torch.int16).numpy(), want.view(torch.int16).numpy()
        np.testing.assert_array_equal(got[~nan], ref[~nan])
        assert torch.isnan(out.float()).numpy()[nan].all()


@pytest.mark.parametrize("initial", [0.0, 0.1])
def test_accumulator_call_fills_in_the_default(initial):
    """``OverlayAccumStore.gather`` (one probe a row) against a numpy mirror
    and against ``DenseAccumStore``, for written and never-written rows, the
    store grown past its first capacity, into a new array and into a slice
    of a buffer."""
    store = OverlayAccumStore(initial, capacity_hint=16)
    dense = DenseAccumStore(N, initial)
    mirror = np.full((N,), initial, np.float32)
    rng = np.random.default_rng(2)
    for _ in range(3):
        rows = np.unique(rng.integers(0, N, 400)).astype(np.int64)
        vals = rng.random(rows.size).astype(np.float32)
        for s in (store, dense):
            s.scatter(rows, vals)
        mirror[rows] = vals
    ids = rng.integers(0, N, 3000).astype(np.int64)
    assert 0 < np.isin(ids, store.written_rows()).mean() < 1
    for s in (store, dense):
        np.testing.assert_array_equal(s.gather(ids), mirror[ids])
        buf = np.full((3100,), -1.0, np.float32)
        s.gather(ids, out=buf[50:3050])
        np.testing.assert_array_equal(buf[50:3050], mirror[ids])
        assert (buf[:50] == -1).all() and (buf[3050:] == -1).all()
    assert store.gather(np.zeros((0,), np.int64)).shape == (0,)
    with pytest.raises(ValueError, match="out must be"):
        store.gather(ids, out=np.empty((ids.size,), np.float64))


class _Event:
    def __init__(self, done: bool):
        self.done, self.waits = done, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


def test_staging_turns_reuse_and_waits():
    """Two buffers in turns: each reused where it lies once its event has
    run; a reuse whose copy has not run waits for it and says so; on the
    CPU a fresh tensor every time and no event."""
    cpu = StagingTurns(torch.float32, on_cuda=False)
    a, ev, waited = cpu.take(10)
    b, _, _ = cpu.take(10)
    assert ev is None and not waited and a.data_ptr() != b.data_ptr() and a.shape == (10,)
    turns = StagingTurns(torch.float32, on_cuda=False)
    turns.on_cuda = True  # pinned buffers large enough already, events standing in for CUDA's
    events = [_Event(True), _Event(False)]
    turns.bufs = [(torch.empty((100,)), events[0]), (torch.empty((100,)), events[1])]
    ptrs = [buf.data_ptr() for buf, _ in turns.bufs]
    got = [turns.take(60) for _ in range(4)]
    assert [w for _, _, w in got] == [False, True, False, False]
    assert [e for _, e, _ in got] == events * 2 and [e.waits for e in events] == [0, 1]
    assert [b.data_ptr() for b, _, _ in got] == ptrs * 2 and all(b.shape == (60,) for b, _, _ in got)


def _trainer(table: str, transfer: str, parent: bool) -> CachedDLRMTrainer:
    """Row-wise Adagrad on the device planner, a cache of 1% (243 slots,
    evicting from the third window on), admits in chunks of 50 rows."""
    cfg = DLRMConfig(num_embeddings_per_feature=[50, 300, 4000, 20000], embedding_dim=16, dense_in_features=4,
                     dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1), batch_size=64,
                     learning_rate=0.1, embedding_optimizer="rowwise_adagrad", adagrad_initial=0.01,
                     cache=CacheConfig(cache_ratio=0.01, warmup_ratio=0.0, buffer_size=50, prefetch_num=2,
                                       use_freq=False, use_lfu_eviction=True, planner="device",
                                       cache_dtype="bfloat16", transfer_dtype=transfer, weight_init=table,
                                       resident_threshold=0))
    tr = CachedDLRMTrainer(cfg, device="cpu")
    if parent:
        tr.embed.finish_prepare = types.MethodType(parent_finish_prepare, tr.embed)
    return tr


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", ["virtual", "uniform"])
def test_trainer_with_evictions_matches_the_parent_admit_loop(table, transfer):
    """Six windows that evict and admit rows again, under row-wise Adagrad:
    losses, cache rows and accumulators after training, and the host table
    and store after ``flush``, bit-equal to the parent's admit loop; the
    same link and swap bytes; every chunk counted, no wait on the CPU."""
    data = SyntheticLongTailDataset([50, 300, 4000, 20000], 64, 12, dense_in_features=4, skew=0.5, seed=7)
    out = {}
    for parent in (False, True):
        tr = _trainer(table, transfer, parent)
        rep = tr.train(data, num_iters=12)
        e = tr.embed
        live = (e.cache_weight.clone(), e.cache_accum.clone())
        e.flush()
        rows = np.arange(e.num_embeddings, dtype=np.int64)
        st = e.stats
        out[parent] = dict(losses=rep.losses, live=live, rows=e.host_table.gather(rows),
                           accum=e.host_accum.gather(rows), misses=list(st.num_miss_history),
                           wb=list(st.num_write_back_history), bytes=(st.h2d_bytes, st.d2h_bytes, st.swap_in_bytes),
                           chunks=st.admit_stage_chunks, waits=st.admit_stage_waits)
        tr.close()
    got, ref = out[False], out[True]
    assert sum(got["wb"]) > 0 and max(got["misses"]) > 50  # evictions, and windows of several chunks
    assert got["losses"] == ref["losses"]
    for a, b in zip(got["live"], ref["live"]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    np.testing.assert_array_equal(got["accum"], ref["accum"])
    assert (got["accum"] != 0.01).sum() > 100
    assert got["misses"] == ref["misses"] and got["wb"] == ref["wb"] and got["bytes"] == ref["bytes"]
    assert got["chunks"] == sum(-(-m // 50) for m in got["misses"]) and ref["chunks"] == 0
    assert got["waits"] == 0


def test_buffer_waits_are_counted(monkeypatch):
    """Each window's rows and accumulators take one buffer each; a take
    that had to wait adds to ``admit_stage_waits``."""
    bag = CachedEmbeddingBag(2000, 8, device="cpu", cache_ratio=0.5, warmup_ratio=0.0, buffer_size=100,
                             planner="device", optimizer="rowwise_adagrad", weight_init="virtual")
    taken = []

    def waiting_take(self, n, grow_to=0):
        taken.append(self.dtype)
        return torch.empty((n,), dtype=self.dtype), None, True

    monkeypatch.setattr(StagingTurns, "take", waiting_take)
    ids = np.random.default_rng(0).integers(0, 2000, 700).astype(np.int32)
    bag.prepare_ids(ids)
    n_miss = bag.stats.num_miss_history[-1]
    assert n_miss > 200 and bag.stats.admit_stage_chunks == -(-n_miss // 100)
    assert taken == [torch.int32, torch.float32, torch.float32]
    assert bag.stats.id_stage_waits == 1 and bag.stats.admit_stage_waits == 2
    assert "admit_stage_chunks=" in bag.stats.summary() and "admit_stage_waits=2" in bag.stats.summary()
    bag.close()
