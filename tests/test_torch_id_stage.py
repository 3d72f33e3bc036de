"""The device planner's host id path (``cache/manager.py``
``_host_ids_to_device``): a window's int32 ids, one array per batch, copied
back to back in one native pass (``_native/hostops.py``
``concat_minmax_i32``) that also takes their min and max, into a buffer that
the host-to-device copy reads.

On the CPU: the pass against ``np.concatenate(...).astype(np.int32)`` and
numpy's min and max; the range check on the pass's min and max, made before
anything is planned; ids of other dtypes checked before their cast; the
trainer on windows of three sizes against the concatenated path it
replaced. The ``chip`` tests hold the two pinned buffers' reuse on the card,
and the admits' staging pass (``tests/test_torch_admit_stage.py``) against
the torch path it replaced: run them there with ``python3 -m pytest
tests/test_torch_id_stage.py -m chip --noconftest`` (this file imports no
JAX)."""

import types

import numpy as np
import pytest
import torch

from admit_stage_ref import parent_finish_prepare
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache import manager
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synth import SynthTraceDataset
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

N = 100_000

# lengths of each window's arrays
WINDOWS = {
    "uniform": (700, 700, 700, 700),
    "ragged": (468, 1, 2048, 95, 700),
    "one_array": (5000,),
    "empty_among_others": (0, 300, 0, 0, 4100, 0),
    "all_empty": (0, 0),
}


def _parts(lengths, seed=0, lo=0, hi=N):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, size=n).astype(np.int32) for n in lengths]


def _bag(device="cpu", **kw):
    return CachedEmbeddingBag(N, 8, device=device, cache_ratio=0.5, warmup_ratio=0.0, buffer_size=0,
                              planner="device", **kw)


@pytest.mark.parametrize("case", list(WINDOWS))
def test_one_pass_equals_concatenation_and_numpy_min_max(case):
    """The native pass writes the arrays back to back, bit for bit
    ``np.concatenate(...).astype(np.int32)``, leaves the rest of the
    destination alone, and returns numpy's min and max (and (2**31 - 1,
    -2**31) for no ids); int32 ids of either sign, the extremes at the
    ends of arrays."""
    parts = _parts(WINDOWS[case], lo=-2**30, hi=2**30)
    full = [p for p in parts if p.size]
    if full:
        full[0][-1], full[-1][0] = 2**31 - 1, -2**31
    want = np.concatenate(parts).astype(np.int32)
    out = np.full((want.size + 5,), 7, np.int32)
    lo, hi = hostops.concat_minmax_i32(parts, out)
    np.testing.assert_array_equal(out[: want.size], want)
    assert (out[want.size:] == 7).all()
    if want.size:
        assert (lo, hi) == (int(want.min()), int(want.max()))
    else:
        assert (lo, hi) == (2**31 - 1, -2**31)


@pytest.mark.parametrize("case", [c for c in WINDOWS if c != "all_empty"])
def test_begin_prepare_on_a_windows_arrays_plans_as_on_their_concatenation(case):
    """``begin_prepare`` on the window's arrays and on their int64
    concatenation (the path that checks, then casts): the same slot ids,
    state and plan; only the arrays take the one pass."""
    fused, cast = _bag(), _bag()
    for w in range(2):  # the second window meets a cache in use
        parts = _parts(WINDOWS[case], seed=w)
        a = fused.begin_prepare(parts)
        b = cast.begin_prepare(np.concatenate(parts).astype(np.int64))
        fused.finish_prepare(a)
        cast.finish_prepare(b)
        torch.testing.assert_close(a.slot_ids, b.slot_ids, rtol=0, atol=0)
        torch.testing.assert_close(a.host_indices, b.host_indices, rtol=0, atol=0)
        for x, y in zip(fused.state, cast.state):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert fused.stats.id_stage_windows == 2 and cast.stats.id_stage_windows == 0
    assert fused.stats.h2d_bytes == cast.stats.h2d_bytes
    assert fused.stats.id_stage_waits == 0  # nothing to wait for on the CPU
    fused.close()
    cast.close()


@pytest.mark.parametrize("bad", [-3, N, 2**31 - 1], ids=["negative", "past_the_end", "int32_max"])
def test_bad_id_in_the_last_array_raises_before_any_plan(bad, monkeypatch):
    """A bad id in a window's last array: the JAX package's device-planner
    message, raised before ``plan_ids`` runs; the state and counts are
    unchanged, and the next good window plans as it would have."""
    good = _parts((300, 300, 300), seed=3)
    bad_window = _parts((300, 300, 300), seed=4)
    bad_window[-1][-1] = bad
    after = _parts((300, 300, 300), seed=5)
    got, ref = _bag(), _bag()
    for bag in (got, ref):
        bag.finish_prepare(bag.begin_prepare(good))
    state = tuple(t.clone() for t in got.state)
    stats = dict(vars(got.stats))
    planned = []
    plan_ids = manager.plan_ids
    monkeypatch.setattr(manager, "plan_ids", lambda *a, **k: planned.append(1) or plan_ids(*a, **k))
    with pytest.raises(ValueError) as err:
        got.begin_prepare(bad_window)
    assert str(err.value) == f"id out of range: {bad} not in [0, {N}) — check table-size/hash configuration"
    assert not planned
    assert vars(got.stats) == stats
    for x, y in zip(got.state, state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    a, b = got.begin_prepare(after), ref.begin_prepare(after)
    got.finish_prepare(a)
    ref.finish_prepare(b)
    torch.testing.assert_close(a.slot_ids, b.slot_ids, rtol=0, atol=0)
    for x, y in zip(got.state, ref.state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    got.close()
    ref.close()


@pytest.mark.parametrize("bad", [2**31, 2**32 + 3])
def test_int64_ids_outside_int32_raise_and_do_not_wrap(bad):
    """``prepare_ids`` on int64 ids: checked before the int32 cast, so an
    id that would wrap (2**32 + 3 casts to 3) still raises, naming the id
    itself."""
    bag = _bag()
    ids = np.array([3, 17, bad, 500], np.int64)
    with pytest.raises(ValueError, match=f"id out of range: {bad} not in"):
        bag.prepare_ids(ids)
    assert bag.stats.prepare_calls == 0 and bag.stats.id_stage_windows == 0
    bag.close()


def _parent_path(self, ids):
    """The host id path this one replaced: the window's arrays concatenated
    (the trainer did that), scanned twice for the range check, cast to int32
    and copied."""
    ids_np = np.concatenate(ids) if isinstance(ids, list) else np.asarray(ids).reshape(-1)
    self._check_range(ids_np, device_planner=True)
    return self.to_device(ids_np.astype(np.int32))


def _train(ragged: bool, parent: bool, monkeypatch):
    """Five training batches in windows of 3 and 2 batches, then two
    one-batch evaluation windows (ragged: each batch of its own length);
    losses, AUROC, flushed rows, counts and each window's id count."""
    sizes = [500, 500, 500]
    stage = _parent_path if parent else CachedEmbeddingBag._host_ids_to_device
    window_ids = []

    def recording(self, ids):
        window_ids.append(sum(np.asarray(p).size for p in ids))
        return stage(self, ids)

    monkeypatch.setattr(CachedEmbeddingBag, "_host_ids_to_device", recording)
    cfg = DLRMConfig(num_embeddings_per_feature=sizes, embedding_dim=16, dense_in_features=4,
                     dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1), batch_size=64,
                     learning_rate=0.5, cache=CacheConfig(cache_ratio=0.7, warmup_ratio=0.0, buffer_size=0,
                                                          prefetch_num=3, use_lfu_eviction=True, use_freq=False,
                                                          planner="device", cache_dtype="float32",
                                                          resident_threshold=0))
    if ragged:
        rng = np.random.default_rng(5)
        traces = []
        for n in sizes:
            offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 6, 4096))])
            traces.append((np.minimum((n * rng.random(offsets[-1]) ** 2).astype(np.int64), n - 1), offsets))

        def data(n, seed):
            return SynthTraceDataset(traces, sizes, batch_size=64, num_batches=n, dense_in_features=4, seed=seed)
    else:
        def data(n, seed):
            return SyntheticLongTailDataset(sizes, 64, n, dense_in_features=4, skew=0.5, seed=seed)

    train = data(5, 7)
    tr = CachedDLRMTrainer(cfg, device="cpu")
    rep = tr.train(train, num_iters=5)
    ev = tr.evaluate(data(2, 99))
    ids = np.unique(np.concatenate([np.asarray(b.sparse_features.values) for b in train])).astype(np.int64)
    tr.embed.flush()
    st = tr.embed.stats
    out = dict(losses=np.asarray(rep.losses), auroc=ev["auroc"], rows=tr.embed.host_table.gather(ids),
               counts=(st.num_hits_history, st.num_miss_history, st.num_write_back_history, st.h2d_bytes),
               id_stage_windows=st.id_stage_windows, window_ids=window_ids)
    tr.close()
    return out


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_trainer_on_windows_of_three_sizes_matches_the_concatenated_path(ragged, monkeypatch):
    """The trainer on the device planner, windows of three sizes (3 and 2
    training batches, 1 evaluation batch): losses, AUROC, flushed rows and
    counts bit-equal to the path that concatenated, scanned and cast; every
    window takes the one pass."""
    got = _train(ragged, False, monkeypatch)
    ref = _train(ragged, True, monkeypatch)
    assert got["window_ids"] == ref["window_ids"] and len(got["window_ids"]) == 4
    assert len(set(got["window_ids"])) == 3, got["window_ids"]
    np.testing.assert_array_equal(got["losses"], ref["losses"])
    assert got["auroc"] == ref["auroc"]
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    assert got["counts"] == ref["counts"]
    assert got["id_stage_windows"] == 4 and ref["id_stage_windows"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.chip
def test_pinned_buffers_are_reused_and_waited_for_on_the_card(card):
    """Four windows in a row: the first two fill the two pinned buffers,
    the next two reuse them where they lie; the ids read back from the card
    equal the host's, and with each window's copy run before the next
    window, no reuse waits. Then a copy held back behind a sleep on the
    stream: the buffer's next reuse waits for it (one wait counted), and
    both windows reach the card intact."""
    bag = _bag(card)
    windows = [_parts((700, 513, 700, 1), seed=s) for s in range(4)]
    ptrs = []
    for parts in windows:
        ids_dev = bag._host_ids_to_device(parts)
        torch.cuda.synchronize(card)
        assert ids_dev.device == card and ids_dev.dtype == torch.int32
        np.testing.assert_array_equal(ids_dev.cpu().numpy(), np.concatenate(parts))
        ptrs.append(bag._id_stage.bufs[(len(ptrs)) % 2][0].data_ptr())
    assert ptrs[2:] == ptrs[:2] and ptrs[0] != ptrs[1]
    assert bag.stats.id_stage_windows == 4 and bag.stats.id_stage_waits == 0
    a, b, c = (_parts((1914,), seed=s) for s in (10, 11, 12))
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the stream before the next copy
    held = bag._host_ids_to_device(a)
    bag._host_ids_to_device(b)
    third = bag._host_ids_to_device(c)  # the buffer of ``a``, whose copy is still held
    assert bag.stats.id_stage_waits == 1
    torch.cuda.synchronize(card)
    np.testing.assert_array_equal(held.cpu().numpy(), a[0])
    np.testing.assert_array_equal(third.cpu().numpy(), c[0])
    # a window larger than the buffers grows the one it takes
    big = _parts((5000, 3000), seed=13)
    np.testing.assert_array_equal(bag._host_ids_to_device(big).cpu().numpy(), np.concatenate(big))
    assert bag._id_stage.bufs[0][0].numel() == 8000 or bag._id_stage.bufs[1][0].numel() == 8000
    bag.close()


@pytest.mark.chip
def test_admits_reach_the_card_bit_equal_to_the_torch_path(card):
    """The device planner's admits on the card (``tests/test_torch_admit_stage.py``
    holds them on the CPU): two bags of 128-wide bf16 rows over a virtual
    table, bf16 transfers, row-wise Adagrad, a cache that evicts and admits
    rows again, in chunks of 1,000; one bag on the staging pass, the other
    on the parent's admit loop (host f32 gather, torch's cast, a pinned
    copy). Each window's rows and accumulators are moved alike on both; the
    cache rows and accumulators stay bit-equal after every window, and the
    host table and store after ``flush``; every chunk takes the pass and no
    buffer reuse waits."""
    bags = [CachedEmbeddingBag(N, 128, device=card, cache_ratio=0.03, warmup_ratio=0.0, buffer_size=1000,
                               planner="device", optimizer="rowwise_adagrad", weight_init="virtual",
                               dtype=torch.bfloat16, transfer_dtype="bfloat16") for _ in range(2)]
    bags[1].finish_prepare = types.MethodType(parent_finish_prepare, bags[1])
    rng = np.random.default_rng(21)
    touched = []
    for w in range(12):
        ids = (N * rng.random(3000) ** 3).astype(np.int32)
        touched.append(ids)
        for bag in bags:
            slots = bag.prepare_ids(ids).long()
            bag.cache_weight.index_add_(0, slots, torch.full((slots.numel(), 128), 0.0625, dtype=torch.bfloat16,
                                                             device=card))
            bag.cache_accum.index_add_(0, slots, torch.full((slots.numel(),), 0.5, device=card))
        assert torch.equal(bags[0].cache_weight, bags[1].cache_weight), w
        assert torch.equal(bags[0].cache_accum, bags[1].cache_accum), w
    st = bags[0].stats
    assert sum(st.num_write_back_history) > 0
    assert st.admit_stage_chunks == sum(-(-m // 1000) for m in st.num_miss_history) > 12
    assert st.admit_stage_waits == 0
    rows = np.unique(np.concatenate(touched)).astype(np.int64)
    for bag in bags:
        bag.flush()
    np.testing.assert_array_equal(bags[0].host_table.gather(rows), bags[1].host_table.gather(rows))
    np.testing.assert_array_equal(bags[0].host_accum.gather(rows), bags[1].host_accum.gather(rows))
    for bag in bags:
        bag.close()
