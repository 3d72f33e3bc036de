"""Ragged bags in the port against the JAX package, module by module, on the
same numpy inputs: ``RaggedFeatures``' offsets, lengths and segment ids
(exact), ``bag_pool_ragged`` and ``embedding_bag`` with empty bags, values
past the last offset and ``per_sample_weights`` (rtol 1e-6: f32 sums in
another order), the fbgemm-trace replayer's batches (equal), and DLRM's
gather interaction, forward and backward against JAX's custom VJP (f32
within 1e-5; bf16 within one bf16 step of the larger magnitude)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.data import synth as jax_synth
from cachedembedding_tpu.jagged import RaggedFeatures as JaxFeatures
from cachedembedding_tpu.models import dlrm as jax_dlrm
from cachedembedding_tpu_torch.data import synth
from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.models.dlrm import DLRM
from cachedembedding_tpu_torch.ops import embedding_bag as bag
from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np
from cachedembedding_tpu_torch.ops.rounding import astype_storage

jax_bag = importlib.import_module("cachedembedding_tpu.ops.embedding_bag")  # the package exports a function of that name
DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


def _ragged(seed=0, F=3, B=5, C=40, max_len=6, extra=0):
    """Feature-major ragged ids with empty bags, and ``extra`` values past
    the last offset."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, F * B)
    lengths[[0, 4]] = 0
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    values = rng.integers(0, C, offsets[-1] + extra).astype(np.int32)
    return values, offsets, F, B


def _pair(values, offsets, F, B, pooling=None):
    port = RaggedFeatures(torch.from_numpy(values), None if offsets is None else torch.from_numpy(offsets),
                          F, B, pooling)
    ref = JaxFeatures(jnp.asarray(values), None if offsets is None else jnp.asarray(offsets), F, B, pooling)
    return port, ref


@pytest.mark.parametrize("extra", [0, 7], ids=["exact", "values_past_the_last_offset"])
def test_offsets_lengths_and_segment_ids_equal_jax(extra):
    port, ref = _pair(*_ragged(extra=extra))
    np.testing.assert_array_equal(port.offsets_or_implicit().numpy(), np.asarray(ref.offsets_or_implicit()))
    np.testing.assert_array_equal(port.lengths().numpy(), np.asarray(ref.lengths()))
    seg = port.segment_ids()
    assert seg.dtype == torch.int32
    np.testing.assert_array_equal(seg.numpy(), np.asarray(ref.segment_ids()))
    if extra:
        assert (seg.numpy()[-extra:] == port.num_bags).all()


def test_uniform_offsets_and_from_dense_ids_equal_jax():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 50, 4 * 6 * 2).astype(np.int32)
    port, ref = _pair(v, None, 4, 6, 2)
    np.testing.assert_array_equal(port.offsets_or_implicit().numpy(), np.asarray(ref.offsets_or_implicit()))
    np.testing.assert_array_equal(port.segment_ids().numpy(), np.asarray(ref.segment_ids()))
    ids_bf = rng.integers(0, 50, (6, 4)).astype(np.int32)
    a, b = RaggedFeatures.from_dense_ids(torch.from_numpy(ids_bf)), JaxFeatures.from_dense_ids(jnp.asarray(ids_bf))
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    assert (a.num_features, a.batch_size, a.pooling, a.offsets) == (b.num_features, b.batch_size, b.pooling, None)
    with pytest.raises(ValueError, match="offsets"):
        RaggedFeatures(torch.from_numpy(v), None, 4, 6, None).lengths()


def _weight(name, C=40, D=8, seed=2):
    w = np.random.default_rng(seed).standard_normal((C, D)).astype(np.float32)
    return astype_storage(torch.from_numpy(w), getattr(torch, name)), jnp.asarray(w).astype(jnp.dtype(name))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("name", DTYPES)
def test_bag_pool_ragged_matches_jax(name, mode):
    """Empty bags give zeros, values past the last offset are dropped, and a
    mean divides by a count summed in the weight's dtype: bags of up to 40
    ids, past where an e4m3fn (16) or e5m2 (8) count stops. JAX's own mean
    over fp8 rows raises (its fp8 count has no implicit promotion to f32):
    there the port is held to JAX's formula with the count cast to f32."""
    values, offsets, F, B = _ragged(max_len=40, extra=5)
    port, ref = _pair(values, offsets, F, B)
    w, wj = _weight(name)
    got = bag.bag_pool_ragged(w, port.values, port.segment_ids(), F * B, mode=mode)
    seg = ref.segment_ids()
    if mode == "mean" and name.startswith("float8"):
        with pytest.raises(ValueError, match="promotion"):
            jax_bag.bag_pool_ragged(wj, ref.values, seg, F * B, mode=mode)
        total = jax_bag.bag_pool_ragged(wj, ref.values, seg, F * B, mode="sum")
        counts = jax.ops.segment_sum(jnp.ones(values.shape, wj.dtype), seg, num_segments=F * B,
                                     indices_are_sorted=True).astype(jnp.float32)
        assert int(counts.max()) == bag.count_cap(w.dtype) < np.diff(offsets).max()
        want = total / jnp.maximum(counts, 1.0)[:, None]
    else:
        want = jax_bag.bag_pool_ragged(wj, ref.values, seg, F * B, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (F * B, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert (got.numpy()[[0, 4]] == 0).all()


def test_counts_stop_where_the_dtype_rounds_back():
    assert [bag.count_cap(getattr(torch, n)) for n in DTYPES] == [2 ** 24, 256, 16, 8]


def test_per_sample_weights_uniform_and_ragged_match_jax():
    rng = np.random.default_rng(3)
    w, wj = _weight("bfloat16")
    values, offsets, F, B = _ragged(extra=3)
    psw = rng.random(values.shape[0]).astype(np.float32)
    port, ref = _pair(values, offsets, F, B)
    got = bag.embedding_bag(w, port, per_sample_weights=torch.from_numpy(psw))
    want = jax_bag.embedding_bag(wj, ref, per_sample_weights=jnp.asarray(psw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for P in (1, 3):
        v = rng.integers(0, 40, F * B * P).astype(np.int32)
        psw = rng.random(v.shape[0]).astype(np.float32)
        port, ref = _pair(v, None, F, B, P)
        got = bag.embedding_bag(w, port, per_sample_weights=torch.from_numpy(psw))
        want = jax_bag.embedding_bag(wj, ref, per_sample_weights=jnp.asarray(psw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mode='sum'"):
        bag.embedding_bag(w, port, mode="mean", per_sample_weights=torch.from_numpy(psw))


@pytest.mark.parametrize("kind", ["uniform_1", "uniform_3", "ragged"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_dispatch_matches_jax(kind, mode):
    """(B, F, D) from either layout; uniform P == 1 keeps the storage dtype."""
    w, wj = _weight("bfloat16")
    if kind == "ragged":
        port, ref = _pair(*_ragged())
    else:
        P = int(kind[-1])
        v = np.random.default_rng(4).integers(0, 40, 3 * 5 * P).astype(np.int32)
        port, ref = _pair(v, None, 3, 5, P)
    got = bag.embedding_bag(w, port, mode=mode)
    want = jax_bag.embedding_bag(wj, ref, mode=mode)
    assert got.shape == (5, 3, 8) and got.dtype == (torch.bfloat16 if kind == "uniform_1" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-6, atol=1e-6)


def _pools(seed=0, n_tables=3, n_bags=100, max_len=6, rows=500):
    rng = np.random.default_rng(seed)
    traces, sizes = [], []
    for _ in range(n_tables):
        lengths = rng.integers(0, max_len, n_bags)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        ids = np.minimum((rows * rng.random(offsets[-1]) ** 2).astype(np.int64), rows - 1)
        traces.append((ids, offsets))
        sizes.append(rows)
    return traces, sizes


def _same_batches(port_ds, jax_ds):
    for a, b in zip(port_ds, jax_ds):
        fa, fb = a.sparse_features, b.sparse_features
        assert (fa.num_features, fa.batch_size, fa.pooling) == (fb.num_features, fb.batch_size, None)
        np.testing.assert_array_equal(fa.values.numpy(), np.asarray(fb.values))
        np.testing.assert_array_equal(fa.offsets.numpy(), np.asarray(fb.offsets))
        np.testing.assert_array_equal(a.dense_features.numpy(), np.asarray(b.dense_features))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


@pytest.mark.parametrize("batch", [16, 64, 250], ids=["inside_the_pool", "wrapping", "longer_than_the_pool"])
def test_synth_trace_batches_equal_jax(batch):
    """Values, offsets, dense features and labels equal JAX's batch for
    batch, where the bags run past the end of the 100-bag pool and wrap; the
    frequency map too."""
    traces, sizes = _pools()
    for global_ids in (True, False):
        kw = dict(batch_size=batch, num_batches=5, dense_in_features=4, seed=3, global_ids=global_ids)
        a, b = synth.SynthTraceDataset(traces, sizes, **kw), jax_synth.SynthTraceDataset(traces, sizes, **kw)
        assert len(a) == 5
        _same_batches(a, b)
        np.testing.assert_array_equal(a.id_freq_map(), b.id_freq_map())


def test_trace_files_tables_and_compaction_equal_jax(tmp_path):
    """``.npz`` and ``.pt`` trace files load as JAX loads them; compact_ids
    and choose_tables agree; from_dir builds the same dataset."""
    traces, _ = _pools(seed=4, n_tables=2, n_bags=50)
    raw = [(idx * 7919 + 13, off) for idx, off in traces]  # sparse raw ids, as a trace has them
    np.savez(tmp_path / "t0.npz", indices=raw[0][0], offsets=raw[0][1])
    torch.save((torch.from_numpy(raw[1][0]), torch.from_numpy(raw[1][1])), tmp_path / "t1.pt")
    for name in ("t0.npz", "t1.pt"):
        got, want = synth.load_trace(str(tmp_path / name)), jax_synth.load_trace(str(tmp_path / name))
        for x, y in zip(got, want):
            assert x.dtype == np.int64
            np.testing.assert_array_equal(x, y)
    for idx, _ in raw:
        (a, n), (b, m) = synth.compact_ids(idx), jax_synth.compact_ids(idx)
        np.testing.assert_array_equal(a, b)
        assert n == m and a.max() == n - 1
    sizes = [1_000_000, 3_000_000, 60_000_000, 500_000_000, 3_000_000_000]
    for size in synth.DATA_SIZE_TABLES:
        assert synth.choose_tables(sizes, size) == jax_synth.choose_tables(sizes, size)
    assert synth.DATA_SIZE_TABLES == jax_synth.DATA_SIZE_TABLES
    kw = dict(batch_size=32, num_batches=3, data_size="4M", dense_in_features=4)
    a, b = synth.SynthTraceDataset.from_dir(str(tmp_path), **kw), jax_synth.SynthTraceDataset.from_dir(str(tmp_path), **kw)
    assert a.table_sizes == b.table_sizes and len(a.traces) == 2
    _same_batches(a, b)
    os.remove(tmp_path / "t0.npz")
    os.remove(tmp_path / "t1.pt")
    with pytest.raises(FileNotFoundError):
        synth.SynthTraceDataset.from_dir(str(tmp_path), **kw)


def test_sort_plan_is_stable_on_a_flat_ragged_stream():
    """The ragged update's plan sorts a step's flat feature-major stream, the
    order of its gathered rows: stably by row, as numpy's stable argsort."""
    values, _, _, _ = _ragged(seed=6, F=5, B=40, C=30, extra=4)
    perm, grouped, bins = sort_plan_np(values, 30)
    want = np.argsort(values, kind="stable")
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(grouped, values[want])
    assert bins[0] == 0 and bins[-1] == values.shape[0]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", None)])
def test_gather_interaction_matches_jax(dtype, tol):
    """The port's gather interaction against JAX's (``_pairwise_triu_gather``
    with its custom VJP), on the same weights and inputs: logits and the
    grads of the sparse input and of every dense weight within 1e-5 in f32;
    in bf16 within one bf16 step of the larger of the two values (the f32
    sums run in another order, which can flip a bf16 rounding)."""
    arch = dict(embedding_dim=16, num_sparse_features=6, dense_in_features=4,
                dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1))
    rng = np.random.default_rng(7)
    B = 64
    sparse = rng.standard_normal((B, 6, 16)).astype(np.float32)
    dense = rng.standard_normal((B, 4)).astype(np.float32)
    cdt = getattr(torch, dtype)
    model = DLRM(*arch.values(), compute_dtype=cdt, interaction_impl="gather", seed=11)
    s = torch.from_numpy(sparse).requires_grad_(True)
    out = model(torch.from_numpy(dense), s)
    out.sum().backward()
    params = jax_dlrm.init_dlrm_dense(11, *arch.values())
    jax_dlrm.INTERACTION_IMPL = "gather"
    try:
        f = lambda p, x: jax_dlrm.dlrm_dense_forward(p, jnp.asarray(dense), x, jnp.dtype(dtype))
        ref = f(params, jnp.asarray(sparse))
        gp, gs = jax.grad(lambda p, x: f(p, x).sum(), argnums=(0, 1))(params, jnp.asarray(sparse))
    finally:
        jax_dlrm.INTERACTION_IMPL = "bmm"

    def close(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if tol is not None:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        else:
            step = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126))) - 7)
            assert np.all(np.abs(a - b) <= step + 1e-6)

    close(out.detach().numpy(), ref)
    close(s.grad.numpy(), gs)
    for arch_name in ("dense_arch", "over_arch"):
        for g, lin in zip(getattr(gp, arch_name), getattr(model, arch_name)):
            close(lin.weight.grad.numpy().T, g["w"])
            close(lin.bias.grad.numpy(), g["b"])
    # and the bmm interaction computes the same function
    bmm = DLRM(*arch.values(), compute_dtype=cdt, interaction_impl="bmm", seed=11)
    close(bmm(torch.from_numpy(dense), torch.from_numpy(sparse)).detach().numpy(), out.detach().numpy())


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bare_modules_look_up_ragged_bags(mode):
    """``CachedEmbeddingBag.prepare_ids`` then ``lookup`` on ragged
    features, and the fully resident table's ``lookup``, against JAX's
    ``embedding_bag`` on the same table (the cache: f32 rows, exact
    transfers) and JAX's resident table."""
    from cachedembedding_tpu.baselines.full_resident import FullyResidentEmbeddingBag as JaxResident
    from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
    from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag

    sizes = [300, 200]
    values, offsets, F, B = _ragged(seed=8, F=2, B=16, C=500, extra=3)
    emb = CachedEmbeddingBag(500, 16, mode=mode, cache_ratio=0.5, table_sizes=sizes, device="cpu")
    table = np.array(emb.host_table.array)
    slots = emb.prepare_ids(torch.from_numpy(values))
    got = emb.lookup(RaggedFeatures(slots.to(torch.int32), torch.from_numpy(offsets), F, B))
    emb.close()
    want = jax_bag.embedding_bag(jnp.asarray(table), JaxFeatures(jnp.asarray(values), jnp.asarray(offsets), F, B),
                                 mode=mode)
    assert got.shape == (B, F, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    port, ref = _pair(values, offsets, F, B)
    res = FullyResidentEmbeddingBag(500, 16, mode=mode, table_sizes=sizes, dtype="bfloat16", device="cpu")
    jres = JaxResident(500, 16, mode=mode, table_sizes=sizes, dtype=jnp.bfloat16)
    np.testing.assert_allclose(res.lookup(port).numpy(), np.asarray(jres.lookup(ref)), rtol=1e-6, atol=1e-6)
