"""The port's device ops against the JAX package's on the same numpy inputs:
the canonical row generator, the row gather (Kernel 1's plain version against
``gather_rows_pallas`` in interpret mode), the fused binned SGD update
(Kernel 2's plain version against ``binned_sgd_update(interpret=True)``) and
the embedding-bag lookup, alone and behind the cache. On CPU tensors the kernel wrappers run their plain
versions, which is what these tests exercise."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cachedembedding_tpu._native import hostops as jax_hostops
from cachedembedding_tpu.jagged import RaggedFeatures as JaxFeatures
from cachedembedding_tpu.ops.binned_scatter import binned_sgd_update as jax_binned_sgd_update
from cachedembedding_tpu.ops.binned_scatter import sort_plan_np as jax_sort_plan
from cachedembedding_tpu.ops.embedding_bag import embedding_bag as jax_embedding_bag
from cachedembedding_tpu.ops.pallas_bag import gather_rows_pallas
from cachedembedding_tpu.ops.synth_rows import synth_rows as jax_synth_rows
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan_np
from cachedembedding_tpu_torch.ops.embedding_bag import embedding_bag
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.ops.synth_rows import scatter_synth_admits, synth_rows

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def test_synth_rows_bit_exact():
    """Bit-exact with the JAX package's device generator and its C++ fill
    (both round fma(h>>8, scale, -bound) once). Its numpy fallback rounds the
    multiply and the subtract separately, so it is held to one f32 ulp."""
    rng = np.random.default_rng(0)
    rows = np.concatenate([[0, 1, 7, 2**30, 2**31 - 1], rng.integers(0, 2**31 - 1, 3000)]).astype(np.int32)
    bounds = rng.uniform(1e-4, 1.0, rows.shape[0]).astype(np.float32)
    got = synth_rows(torch.from_numpy(rows), torch.from_numpy(bounds), 1234, 64).numpy()
    ref = np.asarray(jax_synth_rows(jnp.asarray(rows), jnp.asarray(bounds), jnp.uint32(1234), 64))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    slab = np.empty((500, 64), np.float32)
    jax_hostops.fill_rows_canonical(slab, 40, seed=1234, bound=0.3)
    mine = synth_rows(torch.arange(40, 540), torch.full((500,), 0.3), 1234, 64).numpy()
    np.testing.assert_array_equal(mine.view(np.uint32), slab.view(np.uint32))
    npref = jax_hostops.gen_rows_canonical(rows.astype(np.int64), 1234, bounds, 64)
    np.testing.assert_allclose(got, npref, rtol=0, atol=float(np.spacing(np.float32(1.0))))


def test_scatter_synth_admits_chunks():
    cw = torch.zeros((50, 8), dtype=torch.bfloat16)
    slots = torch.tensor([3, 9, 40, 41, 0])
    rows = torch.tensor([5, 6, 7, 8, 9])
    bounds = torch.full((5,), 0.25)
    scatter_synth_admits(cw, slots, rows, bounds, seed=3, chunk=2)
    ref = synth_rows(rows, bounds, 3, 8).to(torch.bfloat16)
    assert torch.equal(cw[slots], ref)
    assert torch.count_nonzero(cw[[1, 2, 4]]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    C, D, L = 3000, 128, 2048  # L a multiple of the Pallas tile (1024)
    w = rng.standard_normal((C, D)).astype(np.float32).astype(_NDT[dtype])
    ids = rng.integers(0, C, size=L).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gather_rows_pallas(jnp.asarray(w), jnp.asarray(ids)))
    got = gather_rows(torch.from_numpy(w.astype(np.float32)).to(_TDT[dtype]), torch.from_numpy(ids))
    assert got.shape == (L, 1, D)
    np.testing.assert_array_equal(got.reshape(L, D).float().numpy(), ref.astype(np.float32))


def test_gather_lands_in_bfd_layout():
    """Output row (n, f) reads ids[f * N + n]: the (B, F, D) layout with no
    transpose, for any L (no multiple-of-tile restriction)."""
    rng = np.random.default_rng(2)
    C, D, F, N = 500, 16, 3, 37
    w = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, C, size=F * N).astype(np.int32))
    got = gather_rows(w, ids, F)
    ref = w[ids.long()].reshape(F, N, D).transpose(0, 1)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        gather_rows(w, ids[:-1], F)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the magnitude of x (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _sgd_case(name, rng):
    if name == "uniform":
        L, C = 3000, 1500
        v = rng.integers(0, C, size=L)
    elif name == "heavy_duplicates":  # 80% of ids in [0, 8): one bin holds most
        L, C = 8192, 512
        v = np.concatenate([rng.integers(0, 8, int(L * 0.8)), rng.integers(0, C, L - int(L * 0.8))])
        rng.shuffle(v)
    else:  # empty bins, rows not a multiple of the bin height
        L, C = 777, 1000
        v = rng.choice([3, 4, 700, 999], size=L)
    return v.astype(np.int32), C


@pytest.mark.parametrize("case", ["uniform", "heavy_duplicates", "empty_bins"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binned_sgd_update_matches_jax(case, dtype):
    """Untouched rows are bit-equal. Touched rows: rtol 1e-5 / atol 1e-4 at
    f32 and one bf16 ulp at bf16 — the f32 sums are taken in different orders
    (and over different bin heights: 64 here, 512 in the JAX package). Where
    cw - slr*acc cancels to near zero, the f32 roundings of the O(1) terms
    (1e-5 absolute) exceed a bf16 ulp of the tiny result, so that is added."""
    rng = np.random.default_rng(3)
    v, C = _sgd_case(case, rng)
    D, lr = 128, 0.37
    g = rng.standard_normal((v.shape[0], D)).astype(np.float32).astype(_NDT[dtype])
    cw = rng.standard_normal((C, D)).astype(np.float32).astype(_NDT[dtype])
    jp, jg, jb = jax_sort_plan(v, C)
    ref = np.asarray(
        jax_binned_sgd_update(
            jnp.asarray(cw), jnp.asarray(g), jnp.asarray(jp), jnp.asarray(jg), jnp.asarray(jb),
            jnp.asarray(lr, jnp.float32), interpret=True,
        )
    ).astype(np.float32)
    perm, grouped, bins = sort_plan_np(v, C)
    cw_t = torch.from_numpy(cw.astype(np.float32)).to(_TDT[dtype])
    out = binned_sgd_update(
        cw_t, torch.from_numpy(g.astype(np.float32)).to(_TDT[dtype]),
        torch.from_numpy(perm), torch.from_numpy(grouped), torch.from_numpy(bins), lr,
    )
    assert out is cw_t  # in place
    got = out.float().numpy()
    touched = np.zeros(C, bool)
    touched[v] = True
    np.testing.assert_array_equal(got[~touched], cw.astype(np.float32)[~touched])
    if dtype == "float32":
        np.testing.assert_allclose(got[touched], ref[touched], rtol=1e-5, atol=1e-4)
    else:
        diff = np.abs(got[touched] - ref[touched])
        ulp = _ulp_bf16(np.maximum(np.abs(got[touched]), np.abs(ref[touched])))
        assert np.all(diff <= ulp + 1e-5)


def test_binned_sgd_update_validates():
    cw = torch.zeros((100, 8))
    g = torch.zeros((10, 8), dtype=torch.bfloat16)
    ids = np.zeros(10, np.int32)
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(ids, 100))
    with pytest.raises(ValueError, match="cast"):
        binned_sgd_update(cw, g, perm, grouped, bins, 0.1)
    with pytest.raises(ValueError, match="bin_starts"):
        binned_sgd_update(cw, g.float(), perm, grouped, bins[:-1], 0.1)


@pytest.mark.parametrize("pooling,mode", [(1, "sum"), (2, "sum"), (3, "mean")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_matches_jax(pooling, mode, dtype):
    rng = np.random.default_rng(4)
    C, D, F, B = 400, 16, 4, 24
    w = rng.standard_normal((C, D)).astype(np.float32).astype(_NDT[dtype])
    ids = rng.integers(0, C, size=(F, B, pooling)).astype(np.int32)
    ref = np.asarray(
        jax_embedding_bag(jnp.asarray(w), JaxFeatures.from_uniform(jnp.asarray(ids)), mode=mode)
    ).astype(np.float32)
    got = embedding_bag(
        torch.from_numpy(w.astype(np.float32)).to(_TDT[dtype]),
        RaggedFeatures.from_uniform(torch.from_numpy(ids)), mode=mode,
    )
    assert got.shape == (B, F, D)
    # pooled sums are f32 in both; only the summation order may differ
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-6, atol=1e-6)


def test_cached_lookup_equals_host_rows_under_churn():
    """The bare-module API (prepare_ids + lookup) returns each id's row
    through eviction churn, with one table resident: cached lookup == dense
    lookup, the property of tests/test_cache.py. The expected rows are the
    canonical init filled by the JAX package's C++; nothing trains, so they
    hold exactly."""
    sizes, D, F, B, seed = [40, 3000, 500], 16, 3, 32, 5
    bag = CachedEmbeddingBag(
        sum(sizes), D, cache_ratio=0.05, table_sizes=sizes, seed=seed, weight_init="virtual",
        resident_tables=[0], warmup_ratio=0.0, device="cpu",
    )
    ref = np.empty((sum(sizes), D), np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for t, n in enumerate(sizes):
        jax_hostops.fill_rows_canonical(ref[off[t]:off[t + 1]], int(off[t]), seed=seed, bound=n ** -0.5)
    rng = np.random.default_rng(6)
    for _ in range(6):
        ids = np.stack([off[t] + rng.integers(0, n, B) for t, n in enumerate(sizes)]).astype(np.int32)
        slots = bag.prepare_ids(torch.from_numpy(ids.reshape(-1)))
        got = bag.lookup(RaggedFeatures.from_uniform(slots.reshape(F, B, 1)))
        np.testing.assert_array_equal(got.numpy(), ref[ids].transpose(1, 0, 2))
    assert sum(bag.stats.num_write_back_history) > 0, "the stream must evict"
    bag.close()


def test_cached_lookup_of_fp8_rows():
    """fp8 cache rows through the bare-module API: each lookup equals the
    host rows pushed through the storage cast (jnp.astype's) and pooled in
    f32, through eviction churn, with one table resident."""
    import ml_dtypes

    sizes, D, F, B, P, seed = [40, 3000, 500], 16, 3, 32, 2, 5
    bag = CachedEmbeddingBag(
        sum(sizes), D, cache_ratio=0.05, table_sizes=sizes, seed=seed, weight_init="virtual",
        resident_tables=[0], warmup_ratio=0.0, dtype="float8_e4m3fn", device="cpu",
    )
    assert bag.cache_weight.dtype == torch.float8_e4m3fn
    ref = np.empty((sum(sizes), D), np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for t, n in enumerate(sizes):
        jax_hostops.fill_rows_canonical(ref[off[t]:off[t + 1]], int(off[t]), seed=seed, bound=n ** -0.5)
    ref = ref.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    rng = np.random.default_rng(7)
    for _ in range(6):
        ids = np.stack([off[t] + rng.integers(0, n, (B, P)) for t, n in enumerate(sizes)]).astype(np.int32)
        slots = bag.prepare_ids(torch.from_numpy(ids.reshape(-1)))
        got = bag.lookup(RaggedFeatures.from_uniform(slots.reshape(F, B, P)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref[ids].sum(axis=2).transpose(1, 0, 2))
    assert sum(bag.stats.num_write_back_history) > 0, "the stream must evict"
    bag.close()
