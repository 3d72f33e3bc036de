"""Row-wise Adagrad in the port against the JAX package: cached (the
accumulators tier with the cache) and fully resident, through eviction
churn, checkpoints of both packages, and fp8 rows with stochastic rounding.

JAX's update (``_scan_window``) on the (C, D) f32 grad g: ``acc += mean(g *
g, axis=1)``, ``g /= sqrt(acc) + eps``, ``cw = cast(cw - slr * g)``. The port
runs it in Kernel 2's Adagrad epilogue on the touched rows (plain version on
the CPU), or, with stochastic rounding, as torch ops on Kernel 3's grad.
Tolerances: f32 rows and compute differ from JAX only by f32 sum order
(losses and scores rtol 1e-4, flushed rows and accumulators rtol 1e-4 with
an absolute floor); the port's cached and resident runs compute the same
sums in the same order (rtol 1e-6)."""

import json

import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
import torch_parity as tp
from cachedembedding_tpu.utils import checkpoint as jax_ckpt
from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.cache.host_table import DenseAccumStore, OverlayAccumStore
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.ops import rounding as port_rounding
from cachedembedding_tpu_torch.ops.binned_scatter import (
    binned_adagrad_update,
    binned_scatter_add_plain,
    sort_plan_np,
)
from cachedembedding_tpu_torch.ops.rounding import astype_storage
from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

# small enough that a 0.2 cache evicts: 400 slots for the two 1,000-row tables
TABLES = [50, 300, 1000, 1000]
ADAGRAD = dict(embedding_optimizer="rowwise_adagrad", learning_rate=0.1, tables=TABLES)
F32 = dict(compute="float32", cache_dtype="float32")


def _close(got, want, what, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("ship", [True, False], ids=["plan", "dense"])
@pytest.mark.parametrize("ratio", [1.0, 0.2], ids=["whole_table", "eviction_churn"])
def test_cached_adagrad_matches_jax(ratio, ship, monkeypatch):
    """f32 rows and compute, the plan branch (JAX: its binned scatter-add,
    then Adagrad) and the dense branch: counts equal; losses, scores,
    flushed rows and accumulators within f32 sum order; AUROC within
    1e-4."""
    kw = dict(**ADAGRAD, **F32, cache_ratio=ratio, ship_sort_perm=ship)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    if ratio < 1.0:
        assert sum(got["stats"]["num_write_back_history"]) > 0, "this config must evict"
    _close(got["losses"], ref["losses"], "losses")
    _close(got["scores"], ref["scores"], "scores")
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= 1e-4
    _close(got["rows"], ref["rows"], "flushed rows", atol=1e-5)
    _close(got["accum"], ref["accum"], "flushed accumulators", atol=1e-9)
    assert (got["accum"] > 0).sum() > 100


@pytest.mark.parametrize("ratio", [1.0, 0.2], ids=["whole_table", "eviction_churn"])
def test_cached_adagrad_equals_resident(ratio, monkeypatch):
    """The accumulator tiering is invisible: the cached trainer at any cache
    ratio equals the fully resident table with its (N,) accumulators
    (tests/test_adagrad.py's contract, here on f32 rows): losses rtol 1e-6,
    the table and the accumulators equal."""
    kw = dict(**ADAGRAD, **F32, cache_ratio=ratio, ship_sort_perm=False)
    cached = tp.run(True, monkeypatch, **kw)
    cfg = tp.config(True, **kw)

    def resident(cfg_, id_freq_map=None, device=None):
        embed = FullyResidentEmbeddingBag(sum(TABLES), 16, table_sizes=TABLES, seed=cfg_.seed,
                                          weight_init="uniform", device="cpu", optimizer="rowwise_adagrad")
        return port_trainer_mod.CachedDLRMTrainer(cfg_, embed_override=embed)

    train = tp.data(True, 8, 7, TABLES)
    tr = resident(cfg)
    rep = tr.train(train, num_iters=8)
    rows = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in train])).astype(np.int64)
    np.testing.assert_allclose(cached["losses"], np.asarray(rep.losses), rtol=1e-6)
    np.testing.assert_allclose(cached["rows"], tr.embed.dense_weight(rows), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cached["accum"], tr.embed.cache_accum[torch.from_numpy(rows)].numpy(), rtol=1e-6)


def test_accumulator_survives_evict_writeback_readmit():
    """The bare module: rows given an accumulator, evicted by a disjoint id
    set (written back by the drain thread), then admitted again carry it
    back; fresh rows start at adagrad_initial."""
    N, D = 300, 8
    bag = CachedEmbeddingBag(N, D, cache_ratio=40 / N, buffer_size=0, warmup_ratio=0.0, weight_init="virtual",
                             device="cpu", optimizer="rowwise_adagrad", adagrad_initial=0.25)
    assert bag.capacity == 40 and isinstance(bag.host_accum, OverlayAccumStore)
    first = np.arange(40, dtype=np.int64)
    slots = bag.prepare_ids(torch.from_numpy(first)).long()
    assert torch.equal(bag.cache_accum[slots], torch.full((40,), 0.25))
    acc = bag.cache_accum.clone()
    acc[slots] = 7.5
    bag.set_accum(acc)
    bag.prepare_ids(torch.from_numpy(first + 40))  # evicts every row of the first set
    again = bag.prepare_ids(torch.from_numpy(first)).long()
    np.testing.assert_array_equal(bag.cache_accum[again].numpy(), 7.5)
    bag.flush()
    np.testing.assert_array_equal(bag.host_accum.gather(first), 7.5)
    np.testing.assert_array_equal(bag.host_accum.gather(first + 40), 0.25)
    bag.close()


def test_accum_stores_match_jax():
    """Both host stores read an unwritten row as ``initial`` and a written
    one as written, as the JAX package's stores do."""
    from cachedembedding_tpu.cache import host_table as jax_ht

    idx = np.array([3, 17, 5, 3], np.int64)
    for port_store, jax_store in ((DenseAccumStore(20, 0.5), jax_ht.DenseAccumStore(20, 0.5)),
                                  (OverlayAccumStore(0.5), jax_ht.OverlayAccumStore(0.5))):
        for s in (port_store, jax_store):
            s.scatter(np.array([17, 2], np.int64), np.array([1.25, 9.0], np.float32))
        np.testing.assert_array_equal(port_store.gather(idx), jax_store.gather(idx))
        st, sj = port_store.save_state(), jax_store.save_state()
        assert st["kind"] == sj["kind"]
        if st["kind"] == "overlay":
            order = np.argsort(st["rows"]), np.argsort(sj["rows"])
            np.testing.assert_array_equal(st["rows"][order[0]], sj["rows"][order[1]])
            np.testing.assert_array_equal(st["vals"][order[0]], sj["vals"][order[1]])


def test_adagrad_update_plain_version():
    """Kernel 2's Adagrad entry on CPU tensors (its plain version) against
    the formula in float64 on the touched rows; untouched rows and their
    accumulators bit-equal; f32 grads into bf16 rows round once."""
    rng = np.random.default_rng(8)
    C, D, L, slr, eps = 50, 16, 400, 0.3, 1e-10
    ids = rng.integers(0, 30, L).astype(np.int32)
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(ids, C))
    g = torch.from_numpy(rng.standard_normal((L, D)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        cw0 = astype_storage(torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)), dt)
        acc0 = torch.from_numpy(rng.random(C).astype(np.float32))
        cw, acc = cw0.clone(), acc0.clone()
        binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, eps)
        s = np.zeros((C, D))
        np.add.at(s, ids, g.double().numpy())
        a64 = acc0.double().numpy() + (s * s).mean(axis=1)
        w64 = cw0.double().numpy() - slr * s / (np.sqrt(a64) + eps)[:, None]
        touched = np.isin(np.arange(C), ids)
        np.testing.assert_allclose(acc.numpy()[touched], a64[touched], rtol=1e-6)
        want = astype_storage(torch.from_numpy(w64.astype(np.float32)), dt).float().numpy()
        tol = 1e-5 if dt == torch.float32 else 2.0 ** -7 * np.abs(want[touched])
        assert np.all(np.abs(cw.float().numpy() - want)[touched] <= tol + 1e-6)
        assert torch.equal(cw[~torch.from_numpy(touched)], cw0[~torch.from_numpy(touched)])
        assert torch.equal(acc[~torch.from_numpy(touched)], acc0[~torch.from_numpy(touched)])
        assert binned_scatter_add_plain(g, perm, grouped, bins, C).abs().sum() > 0


# a row whose run, in the sorted stream, starts at `start` and holds `n`
# contributors: it crosses chunk boundaries (multiples of ROW_CHUNK = 64) as
# named; at most 64 contributors, the finishing launch sums it again from g,
# more, it sums the chunks' partials in chunk order
CROSSING_RUNS = {"one_boundary_direct": (40, 50), "one_boundary_partials": (10, 90),
                 "several_boundaries": (30, 400)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32_rows", "bf16_rows"])
@pytest.mark.parametrize("case", list(CROSSING_RUNS))
def test_adagrad_run_across_chunks_matches_jax(case, dt):
    """Kernel 2's Adagrad entry (its plain version on the CPU) where one row's
    run crosses one or several chunk boundaries of the CUDA kernels, against
    JAX's update on the same plan (its binned scatter-add in interpret mode,
    then the trainer's formula): accumulators rtol 1e-5, rows within 1e-5
    (f32) or one bf16 step, untouched rows bit-equal."""
    import jax.numpy as jnp

    from cachedembedding_tpu.ops import binned_scatter as jax_bs
    from cachedembedding_tpu_torch.ops.binned_scatter import BLOCK_ROWS, ROW_CHUNK

    start, n = CROSSING_RUNS[case]
    rng = np.random.default_rng(11)
    C, D, r, slr, eps = 300, 16, 150, 0.1, 1e-10
    tail = 200
    ids = np.concatenate([rng.integers(0, r, start), np.full(n, r), rng.integers(r + 1, C, tail)])
    ids = ids[rng.permutation(ids.size)].astype(np.int32)  # stream order
    perm, grouped, bins = sort_plan_np(ids, C)
    runs = np.flatnonzero(grouped == r)
    assert runs[0] == start and runs.size == n
    crossed = (start + n - 1) // ROW_CHUNK - start // ROW_CHUNK
    assert crossed == {"one_boundary_direct": 1, "one_boundary_partials": 1, "several_boundaries": 6}[case]
    g = rng.standard_normal((ids.size, D)).astype(np.float32)
    cw0 = astype_storage(torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)), dt)
    acc0 = rng.random(C).astype(np.float32)

    cw, acc = cw0.clone(), torch.from_numpy(acc0.copy())
    t = [torch.from_numpy(a) for a in (perm, grouped, bins)]
    binned_adagrad_update(cw, acc, torch.from_numpy(g), *t, slr, eps)

    g32 = jax_bs.binned_scatter_add(jnp.asarray(g), jnp.asarray(perm), jnp.asarray(grouped), jnp.asarray(bins), C,
                                    block_rows=BLOCK_ROWS, interpret=True)
    a_jax = jnp.asarray(acc0) + jnp.mean(g32 * g32, axis=1)
    g32 = g32 / (jnp.sqrt(a_jax) + eps)[:, None]
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    w_jax = np.asarray((jnp.asarray(cw0.float().numpy()) - slr * g32).astype(jdt).astype(jnp.float32))
    touched = np.isin(np.arange(C), ids)
    np.testing.assert_allclose(acc.numpy(), np.asarray(a_jax), rtol=1e-5)
    got = cw.float().numpy()
    tol = np.broadcast_to(1e-5 if dt == torch.float32 else 2.0 ** -7 * np.abs(w_jax), got.shape)
    assert np.all((np.abs(got - w_jax) <= tol + 1e-6)[touched])
    np.testing.assert_array_equal(got[~touched], cw0.float().numpy()[~touched])


@pytest.mark.parametrize("kind", ["dense", "virtual"])
def test_jax_adagrad_checkpoint_resumes_in_the_port(kind, tmp_path, monkeypatch):
    """A JAX Adagrad checkpoint (``accum.npy`` for a dense table,
    ``accum.npz`` for a virtual one) loaded into the port resumes to JAX's
    own resumed losses (f32: rtol 1e-4) and accumulators; the port saves the
    same files back."""
    kw = dict(**ADAGRAD, **F32, cache_ratio=0.3, weight_init="uniform" if kind == "dense" else "virtual")
    train, more = tp.data(False, 6, 7, TABLES), tp.data(False, 4, 77, TABLES)
    freq = train.id_freq_map()
    j1 = jax_trainer_mod.CachedDLRMTrainer(tp.config(False, **kw), id_freq_map=freq)
    j1.train(train, num_iters=6)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), j1)
    assert (tmp_path / "jax" / ("accum.npy" if kind == "dense" else "accum.npz")).exists()
    j2 = jax_trainer_mod.CachedDLRMTrainer(tp.config(False, **kw), id_freq_map=freq)
    jax_ckpt.load_checkpoint(str(tmp_path / "jax"), j2)
    want = j2.train(more, num_iters=4).losses
    j2.embed.flush()

    p = port_trainer_mod.CachedDLRMTrainer(tp.config(True, **kw), id_freq_map=freq, device="cpu")
    assert load_checkpoint(str(tmp_path / "jax"), p) == 6
    got = p.train(tp.data(True, 4, 77, TABLES), num_iters=4).losses
    np.testing.assert_allclose(got, want, rtol=1e-4)
    rows = np.arange(sum(TABLES), dtype=np.int64)
    p.embed.flush()
    np.testing.assert_allclose(p.embed.host_accum.gather(rows), j2.embed.host_accum.gather(rows), rtol=1e-4,
                               atol=1e-9)
    save_checkpoint(str(tmp_path / "port"), p)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["optimizer"] == "rowwise_adagrad"
    assert (tmp_path / "port" / ("accum.npy" if kind == "dense" else "accum.npz")).exists()
    p.close()


def test_resident_adagrad_checkpoint_round_trip(tmp_path):
    """A resident Adagrad table writes its accumulators beside its table
    (``accum.npy``) and a fresh resident trainer resumes from them with the
    saved trainer's losses."""
    kw = dict(**ADAGRAD, **F32, ship_sort_perm=False)

    def trainer():
        embed = FullyResidentEmbeddingBag(sum(TABLES), 16, table_sizes=TABLES, seed=1024, device="cpu",
                                          optimizer="rowwise_adagrad")
        return port_trainer_mod.CachedDLRMTrainer(tp.config(True, **kw), embed_override=embed)

    t1 = trainer()
    t1.train(tp.data(True, 4, 7, TABLES), num_iters=4)
    save_checkpoint(str(tmp_path), t1)
    assert np.load(tmp_path / "accum.npy").shape == (sum(TABLES),)
    t2 = trainer()
    assert load_checkpoint(str(tmp_path), t2) == 4
    assert torch.equal(t2.embed.cache_accum, t1.embed.cache_accum)
    r1, r2 = (t.train(tp.data(True, 3, 77, TABLES), num_iters=3).losses for t in (t1, t2))
    np.testing.assert_array_equal(r1, r2)


def test_adagrad_fp8_rows_with_rounding_match_jax(monkeypatch):
    """float8_e4m3fn rows, stochastic rounding on, row-wise Adagrad (Kernel
    3, Adagrad as torch ops, Kernel 4's fused entry), JAX's uniforms: counts
    equal, losses rtol 1e-4, accumulators rtol 1e-4, and at most 0.5% of the
    flushed elements one e4m3 step off (an f32 sum-order difference can flip
    a rounding choice)."""
    monkeypatch.setattr(port_rounding, "philox_uniform", tp.jax_uniform)
    kw = dict(**ADAGRAD, compute="float32", cache_dtype="float8_e4m3fn", cache_ratio=0.2)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    _close(got["accum"], ref["accum"], "flushed accumulators", atol=1e-9)
    steps = tp.storage_steps(got["rows"], ref["rows"], torch.float8_e4m3fn)
    assert (steps > 0).mean() <= 5e-3 and steps.max() <= 1
