"""The port's table-wise layout (``parallel/tablewise.py``) against the JAX
package's, on the CPU: the placement helpers, the routing and the reshard's
feature permutation, and, on spawned gloo ranks, the table-wise steps
against JAX's (``tests/test_tablewise.py``'s cases).

The step cases run JAX's 5-table layout on 4 ranks, tables [40, 30, 20, 25,
15] on ranks [0, 1, 2, 3, 0]: F_max is 2, so ranks 1-3 have a pad lane, and
their host tables end before the pad row (N_max - 1 = 55), so those lanes
name a row past their table. Tolerances are JAX's own: losses rtol 1e-5,
rows and dense weights rtol 1e-4 / atol 1e-6 (Kernel 2's plain version sums
a row's grads in another order than XLA's scatter), the windowed scores
rtol 1e-5 / atol 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist as td
import torch_parity as tp
from cachedembedding_tpu.cache.host_table import DenseHostTable
from cachedembedding_tpu.cache.state import EvictionStrategy
from cachedembedding_tpu.jagged import RaggedFeatures
from cachedembedding_tpu.models.dlrm import init_dlrm_dense
from cachedembedding_tpu.parallel import tablewise as jtw
from cachedembedding_tpu.parallel.mesh import AXIS, make_mesh
from cachedembedding_tpu.train.trainer import _train_step
from cachedembedding_tpu_torch.parallel import tablewise as ptw
from cachedembedding_tpu_torch.parallel.mesh import Mesh

SIZES, RANKS = [40, 30, 20, 25, 15], [0, 1, 2, 3, 0]
B, D, DIN, LR, PN = 8, 32, 5, 0.05, 3
ARCH = ((8, D), (8, 4, 1))


@pytest.mark.parametrize("dataset", ["criteo_kaggle", "criteo_terabyte", "criteo_1tb", "avazu", ""])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_hand_tuned_maps_match_jax(dataset, world):
    try:
        want = jtw.get_tablewise_rank_arrange(dataset, world)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError, match="no hand-tuned arrangement"):
            ptw.get_tablewise_rank_arrange(dataset, world)
        assert "hand-tuned" in str(e)
        return
    assert ptw.get_tablewise_rank_arrange(dataset, world) == want and len(want) == 26 and max(want) < world


@pytest.mark.parametrize("freq", [False, True])
def test_auto_rank_arrange_matches_jax(freq):
    rng = np.random.default_rng(4)
    for world in (2, 3, 5):
        sizes = [int(x) for x in rng.integers(1, 400, 11)]
        fmap = rng.integers(0, 50, sum(sizes)) if freq else None
        assert ptw.auto_rank_arrange(sizes, world, fmap) == jtw.auto_rank_arrange(sizes, world, fmap)
    arr = ptw.auto_rank_arrange([100, 100, 100, 1], 2)
    load = [sum(s for s, r in zip([100, 100, 100, 1], arr) if r == q) for q in range(2)]
    assert abs(load[0] - load[1]) <= 100


@pytest.mark.parametrize("sizes,ratio,dataset,world,arrange", [
    ([10, 100000], 0.01, None, 2, [0, 1]),  # the clamp: a table smaller than its cache rows
    ([1460, 583, 10131227, 2202608], 0.01, "criteo_kaggle", 2, None),  # the first 4 of the 26-entry map
    ([300, 200, 150, 100], 0.5, "synthetic", 3, None),  # no hand-tuned map: auto, by frequency
    ([50, 200, 30], 0.8, None, 4, None),  # dataset None: no map, auto by rows
])
def test_prepare_config_matches_jax(sizes, ratio, dataset, world, arrange):
    fmap = np.random.default_rng(1).integers(0, 9, sum(sizes)) if sum(sizes) < 10**6 else None
    got = ptw.prepare_tablewise_config(sizes, ratio, fmap, dataset, world, arrange)
    want = jtw.prepare_tablewise_config(sizes, ratio, fmap, dataset, world, arrange)
    for g, w in zip(got, want):
        assert (g.num_embeddings, g.cuda_row_num, g.assigned_rank) == (w.num_embeddings, w.cuda_row_num,
                                                                        w.assigned_rank)
        assert (g.ids_freq_mapping is None) == (w.ids_freq_mapping is None)
        if g.ids_freq_mapping is not None:
            np.testing.assert_array_equal(g.ids_freq_mapping, w.ids_freq_mapping)
    if arrange == [0, 1]:
        assert got[0].cuda_row_num == 10 and got[1].cuda_row_num == 1000 + 2000


def _jax_tablewise(mesh, cache_full=True, W=None):
    cfgs = [jtw.TablewiseEmbeddingBagConfig(num_embeddings=n, cuda_row_num=n if cache_full else max(2, n // 4),
                                            assigned_rank=r) for n, r in zip(SIZES, RANKS)]
    tw = jtw.ParallelCachedEmbeddingBagTablewise(cfgs, D, mesh, warmup_ratio=0.0, weight_init="zeros",
                                                 evict_strategy=EvictionStrategy.LFU)
    if W is not None:
        offs = np.concatenate([[0], np.cumsum(SIZES)])
        for r in range(tw.world):
            rows = [W[offs[t]: offs[t + 1]] for t in tw.tables_of_rank[r]] + [np.zeros((1, D), np.float32)]
            tw.host_tables[r] = DenseHostTable(np.ascontiguousarray(np.concatenate(rows)))
    return tw


@pytest.mark.parametrize("cache_full", [True, False])
def test_layout_and_routing_match_jax(cpu_devices, cache_full):
    """Every rank's view of the layout (the partition, local sizes, pad row,
    capacities, offsets), ``route_ids`` and ``feature_select_perm`` equal
    JAX's; a rank's host table has its rows and its own pad row, and ranks
    1-3's pad lanes name row 55, past their tables."""
    jw = _jax_tablewise(make_mesh(4), cache_full)
    ids_bf = np.stack([np.random.default_rng(t).integers(0, n, B) for t, n in enumerate(SIZES)], axis=1)
    routed = jw.route_ids(ids_bf)
    for r in range(4):
        mesh = Mesh(group=None, host_group=None, rank=r, size=4, device=torch.device("cpu"))
        cfgs = [ptw.TablewiseEmbeddingBagConfig(n, n if cache_full else max(2, n // 4), rk)
                for n, rk in zip(SIZES, RANKS)]
        pw = ptw.ParallelCachedEmbeddingBagTablewise(cfgs, D, mesh, warmup_ratio=0.0, weight_init="zeros")
        assert pw.tables_of_rank == jw.tables_of_rank and pw.F_max == jw.F_max == 2
        for k in ("feat_pos", "local_sizes", "capacities", "table_local_offset"):
            np.testing.assert_array_equal(getattr(pw, k), getattr(jw, k), err_msg=k)
        assert (pw.N_max, pw.pad_row, pw.C_max) == (jw.N_max, jw.pad_row, jw.C_max) == (56, 55, jw.C_max)
        np.testing.assert_array_equal(pw.route_ids(ids_bf), routed)
        np.testing.assert_array_equal(pw.feature_select_perm(), jw.feature_select_perm())
        assert pw.host_tables[r].num_rows == pw.local_sizes[r] + 1
        assert all(t is None for q, t in enumerate(pw.host_tables) if q != r)
        if r:  # the pad lane past this rank's table
            assert (routed[r, B:] == 55).all() and pw.host_tables[r].num_rows <= 55


def _batches(rng, n):
    out = []
    for _ in range(n):
        ids_bf = np.stack([rng.integers(0, s, B) for s in SIZES], axis=1)
        out.append((ids_bf, rng.random((B, DIN)).astype(np.float32), rng.integers(0, 2, B).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, cpu_devices):
    """The step cases on 4 spawned ranks, and JAX's on its mesh of 4."""
    rng = np.random.default_rng(1)
    W = (rng.normal(size=(sum(SIZES), D)) * 0.1).astype(np.float32)
    params = init_dlrm_dense(jax.random.PRNGKey(0), D, len(SIZES), DIN, *ARCH)
    batches = _batches(rng, PN)
    case = dict(table_sizes=SIZES, ranks=RANKS, W_global=W, D=D, B=B, Din=DIN, dense_arch=ARCH[0],
                over_arch=ARCH[1], lr=LR, batches=batches, params=tp.numpy_params(params))
    ranks = td.spawn("tablewise_step_cases", 4, tmp_path_factory.mktemp("tablewise4"), case)
    return dict(ranks=ranks, W=W, params=params, batches=batches)


def _jax_step(mesh, tw, step, params, batch):
    ids_bf, dense, labels = batch
    slot_ids, plans = tw.begin_prepare(ids_bf)
    tw.finish_prepare(plans)
    dn = jax.device_put(jnp.asarray(dense), NamedSharding(mesh, P(AXIS)))
    lb = jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P(AXIS)))
    lr = jnp.asarray(LR, jnp.float32)
    params, tw.cache_weight, loss = step(params, tw.cache_weight, dn, slot_ids, lb, lr, lr)
    return params, float(loss)


def test_step_matches_jax_and_single_device(four_ranks):
    """One table-wise step on 4 ranks: the loss against JAX's table-wise
    step and JAX's single-device step (rtol 1e-5), each rank's flushed rows
    against the single device's updated table and JAX's table-wise flush,
    the dense weights on every rank against the single device's, and the
    cache counts, summed over the ranks, against JAX's."""
    W, params, batch = four_ranks["W"], four_ranks["params"], four_ranks["batches"][0]
    ids_bf, dense, labels = batch
    offs = np.concatenate([[0], np.cumsum(SIZES)[:-1]])
    feats = RaggedFeatures.from_dense_ids(jnp.asarray((ids_bf + offs[None, :]).astype(np.int32)))
    lr = jnp.asarray(LR, jnp.float32)
    p1, w1, loss1 = _train_step(jax.tree_util.tree_map(jnp.copy, params), jnp.asarray(W), jnp.asarray(dense),
                                feats, jnp.asarray(labels), lr, lr)
    mesh = make_mesh(4)
    jw = _jax_tablewise(mesh, W=W)
    step = jtw.tablewise_train_step(mesh, feature_perm=jw.feature_select_perm(), f_max=jw.F_max, global_batch=B)
    _, loss2 = _jax_step(mesh, jw, step, jax.tree_util.tree_map(jnp.copy, params), batch)
    jw.flush()
    w1 = np.asarray(w1)
    ranks = [r["step"] for r in four_ranks["ranks"]]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], [float(loss1), loss2], rtol=1e-5)
        for t in jw.tables_of_rank[r]:
            lo, n = jw.table_local_offset[t], SIZES[t]
            np.testing.assert_allclose(got["table"][lo: lo + n], w1[offs[t]: offs[t] + n], rtol=1e-4, atol=1e-6,
                                       err_msg=f"table {t}")
            np.testing.assert_allclose(got["table"][lo: lo + n], jw.host_tables[r].array[lo: lo + n],
                                       rtol=1e-4, atol=1e-6)
        tp.assert_params_close(got["params"], p1)
        assert got["stats"] == (jw.stats.num_hits_history, jw.stats.num_miss_history)


def test_window_matches_per_batch_and_jax(four_ranks):
    """Three batches through ``tablewise_window_step`` against the same
    batches step by step (the port's, and JAX's per-batch and window
    steps): losses rtol 1e-5, dense weights rtol 1e-4 / atol 1e-6; then the
    windowed scores of the global batch, on every rank, against JAX's
    ``tablewise_eval_step`` on its window's weights."""
    params, batches = four_ranks["params"], four_ranks["batches"]
    mesh = make_mesh(4)
    jw = _jax_tablewise(mesh, W=four_ranks["W"])
    step = jtw.tablewise_train_step(mesh, feature_perm=jw.feature_select_perm(), f_max=jw.F_max, global_batch=B)
    p1, losses1 = jax.tree_util.tree_map(jnp.copy, params), []
    for batch in batches:
        p1, loss = _jax_step(mesh, jw, step, p1, batch)
        losses1.append(loss)
    jw2 = _jax_tablewise(mesh, W=four_ranks["W"])
    slot_w, plans = jw2.begin_prepare_window([b[0] for b in batches])
    jw2.finish_prepare(plans)
    stepw = jtw.tablewise_window_step(mesh, feature_perm=jw2.feature_select_perm(), f_max=jw2.F_max,
                                      global_batch=B)
    dense_P = jax.device_put(jnp.asarray(np.stack([b[1] for b in batches])), NamedSharding(mesh, P(None, AXIS)))
    labels_P = jax.device_put(jnp.asarray(np.stack([b[2] for b in batches])), NamedSharding(mesh, P(None, AXIS)))
    lrs = jnp.full((PN,), LR, jnp.float32)
    p2, jw2.cache_weight, losses2 = stepw(jax.tree_util.tree_map(jnp.copy, params), jw2.cache_weight, slot_w,
                                          dense_P, labels_P, lrs, lrs)
    evw = jtw.tablewise_eval_step(mesh, feature_perm=jw2.feature_select_perm(), f_max=jw2.F_max, global_batch=B)
    probs = np.asarray(evw(p2, jw2.cache_weight, slot_w, dense_P))
    np.testing.assert_allclose(np.asarray(losses2), losses1, rtol=1e-5)
    for got in four_ranks["ranks"]:
        np.testing.assert_allclose(got["per_batch"]["losses"], losses1, rtol=1e-5)
        np.testing.assert_allclose(got["window"]["losses"], got["per_batch"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["window"]["losses"], np.asarray(losses2), rtol=1e-5)
        tp.assert_params_close(got["per_batch"]["params"], p1)
        tp.assert_params_close(got["window"]["params"], p2)
        assert got["window"]["probs"].shape == (PN, B)
        np.testing.assert_allclose(got["window"]["probs"], probs, rtol=1e-5, atol=1e-7)


def test_cache_pressure_roundtrip(tmp_path, cpu_devices):
    """``test_cache_pressure_roundtrip`` on 2 ranks: 5 batches through a
    cache of a quarter of each table; every looked-up row equals the
    table's, exactly, and the cache counts and swap bytes summed over the
    ranks, and the flushed tables, equal JAX's."""
    sizes, ranks_, b, d = [50, 60], [0, 1], 6, 16
    rng = np.random.default_rng(3)
    W = rng.normal(size=(sum(sizes), d)).astype(np.float32)
    ids = [np.stack([rng.integers(0, n, b) for n in sizes], axis=1) for _ in range(5)]
    got = td.spawn("tablewise_pressure_case", 2, tmp_path,
                   dict(table_sizes=sizes, ranks=ranks_, W_global=W, D=d, B=b, ids=ids))
    cfgs = [jtw.TablewiseEmbeddingBagConfig(n, max(2, n // 4), r) for n, r in zip(sizes, ranks_)]
    jw = jtw.ParallelCachedEmbeddingBagTablewise(cfgs, d, make_mesh(2), warmup_ratio=0.0, weight_init="zeros",
                                                 evict_strategy=EvictionStrategy.LFU)
    offs = np.cumsum([0] + sizes)
    for r in range(2):
        jw.host_tables[r] = DenseHostTable(np.concatenate([W[offs[r]: offs[r + 1]], np.zeros((1, d), np.float32)]))
    for x in ids:
        jw.finish_prepare(jw.begin_prepare(x)[1])
    jw.flush()
    s = jw.stats
    want = (s.prepare_calls, s.num_hits_history, s.num_miss_history, s.swap_in_bytes, s.swap_out_bytes)
    for r, res in enumerate(got):
        assert res["err"] == 0.0
        assert res["stats"] == want and res["stats"][4] > 0  # writebacks happened
        np.testing.assert_array_equal(res["table"], jw.host_tables[r].array)


@pytest.mark.parametrize("weight_init", ["uniform", "virtual"])
def test_host_tables_match_jax(cpu_devices, weight_init):
    """Each rank's host table, built with ``seed + rank`` over its tables
    and its own pad row, equals JAX's row for row (the canonical init), the
    pad row past a smaller rank's table included: the gather reads what
    JAX's reads there (row 0 of a dense table, the canonical row of a
    virtual one), and a scatter to it leaves the table as JAX's leaves it."""
    cfgs = [jtw.TablewiseEmbeddingBagConfig(n, n, r) for n, r in zip(SIZES, RANKS)]
    jw = jtw.ParallelCachedEmbeddingBagTablewise(cfgs, 16, make_mesh(4), warmup_ratio=0.0, weight_init=weight_init,
                                                 seed=7)
    for r in range(4):
        mesh = Mesh(group=None, host_group=None, rank=r, size=4, device=torch.device("cpu"))
        pw = ptw.ParallelCachedEmbeddingBagTablewise([ptw.TablewiseEmbeddingBagConfig(n, n, rk)
                                                      for n, rk in zip(SIZES, RANKS)], 16, mesh,
                                                     warmup_ratio=0.0, weight_init=weight_init, seed=7)
        rows = np.arange(pw.local_sizes[r] + 1, dtype=np.int64)
        rows = np.concatenate([rows, [pw.pad_row]])  # the shared pad row: past ranks 1-3's tables
        np.testing.assert_array_equal(pw.host_tables[r].gather(rows), jw.host_tables[r].gather(rows))
        vals = np.full((1, 16), 3.0, np.float32)
        pw.host_tables[r].scatter(np.array([pw.pad_row]), vals)
        jw.host_tables[r].scatter(np.array([jw.pad_row]), vals)
        np.testing.assert_array_equal(pw.host_tables[r].gather(rows), jw.host_tables[r].gather(rows))
