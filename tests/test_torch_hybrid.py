"""The port's per-batch hybrid step (``parallel/hybrid.py``), its id
exchanges (``parallel/all_to_all.py``) and ``models/hybrid.HybridParallelDLRM``
against the JAX package's, on the CPU: two spawned gloo ranks against JAX's
mesh of two devices (``tests/test_parallel.py``'s and
``tests/test_hybrid_model.py``'s cases), and the exchanges' local reshuffles
in this process.

Tolerances: the hybrid step as JAX's own test holds its mesh to one device
(loss rtol 1e-5, cache rows and dense weights rtol 1e-4 / atol 1e-6);
``HybridParallelDLRM``'s losses rtol 1e-5 over its 5-6 steps, the hit rates
and ``model_stats`` equal; the exchanges bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist as td
import torch_parity as tp
from cachedembedding_tpu.config import CacheConfig, DLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu.jagged import RaggedFeatures
from cachedembedding_tpu.models.dlrm import init_dlrm_dense
from cachedembedding_tpu.models.hybrid import HybridParallelDLRM
from cachedembedding_tpu.parallel import all_to_all as ja2a
from cachedembedding_tpu.parallel.hybrid import hybrid_train_step
from cachedembedding_tpu.parallel.mesh import AXIS, make_mesh
from cachedembedding_tpu.train.trainer import _train_step
from cachedembedding_tpu_torch.parallel import all_to_all as pa2a

W = 2
B_GLOBAL, F, D, DIN, C, LR = 16, 3, 32, 5, 64, 0.05
COLUMN_TABLES, TABLEWISE_TABLES = [500, 300, 200, 100], [300, 200, 150, 100]


def _step_case():
    """``tests/test_parallel.py::_setup``'s inputs."""
    rng = np.random.default_rng(0)
    params = init_dlrm_dense(jax.random.PRNGKey(0), D, F, DIN, (8, D), (8, 4, 1))
    cache = rng.normal(size=(C, D)).astype(np.float32) * 0.1
    dense = rng.random((B_GLOBAL, DIN)).astype(np.float32)
    labels = rng.integers(0, 2, B_GLOBAL).astype(np.float32)
    slot_ids = rng.integers(0, C, (F * B_GLOBAL,)).astype(np.int32)
    return params, cache, dense, labels, slot_ids


def _exchange_case():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, (W, 32)).astype(np.int32)
    ragged_lengths = rng.integers(0, 4, (W, 6)).astype(np.int32)
    ragged = rng.integers(0, 1000, (W, 24)).astype(np.int32)
    return dict(ids=ids, owners=(ids % W).astype(np.int32), V=12, F=3, P=2,
                fbp=rng.integers(0, 1000, (W, 3, 4, 2)).astype(np.int32), ragged=ragged, lengths=ragged_lengths,
                out_size=40)


def _hybrid_cfg(tables, use_tablewise):
    return DLRMConfig(num_embeddings_per_feature=tables, embedding_dim=32, dense_in_features=4,
                      dense_arch_layer_sizes=(16, 32), over_arch_layer_sizes=(16, 8, 1), batch_size=64,
                      learning_rate=0.2, use_tablewise=use_tablewise,
                      cache=CacheConfig(cache_ratio=0.5, warmup_ratio=0.5, buffer_size=0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, cache, dense, labels, slot_ids = _step_case()
    case = dict(step=dict(params=tp.numpy_params(params), cache=cache, dense=dense, labels=labels, slot_ids=slot_ids,
                          F=F, lr=LR),
                exchange=_exchange_case(),
                hybrid=dict(column_tables=COLUMN_TABLES, tablewise_tables=TABLEWISE_TABLES))
    return td.spawn("hybrid_cases", W, tmp_path_factory.mktemp("hybrid"), case)


@pytest.mark.parametrize("fused_op", ["all_to_all", "gather_scatter"])
def test_hybrid_step_matches_jax(ranks, cpu_devices, fused_op):
    """One ``hybrid_train_step`` on two ranks, each fused op, against JAX's
    on its mesh of two and JAX's single-device step: the loss, the ranks'
    column shards joined, the dense weights on each rank."""
    params, cache, dense, labels, slot_ids = _step_case()
    lr = jnp.asarray(LR, jnp.float32)
    feats = RaggedFeatures(values=jnp.asarray(slot_ids), offsets=None, num_features=F, batch_size=B_GLOBAL,
                           pooling=1)
    p1, c1, loss1 = _train_step(jax.tree_util.tree_map(jnp.copy, params), jnp.asarray(cache), jnp.asarray(dense),
                                feats, jnp.asarray(labels), lr, lr)
    mesh = make_mesh(W)
    step = hybrid_train_step(mesh, num_features=F, global_batch=B_GLOBAL, pooling=1, fused_op=fused_op)
    p2, c2, loss2 = step(jax.tree_util.tree_map(jnp.copy, params),
                         jax.device_put(jnp.asarray(cache), NamedSharding(mesh, P(None, AXIS))),
                         jax.device_put(jnp.asarray(dense), NamedSharding(mesh, P(AXIS))), jnp.asarray(slot_ids),
                         jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P(AXIS))), lr, lr)
    got = [r[fused_op] for r in ranks]
    joined = np.concatenate([g["cache"] for g in got], axis=1)
    for g in got:
        np.testing.assert_allclose(g["loss"], [float(loss1), float(loss2)], rtol=1e-5)
        tp.assert_params_close(g["params"], p1)
    np.testing.assert_allclose(joined, np.asarray(c1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(joined, np.asarray(c2), rtol=1e-4, atol=1e-6)
    assert not np.array_equal(joined, cache)


def _jax_exchange(e):
    mesh = make_mesh(W)

    def fn(ids, owners, fbp, ragged, lengths):
        bucketed, counts = ja2a.bucket_by_owner(ids, owners, W, e["V"])
        recv, rc = ja2a.exchange_to_owners(bucketed, counts)
        uni = ja2a.gather_global_uniform(fbp, e["F"], e["P"])
        vg, lg = ja2a.exchange_ragged(ragged, lengths, ragged.shape[0])
        vals, offs = ja2a.compact_ragged_global(vg, lg, W, ragged.shape[0], e["out_size"])
        return recv, rc, uni[None], vals[None], offs[None]

    mapped = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(AXIS),) * 5,
                                   out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)), check_vma=False))
    put = lambda x: jax.device_put(jnp.asarray(x.reshape(-1)), NamedSharding(mesh, P(AXIS)))  # noqa: E731
    return [np.asarray(x) for x in mapped(put(e["ids"]), put(e["owners"]), put(e["fbp"]), put(e["ragged"]),
                                          put(e["lengths"]))]


def test_exchanges_match_jax(ranks, cpu_devices):
    """``bucket_by_owner`` then ``exchange_to_owners`` (ids owned by id %
    2, a per-pair budget of 12 that drops some), ``gather_global_uniform``
    and ``exchange_ragged`` then ``compact_ragged_global`` on two ranks,
    bit-equal to JAX's inside ``shard_map``."""
    e = _exchange_case()
    recv, counts, uni, vals, offs = _jax_exchange(e)
    recv, counts = recv.reshape(W, W, e["V"]), counts.reshape(W, W)
    for r, got in enumerate(x["exchange"] for x in ranks):
        np.testing.assert_array_equal(got["recv"], recv[r])
        np.testing.assert_array_equal(got["counts"], counts[r])
        np.testing.assert_array_equal(got["uniform"], uni[r])
        np.testing.assert_array_equal(got["ragged"][0], vals[r])
        np.testing.assert_array_equal(got["ragged"][1], offs[r])
        for src in range(W):  # rank src's ids owned by rank r, in their order, up to the budget
            want = e["ids"][src][e["owners"][src] == r][: e["V"]]
            np.testing.assert_array_equal(got["recv"][src][: got["counts"][src]], want)
    assert (counts == e["V"]).any()  # the budget dropped ids


@pytest.mark.parametrize("seed", [0, 1])
def test_local_reshuffles_match_jax(seed):
    """The exchanges' static-shape helpers without a collective:
    ``bucket_by_owner``, ``permute_bags`` (with
    ``rank_major_to_feature_major_perm``) and ``compact_ragged_global``,
    bit-equal to JAX's."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 500, 40).astype(np.int32)
    owners = rng.integers(0, 3, 40).astype(np.int32)
    for budget in (8, 20):
        got = pa2a.bucket_by_owner(torch.from_numpy(vals), torch.from_numpy(owners), 3, budget)
        want = ja2a.bucket_by_owner(jnp.asarray(vals), jnp.asarray(owners), 3, budget)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    perm_p = pa2a.rank_major_to_feature_major_perm(2, 3, 4)
    np.testing.assert_array_equal(perm_p.numpy(), np.asarray(ja2a.rank_major_to_feature_major_perm(2, 3, 4)))
    lengths = rng.integers(0, 4, 24).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    values = rng.integers(0, 900, int(offsets[-1])).astype(np.int32)
    for out_size in (int(offsets[-1]), int(offsets[-1]) + 5):
        got = pa2a.permute_bags(torch.from_numpy(values), torch.from_numpy(offsets), perm_p, out_size)
        want = ja2a.permute_bags(jnp.asarray(values), jnp.asarray(offsets), jnp.asarray(perm_p.numpy()), out_size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lg = rng.integers(0, 4, 12).astype(np.int32)
    vg = rng.integers(0, 900, 2 * 20).astype(np.int32)
    for out_size in (10, 40):
        got = pa2a.compact_ragged_global(torch.from_numpy(vg), torch.from_numpy(lg), 2, 20, out_size)
        want = ja2a.compact_ragged_global(jnp.asarray(vg), jnp.asarray(lg), 2, 20, out_size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["column", "tablewise"])
def test_hybrid_model_matches_jax(ranks, cpu_devices, layout):
    """``tests/test_hybrid_model.py``'s runs on two ranks against JAX's
    ``HybridParallelDLRM`` on its mesh of two: column-wise (6 batches,
    ``prepare_ids`` then ``train_step``) and table-wise (5 batches,
    ``begin_prepare`` / ``finish_prepare`` then ``train_step``; "synthetic"
    has no hand-tuned map, so the tables are placed by frequency)."""
    tables = COLUMN_TABLES if layout == "column" else TABLEWISE_TABLES
    n, seed = (6, 2) if layout == "column" else (5, 3)
    cfg = _hybrid_cfg(tables, layout == "tablewise")
    data = SyntheticLongTailDataset(tables, cfg.batch_size, n, dense_in_features=4, seed=seed,
                                    global_ids=layout == "column")
    model = HybridParallelDLRM(cfg, make_mesh(W), id_freq_map=data.id_freq_map(),
                               dataset="synthetic" if layout == "tablewise" else None)
    losses = []
    for b in data:
        if layout == "column":
            slots = model.embed.prepare_ids(np.asarray(b.sparse_features.values))
        else:
            slots, plans = model.embed.begin_prepare(np.asarray(b.sparse_features.to_fbp())[:, :, 0].T)
            model.embed.finish_prepare(plans)
        loss = model.train_step(np.asarray(b.dense_features), slots, np.asarray(b.labels), 0.2, 0.2)
        losses.append(float(np.asarray(loss.reshape(1))[0]))
    for got in (r[layout] for r in ranks):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert got["hit_rate"] == model.embed.stats.hit_rate() > 0
        assert got["stats"] == model.model_stats("hybrid")


def test_dryrun_matches_jax_step(ranks, cpu_devices):
    """``dryrun_hybrid_train_step(2)``'s loss on two ranks equals JAX's
    hybrid step on the dry run's inputs on its mesh of two (rtol 1e-5)."""
    mesh = make_mesh(W)
    Fd, Dd, Dind, Cd, Bd = 4, 32 * W, 8, 64, 8 * W
    params = init_dlrm_dense(jax.random.PRNGKey(0), Dd, Fd, Dind, (16, Dd), (16, 8, 1))
    step = hybrid_train_step(mesh, num_features=Fd, global_batch=Bd, pooling=1)
    lr = jnp.asarray(0.1, jnp.float32)
    _, _, loss = step(params, jax.device_put(jnp.ones((Cd, Dd)), NamedSharding(mesh, P(None, AXIS))),
                      jax.device_put(jnp.ones((Bd, Dind)), NamedSharding(mesh, P(AXIS))),
                      jnp.zeros((Fd * Bd,), jnp.int32),
                      jax.device_put(jnp.ones((Bd,)), NamedSharding(mesh, P(AXIS))), lr, lr)
    for r in ranks:
        np.testing.assert_allclose(r["dryrun"], float(loss), rtol=1e-5)
