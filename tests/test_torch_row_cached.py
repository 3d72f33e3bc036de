"""The port's row-sharded cached layout (``parallel/row_cached.py``) on
spawned gloo ranks against the JAX package's ``RowShardedCachedEmbeddingBag``
and its steps on a mesh of the same size, on the same data:
``tests/test_row_cached.py``'s four tests as cases (the per-batch step at 2
and 4 ranks, the churn case at 4 ranks with 96 cache rows a shard, the
windowed step at 4 ranks with windows of 3, the evaluation at 2 ranks).

Each compares ``enc`` bit for bit (every rank's), the cache statistics
after the flush (each shard's histories joined in rank order, the swap
bytes; before it, the port's drain thread may have landed writebacks that
JAX counts only at its next window), the losses
within rtol 1e-5 and the flushed master within rtol 1e-5 / atol 1e-6
(f32 sums of the same grads in another order: the dense grads are summed
over the ranks by gloo, the cache grads by Kernel 2's plain version), the
same master on every rank. Then the kept quirks and pieces: every shard's
identical local init, the range error's words, and
``_bucket_with_positions`` bit-equal to JAX's, an over-budget V included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from cachedembedding_tpu.cache.state import EvictionStrategy
from cachedembedding_tpu.models.dlrm import init_dlrm_dense
from cachedembedding_tpu.parallel.mesh import make_mesh
from cachedembedding_tpu.parallel import row_cached as jrc
from cachedembedding_tpu_torch.models.dlrm import init_dlrm_dense as port_init
from cachedembedding_tpu_torch.parallel import row_cached as prc
from cachedembedding_tpu_torch.parallel.mesh import Mesh

N, D, F, POOL = 4096, 32, 4, 1
B_GLOBAL = 64
DIN = 8


def _stream(n_steps, seed=5):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, size=(n_steps, F * B_GLOBAL * POOL)) - 1) % N
    dense = rng.standard_normal((n_steps, B_GLOBAL, DIN)).astype(np.float32)
    labels = (rng.random((n_steps, B_GLOBAL)) < 0.3).astype(np.float32)
    return ids.astype(np.int64), dense, labels


def _init_weight(seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, D)).astype(np.float32) * 0.05


def _per_rank(ids_t, world):
    b = B_GLOBAL // world
    fb = ids_t.reshape(F, B_GLOBAL, POOL)
    return np.stack([fb[:, r * b: (r + 1) * b].reshape(-1) for r in range(world)])


# (kind, world, steps, lr, stream seed, weight seed, cache rows a shard, window)
CASES = {
    "step2": ("step", 2, 6, 0.5, 5, 3, 192, 1),
    "step4": ("step", 4, 6, 0.5, 5, 3, 192, 1),
    "churn4": ("step", 4, 8, 0.3, 11, 12, 96, 1),
    "window4": ("window", 4, 6, 0.5, 31, 32, 256, 3),
    "eval2": ("eval", 2, 2, 0.0, 21, 22, 128, 1),
}


def _case(name):
    """The case's data: global (W, L) ids (a window's batches joined rank
    by rank), dense features and labels split by rank."""
    kind, world, n, lr, seed, wseed, cap, pn = CASES[name]
    ids, dense, labels = _stream(n, seed=seed)
    b = B_GLOBAL // world
    batches = []
    for t0 in range(0, n, pn):
        per = np.stack([_per_rank(ids[t], world) for t in range(t0, t0 + pn)])  # (P, W, L)
        d = dense[t0: t0 + pn].reshape(pn, world, b, DIN)
        lab = labels[t0: t0 + pn].reshape(pn, world, b)
        if kind == "window":
            batches.append((per.transpose(1, 0, 2).reshape(world, -1), d, lab))
        else:
            batches.append((per[0], d[0], lab[0]))
    return dict(kind=kind, world=world, lr=lr, cap=cap, w0=_init_weight(wseed), batches=batches, N=N, D=D, F=F,
                B=B_GLOBAL, Din=DIN, params=port_init(0, D, F, DIN, (16, D), (16, 8, 1)))


def _jax_run(c):
    """The JAX package's run of the case, recorded as the port's is."""
    world = c["world"]
    mesh = make_mesh(world)
    bag = jrc.RowShardedCachedEmbeddingBag(N, D, mesh=mesh, cuda_row_num=c["cap"], initial_weight=c["w0"],
                                           evict_strategy=EvictionStrategy.LFU, buffer_size=0)
    kw = dict(num_features=F, global_batch=B_GLOBAL, pooling=POOL, capacity=c["cap"], model="dlrm")
    dp = init_dlrm_dense(jax.random.PRNGKey(0), D, F, DIN, (16, D), (16, 8, 1))
    lr = jnp.asarray(c["lr"], jnp.float32)
    out = dict(enc=[], losses=[])
    if c["kind"] == "window":
        step = jrc.build_rowwise_cached_window(mesh, **kw)
        for ids, d, lab in c["batches"]:
            P_ = d.shape[0]
            enc = bag.prepare_ids_per_rank(ids)
            out["enc"].append(enc)
            cache = bag.global_cache()
            dp, cache, loss_w = step(dp, cache, jnp.asarray(enc.reshape(world, P_, -1).transpose(1, 0, 2)),
                                     jnp.asarray(d), jnp.asarray(lab), jnp.full((P_,), lr), jnp.full((P_,), lr))
            bag.sync_shards(cache)
            out["losses"] += [float(x) for x in np.asarray(loss_w)]
    elif c["kind"] == "step":
        step = jrc.build_rowwise_cached_step(mesh, **kw)
        for ids, d, lab in c["batches"]:
            enc = bag.prepare_ids_per_rank(ids)
            out["enc"].append(enc)
            dp, cache, loss = step(dp, bag.global_cache(), jnp.asarray(enc), jnp.asarray(d), jnp.asarray(lab), lr, lr)
            bag.sync_shards(cache)
            out["losses"].append(float(loss))
    else:
        step = jrc.build_rowwise_cached_step(mesh, train=False, **kw)
        ids, d, _ = c["batches"][0]
        enc = bag.prepare_ids_per_rank(ids)
        out["enc"].append(enc)
        out["probs"] = np.asarray(step(dp, bag.global_cache(), jnp.asarray(enc), jnp.asarray(d), lr, lr))
    out["master"] = bag.dense_weight()
    st = bag.aggregate_stats()
    out["stats"] = (st.prepare_calls, st.num_hits_history, st.num_miss_history, st.num_write_back_history,
                    st.swap_in_bytes, st.swap_out_bytes)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case of a world size on that many spawned ranks, one spawn a
    world size; at 2 ranks also the shards' init without initial_weight."""
    runs = {}
    for world in (2, 4):
        cases = {name: _case(name) for name, c in CASES.items() if c[1] == world}
        if world == 2:
            cases["init"] = dict(N=1000, D=16)
        runs[world] = torch_dist.spawn("row_cached_cases", world, tmp_path_factory.mktemp(f"rc{world}"), cases)
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_row_cached_matches_jax(cpu_devices, port_runs, name):
    c = _case(name)
    want = _jax_run(c)
    ranks = [res[name] for res in port_runs[c["world"]]]
    got = ranks[0]
    assert len(got["enc"]) == len(want["enc"])
    for res in ranks:  # every rank holds every rank's enc, JAX's bit for bit, and the same stats and master
        for a, b in zip(res["enc"], want["enc"]):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert res["stats"] == got["stats"]
        np.testing.assert_array_equal(res["master"], got["master"])
    assert got["stats"] == want["stats"]
    if c["kind"] == "eval":
        assert got["probs"].shape == (c["world"], B_GLOBAL // c["world"])
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-6, atol=1e-7)
    else:
        assert np.isfinite(got["losses"]).all()
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["master"].shape == (N, D)
    np.testing.assert_allclose(got["master"], want["master"], rtol=1e-5, atol=1e-6)
    if name == "churn4":
        assert sum(got["stats"][3]) > 0, "no churn"


def test_shards_share_their_local_init(cpu_devices, port_runs):
    """Without initial_weight every shard gets seed + 1 and one table of
    ``per`` rows: each rank's host table holds the same rows by local index,
    JAX's shard 0's rows bit for bit (a kept JAX quirk)."""
    jbag = jrc.RowShardedCachedEmbeddingBag(1000, 16, mesh=make_mesh(2), cuda_row_num=8, warmup_ratio=0.0)
    want = np.asarray(jbag.shards[0].host_table.gather(np.arange(jbag.per, dtype=np.int64)))
    np.testing.assert_array_equal(want, np.asarray(jbag.shards[1].host_table.gather(np.arange(jbag.per))))
    for res in port_runs[2]:
        np.testing.assert_array_equal(res["init"], want)


@pytest.mark.parametrize("bad", [-1, N], ids=["negative", "past_the_end"])
def test_range_error_matches_jax(cpu_devices, bad):
    ids = np.array([[3, bad, 17]], np.int64)
    msgs = []
    jbag = jrc.RowShardedCachedEmbeddingBag(N, 8, mesh=make_mesh(1), cuda_row_num=16, warmup_ratio=0.0)
    pbag = prc.RowShardedCachedEmbeddingBag(
        N, 8, mesh=Mesh(group=None, host_group=None, rank=0, size=1, device=torch.device("cpu")), cuda_row_num=16,
        warmup_ratio=0.0)
    for bag in (jbag, pbag):
        with pytest.raises(ValueError) as e:
            bag.prepare_ids_per_rank(ids)
        msgs.append(str(e.value))
    pbag.close()
    assert msgs[0] == msgs[1] == f"id out of range: {bad} not in [0, {N})"


@pytest.mark.parametrize("w,V,L", [(1, 40, 40), (2, 40, 40), (4, 40, 40), (4, 6, 40), (3, 1, 25)],
                         ids=["w1", "w2", "w4", "w4_over_budget", "w3_budget_1"])
def test_bucket_with_positions_matches_jax(w, V, L):
    rng = np.random.default_rng(w * 100 + V)
    cap = 7
    owners = rng.integers(0, w, L).astype(np.int32)
    enc = (owners * cap + rng.integers(0, cap, L)).astype(np.int32)
    want = [np.asarray(x) for x in jrc._bucket_with_positions(jnp.asarray(enc), jnp.asarray(owners), w, V)]
    got = [x.numpy() for x in prc._bucket_with_positions(torch.from_numpy(enc), torch.from_numpy(owners), w, V)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if V < L:
        assert (got[2] >= w * V).any()  # some ids past their owner's budget
