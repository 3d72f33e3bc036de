"""The slice as a whole: the port's CachedDLRMTrainer against the JAX
package's on the same synthetic stream, training 8 steps and evaluating 4
batches at a small width. The JAX trainer runs with use_pallas_lookup=False:
its evaluate vmaps the Pallas gather, which its CPU interpreter cannot run,
and the jnp.take lookup computes the same function.

The fp8 slice (float8_e4m3fn rows, stochastic rounding) draws its rounding
uniforms from Philox in the port and from threefry in JAX. With the port's
``philox_uniform`` replaced by JAX's uniforms for each step seed, both round
the same way; with its own Philox only the distribution agrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.utils.metrics import StreamingMetrics as JaxMetrics
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.ops import rounding as port_rounding
from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics

TABLES = [50, 300, 4000, 20000]
STATS = ("num_hits_history", "num_miss_history", "num_write_back_history",
         "swap_in_bytes", "swap_out_bytes", "prepare_calls", "synth_rows")


def _cfg(cache_cls, cfg_cls, dtype, cache_ratio, use_pallas, cache_dtype=None, sr="auto"):
    return cfg_cls(
        num_embeddings_per_feature=TABLES, embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1),
        batch_size=256, learning_rate=1.0, compute_dtype=dtype,
        cache=cache_cls(
            cache_ratio=cache_ratio, resident_threshold=500, prefetch_num=4,
            weight_init="virtual", ship_sort_perm=True, cache_dtype=cache_dtype or dtype,
            stochastic_rounding=sr, id_wire="plain", use_pallas_lookup=use_pallas,
        ),
    )


def _run(port, dtype, cache_ratio, monkeypatch, cache_dtype=None, sr="auto"):
    """Train 8 steps, evaluate 4 batches; returns what the tests compare."""
    if port:
        cfg = _cfg(CacheConfig, DLRMConfig, dtype, cache_ratio, True, cache_dtype, sr)
        ds_cls, mod, metrics_cls = SyntheticLongTailDataset, port_trainer_mod, StreamingMetrics
    else:
        cfg = _cfg(JaxCacheConfig, JaxDLRMConfig, dtype, cache_ratio, False, cache_dtype, sr)
        ds_cls, mod, metrics_cls = JaxDataset, jax_trainer_mod, JaxMetrics
    scores = []

    class Recording(metrics_cls):
        def update(self, s, labels):
            scores.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)
    train = ds_cls(TABLES, 256, 8, dense_in_features=13, skew=0.5, seed=7)
    test = ds_cls(TABLES, 256, 4, dense_in_features=13, skew=0.5, seed=99)
    if port:
        tr = mod.CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device="cpu")
        params = [
            x for lin in list(tr.model.dense_arch) + list(tr.model.over_arch)
            for x in (lin.weight.detach().numpy().T, lin.bias.detach().numpy())
        ]
    else:
        tr = mod.CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map())
    rep = tr.train(train, num_iters=8)
    ev = tr.evaluate(test)
    if not port:
        params = [
            np.asarray(x) for lin in tr.dense_params.dense_arch + tr.dense_params.over_arch
            for x in (lin["w"], lin["b"])
        ]
    stats = {k: getattr(tr.embed.stats, k) for k in STATS}
    # the training stream's rows, flushed back to the host table
    rows = np.unique(np.concatenate([np.asarray(b.sparse_features.values) for b in train]))
    if port:
        flushed = tr.embed.dense_weight(rows)
    else:
        tr.embed.flush()
        flushed = tr.embed.host_table.gather(rows.astype(np.int64))
    return dict(losses=np.asarray(rep.losses), ev=ev, scores=np.concatenate(scores),
                stats=stats, params=params, rows=flushed)


@pytest.mark.parametrize("cache_ratio", [0.1, 0.02], ids=["slice_config", "eviction_churn"])
def test_slice_matches_jax_f32(cache_ratio, monkeypatch):
    """f32 compute and cache. Counts are equal; values differ only by f32 sum
    order (rtol 1e-4 on losses, params and scores; atol 1e-5 on flushed rows;
    AUROC within 1e-4)."""
    ref = _run(False, "float32", cache_ratio, monkeypatch)
    got = _run(True, "float32", cache_ratio, monkeypatch)
    assert got["stats"] == ref["stats"]
    if cache_ratio < 0.1:
        assert sum(got["stats"]["num_write_back_history"]) > 0, "this config must evict"
    assert np.isfinite(got["losses"]).all() and got["losses"].shape == (8,)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for a, b in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["rows"], ref["rows"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4)
    assert got["ev"]["count"] == ref["ev"]["count"] == 1024
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= 1e-4


def test_slice_matches_jax_bf16(monkeypatch):
    """bf16 cache rows and compute: losses within rtol 2e-2 (bf16 rounding of
    rows whose f32 update sums ran in another order can differ by one ulp)."""
    ref = _run(False, "bfloat16", 0.1, monkeypatch)
    got = _run(True, "bfloat16", 0.1, monkeypatch)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-2)


def _jax_uniform(seed, shape, device=None):
    """JAX's rounding uniforms for one step seed (what its emulation draws)."""
    u = jax.random.uniform(jax.random.PRNGKey(jnp.uint32(seed)), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


def _e4m3_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in e4m3fn representables between arrays of e4m3fn values."""
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b)]
    return port_rounding.storage_steps(*t, torch.float8_e4m3fn).numpy()


@pytest.mark.parametrize("compute,cache_ratio", [
    ("float32", 0.1), ("float32", 0.02), ("bfloat16", 0.1),
], ids=["f32_slice_config", "f32_eviction_churn", "bf16_compute"])
def test_fp8_slice_matches_jax_with_shared_uniforms(compute, cache_ratio, monkeypatch):
    """float8_e4m3fn rows, stochastic_rounding="auto" (on for fp8), the
    rounding branch through Kernels 3 and 4. With JAX's uniforms: counts
    equal; losses rtol 1e-4 in f32 compute and 1e-3 in bf16 compute (bf16
    roundings of f32 values summed in another order); AUROC within 1e-4. The
    flushed rows are equal but for at most 8 elements, each one e4m3 step
    off: a rounding choice that an f32 sum-order difference flipped."""
    monkeypatch.setattr(port_rounding, "philox_uniform", _jax_uniform)
    ref = _run(False, compute, cache_ratio, monkeypatch, cache_dtype="float8_e4m3fn")
    got = _run(True, compute, cache_ratio, monkeypatch, cache_dtype="float8_e4m3fn")
    assert got["stats"] == ref["stats"]
    if cache_ratio < 0.1:
        assert sum(got["stats"]["num_write_back_history"]) > 0, "this config must evict"
    assert np.isfinite(got["losses"]).all() and got["losses"].shape == (8,)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4 if compute == "float32" else 1e-3)
    assert got["ev"]["count"] == ref["ev"]["count"] == 1024
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= 1e-4
    steps = _e4m3_steps(got["rows"], ref["rows"])
    assert int((steps > 0).sum()) <= 8 and int(steps.max()) <= 1


def test_fp8_slice_with_its_own_philox(monkeypatch):
    """The port's own Philox bits: other rounding choices than JAX's, the
    same cache counts, and losses within rtol 2e-2."""
    ref = _run(False, "float32", 0.1, monkeypatch, cache_dtype="float8_e4m3fn")
    got = _run(True, "float32", 0.1, monkeypatch, cache_dtype="float8_e4m3fn")
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-2)
    assert np.isfinite(got["rows"]).all() and (_e4m3_steps(got["rows"], ref["rows"]) > 0).any()


def test_bf16_rows_with_stochastic_rounding_on(monkeypatch):
    """stochastic_rounding="on" rounds bf16 rows too (Kernel 3 on bf16
    grads, Kernel 4 to bf16). Shared uniforms; f32 compute: counts equal,
    losses rtol 1e-4, flushed rows within one bf16 ulp."""
    monkeypatch.setattr(port_rounding, "philox_uniform", _jax_uniform)
    ref = _run(False, "float32", 0.1, monkeypatch, cache_dtype="bfloat16", sr="on")
    got = _run(True, "float32", 0.1, monkeypatch, cache_dtype="bfloat16", sr="on")
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref["rows"]), 2.0**-126))) - 7)
    assert np.all(np.abs(got["rows"] - ref["rows"]) <= ulp)


def test_refuses_outside_the_slice():
    base = dict(num_embeddings_per_feature=[10, 20], embedding_dim=16, dense_in_features=4,
                dense_arch_layer_sizes=(16,), over_arch_layer_sizes=(8, 1), batch_size=8)
    for kw, cache_kw, item in [
        ({"mesh_shape": (2,)}, {}, 9),
    ]:
        cfg = DLRMConfig(**base, **kw, cache=CacheConfig(**{"ship_sort_perm": True, **cache_kw}))
        with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item {item}\b"):
            port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
    # DeepFM, the JAX CLI's default ship_sort_perm=False, row-wise Adagrad,
    # the sparse gradient, fp8 rows with rounding off, e5m2 rows, the gather
    # interaction, int8/int4 dense inputs and transfers, every id wire and
    # the device planner are in the port
    for kw, cache_kw in [({"model": "deepfm"}, {}), ({}, {"ship_sort_perm": False}),
                         ({"interaction_impl": "gather"}, {}),
                         ({"embedding_optimizer": "rowwise_adagrad"}, {}), ({"use_sparse_embed_grad": True}, {}),
                         ({}, {"cache_dtype": "float8_e4m3fn", "stochastic_rounding": "off"}),
                         ({}, {"cache_dtype": "float8_e5m2"}),
                         ({"dense_input_dtype": "int8"}, {}), ({"dense_input_dtype": "int4"}, {}),
                         ({}, {"transfer_dtype": "int8"}), ({}, {"transfer_dtype": "int4"}),
                         ({}, {"id_wire": "ranktier"}), ({}, {"id_wire": "plain"}), ({}, {"planner": "device"})]:
        cfg = DLRMConfig(**base, **kw, cache=CacheConfig(**{"ship_sort_perm": True, "cache_ratio": 0.5, **cache_kw}))
        port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu").close()
    # fp8 rows with rounding on ("auto" or "on") are in the slice
    for sr in ("auto", "on"):
        cfg = DLRMConfig(**base, cache=CacheConfig(
            ship_sort_perm=True, cache_dtype="float8_e4m3fn", stochastic_rounding=sr, cache_ratio=0.5))
        tr = port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
        assert tr._sr and tr.embed.cache_weight.dtype == torch.float8_e4m3fn
        tr.close()


@pytest.mark.parametrize("cache_dtype", ["float8_e4m3fn", "bfloat16", "float32"])
def test_sr_update_equals_the_unfused_chain(cache_dtype):
    """The rounding branch's update of one step on CPU tensors equals the
    chain it replaced bit for bit: Kernel 3's f32 grad, ``cw.float() - slr *
    g``, then the stochastic rounding into the rows (f32 rows: the
    difference itself)."""
    from cachedembedding_tpu_torch.ops.binned_scatter import binned_scatter_add, sort_plan_np

    tr = port_trainer_mod.CachedDLRMTrainer(_cfg(CacheConfig, DLRMConfig, "float32", 0.1, True, cache_dtype, "on"),
                                            device="cpu")
    tr.close()
    rng = np.random.default_rng(5)
    C, D, L, slr, seed = 300, 16, 1000, 0.37, 0xDEADBEEF
    dt = getattr(torch, cache_dtype)
    cw0 = port_rounding.stochastic_astype(torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)), dt, 1)
    g_rows = torch.from_numpy((rng.standard_normal((L, D)) * 0.1).astype(np.float32))
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(rng.integers(0, C, L).astype(np.int32), C))
    gdt = torch.bfloat16 if dt.itemsize == 1 else dt
    g32 = binned_scatter_add(g_rows.to(gdt), perm, grouped, bins, C)
    want = port_rounding.stochastic_astype(torch.sub(cw0.float(), g32, alpha=slr), dt, seed)
    cw = cw0.clone()
    tr._sr_update(cw, g_rows, perm, grouped, bins, slr, seed)
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[dt.itemsize]
    np.testing.assert_array_equal(cw.view(view).numpy(), want.view(view).numpy())
    assert (cw.view(view) != cw0.view(view)).any()
