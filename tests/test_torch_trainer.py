"""The slice as a whole: the port's CachedDLRMTrainer against the JAX
package's on the same synthetic stream, training 8 steps and evaluating 4
batches at a small width. The JAX trainer runs with use_pallas_lookup=False:
its evaluate vmaps the Pallas gather, which its CPU interpreter cannot run,
and the jnp.take lookup computes the same function."""

import numpy as np
import pytest

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.utils.metrics import StreamingMetrics as JaxMetrics
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics

TABLES = [50, 300, 4000, 20000]
STATS = ("num_hits_history", "num_miss_history", "num_write_back_history",
         "swap_in_bytes", "swap_out_bytes", "prepare_calls", "synth_rows")


def _cfg(cache_cls, cfg_cls, dtype, cache_ratio, use_pallas):
    return cfg_cls(
        num_embeddings_per_feature=TABLES, embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1),
        batch_size=256, learning_rate=1.0, compute_dtype=dtype,
        cache=cache_cls(
            cache_ratio=cache_ratio, resident_threshold=500, prefetch_num=4,
            weight_init="virtual", ship_sort_perm=True, cache_dtype=dtype,
            id_wire="plain", use_pallas_lookup=use_pallas,
        ),
    )


def _run(port, dtype, cache_ratio, monkeypatch):
    """Train 8 steps, evaluate 4 batches; returns what the tests compare."""
    if port:
        cfg = _cfg(CacheConfig, DLRMConfig, dtype, cache_ratio, True)
        ds_cls, mod, metrics_cls = SyntheticLongTailDataset, port_trainer_mod, StreamingMetrics
    else:
        cfg = _cfg(JaxCacheConfig, JaxDLRMConfig, dtype, cache_ratio, False)
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


def test_refuses_outside_the_slice():
    base = dict(num_embeddings_per_feature=[10, 20], embedding_dim=16, dense_in_features=4,
                dense_arch_layer_sizes=(16,), over_arch_layer_sizes=(8, 1), batch_size=8)
    for kw, cache_kw in [
        ({"embedding_optimizer": "rowwise_adagrad"}, {}),
        ({"dense_input_dtype": "int8"}, {}),
        ({"model": "deepfm"}, {}),
        ({}, {"ship_sort_perm": False}),
        ({}, {"cache_dtype": "float8_e4m3fn"}),
        ({}, {"transfer_dtype": "int4"}),
    ]:
        cfg = DLRMConfig(**base, **kw, cache=CacheConfig(**{"ship_sort_perm": True, **cache_kw}))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
