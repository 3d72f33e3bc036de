"""The fully resident table (``baselines/full_resident.py``) through the port's
trainer: against the JAX package's ``embed_override`` trainer, against the
port's own cached path (the cache is transparent), and f32 rows with
stochastic rounding on, which take Kernel 2's path."""

import numpy as np
import pytest
import torch

import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.baselines.full_resident import FullyResidentEmbeddingBag as JaxResident
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.train.trainer import CachedDLRMTrainer as JaxTrainer
from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

TABLES = [600, 400, 3000]


def _cfg(cache_cls, cfg_cls, model="dlrm", **cache_kw):
    return cfg_cls(
        model=model, deep_fm_dimension=8,
        num_embeddings_per_feature=TABLES, embedding_dim=16, dense_in_features=4,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1),
        batch_size=128, learning_rate=0.5,
        cache=cache_cls(**{"cache_ratio": 1.0, "warmup_ratio": 0.0, "buffer_size": 0, "prefetch_num": 2,
                           "use_freq": False, "use_lfu_eviction": True, **cache_kw}),
    )


def _data(cls, n=6, seed=21):
    return cls(TABLES, 128, n, dense_in_features=4, seed=seed)


def _port_resident(cfg, dtype=torch.float32):
    return FullyResidentEmbeddingBag(sum(TABLES), 16, table_sizes=TABLES, seed=cfg.seed, dtype=dtype, device="cpu")


def test_resident_table_is_the_canonical_init():
    """The device fill (ops/synth_rows.py) equals the cached path's host
    table filled by the canonical generator, bit for bit."""
    cfg = _cfg(CacheConfig, DLRMConfig)
    res = _port_resident(cfg)
    bag = CachedEmbeddingBag(sum(TABLES), 16, table_sizes=TABLES, seed=cfg.seed, warmup_ratio=0.0, device="cpu")
    np.testing.assert_array_equal(res.dense_weight(), bag.host_table.array)
    np.testing.assert_array_equal(JaxResident(sum(TABLES), 16, table_sizes=TABLES, seed=cfg.seed).cache_weight,
                                  res.cache_weight.numpy())
    bag.close()
    assert res.device_rows == res.capacity == sum(TABLES)


def _recording(monkeypatch, mod, scores):
    class Recording(mod.StreamingMetrics):
        def update(self, s, labels):
            scores.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)


@pytest.mark.parametrize("model", ["dlrm", "deepfm"])
def test_resident_trainer_matches_jax(model, monkeypatch):
    """f32 resident rows, the JAX CLI's defaults (ship_sort_perm=False):
    losses within rtol 1e-5 step by step; evaluation scores within rtol 1e-4
    as in the cached slice's test (the AUROC of 256 scores moves by 6e-5 when
    one near-tie flips, so the scores are compared)."""
    import cachedembedding_tpu.train.trainer as jax_trainer_mod

    jscores, pscores = [], []
    _recording(monkeypatch, jax_trainer_mod, jscores)
    _recording(monkeypatch, port_trainer_mod, pscores)
    jcfg = _cfg(JaxCacheConfig, JaxDLRMConfig, model)
    jt = JaxTrainer(jcfg, embed_override=JaxResident(sum(TABLES), 16, table_sizes=TABLES, seed=jcfg.seed))
    rj = jt.train(_data(JaxDataset), num_iters=6)
    ej = jt.evaluate(_data(JaxDataset, 2, seed=5))
    cfg = _cfg(CacheConfig, DLRMConfig, model)
    pt = CachedDLRMTrainer(cfg, embed_override=_port_resident(cfg))
    assert pt.device.type == "cpu" and not pt._sr
    rp = pt.train(_data(SyntheticLongTailDataset), num_iters=6)
    ep = pt.evaluate(_data(SyntheticLongTailDataset, 2, seed=5))
    assert np.isfinite(rp.losses).all() and len(rp.losses) == 6
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(pscores), np.concatenate(jscores), rtol=1e-4)
    assert ep["count"] == ej["count"] == 256
    assert rp.hit_rate == rj.hit_rate == 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resident_matches_cached_training(dtype):
    """The cache is transparent: the same data and seeds give the same
    losses through the cache and through the resident table (JAX's oracle,
    ``tests/test_baselines.py``), and the same table in the rows' dtype."""
    cfg = _cfg(CacheConfig, DLRMConfig, cache_dtype=dtype)
    cached = CachedDLRMTrainer(cfg, device="cpu")
    r_cached = cached.train(_data(SyntheticLongTailDataset), num_iters=6)
    base = CachedDLRMTrainer(cfg, embed_override=_port_resident(cfg, cached.embed.dtype))
    r_base = base.train(_data(SyntheticLongTailDataset), num_iters=6)
    assert np.isfinite(r_base.losses).all()
    np.testing.assert_allclose(r_base.losses, r_cached.losses, rtol=2e-5)
    # the host master keeps never-cached rows in f32: compare in the row dtype
    rows = torch.from_numpy(cached.embed.dense_weight()).to(cached.embed.dtype).float().numpy()
    np.testing.assert_array_equal(base.embed.dense_weight(), rows)
    cached.close()


def _forbid_kernel3(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("f32 rows must not build the (C, D) f32 grad")

    monkeypatch.setattr(port_trainer_mod, "binned_scatter_add", refuse)


@pytest.mark.parametrize("rounding", ["on", "auto"])
def test_f32_rows_with_stochastic_rounding_take_kernel_2(rounding, monkeypatch):
    """f32 rows with rounding on (cached, "on"), and the resident f32 table
    under fp8 cache flags ("auto" with cache_dtype float8_e4m3fn, as the CLI
    builds it without --use_cache): the rounding branch reduces to cw - slr *
    g, so the trainer takes Kernel 2 (no Kernel 3 grad) and matches the JAX
    rounding branch's losses (rtol 1e-5) and the port with rounding off."""
    if rounding == "on":
        kw = dict(cache_dtype="float32", stochastic_rounding="on")
        jcfg = _cfg(JaxCacheConfig, JaxDLRMConfig, **kw)
        jt = JaxTrainer(jcfg)
        mk = lambda cfg: CachedDLRMTrainer(cfg, device="cpu")
    else:
        kw = dict(cache_dtype="float8_e4m3fn", stochastic_rounding="auto")
        jcfg = _cfg(JaxCacheConfig, JaxDLRMConfig, **kw)
        jt = JaxTrainer(jcfg, embed_override=JaxResident(sum(TABLES), 16, table_sizes=TABLES, seed=jcfg.seed))
        mk = lambda cfg: CachedDLRMTrainer(cfg, embed_override=_port_resident(cfg))
    assert jt._sr
    rj = jt.train(_data(JaxDataset), num_iters=6)
    cfg = _cfg(CacheConfig, DLRMConfig, **kw)
    assert cfg.cache.rounds_stochastically
    _forbid_kernel3(monkeypatch)
    pt = mk(cfg)
    assert not pt._sr and pt.embed.cache_weight.dtype == torch.float32
    rp = pt.train(_data(SyntheticLongTailDataset), num_iters=6)
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
    off = mk(_cfg(CacheConfig, DLRMConfig, **{**kw, "stochastic_rounding": "off", "cache_dtype": "float32"}))
    assert off.train(_data(SyntheticLongTailDataset), num_iters=6).losses == rp.losses


def test_resident_protocol_and_refusals():
    cfg = _cfg(CacheConfig, DLRMConfig)
    res = _port_resident(cfg)
    ws = res.begin_window_staging(np.arange(12, dtype=np.int32), (3, 4))
    assert ws.slot_ids.shape == (3, 4) and ws.slot_ids[2, 3] == 11
    res.enqueue_writebacks(ws)
    res.apply_admits(ws)
    assert torch.equal(res.prepare_ids(torch.tensor([5, 7])), torch.tensor([5, 7], dtype=torch.int32))
    with pytest.raises(ValueError, match="out of range"):
        res.begin_window_staging(np.array([sum(TABLES)], np.int32), (1,))
    with pytest.raises(ValueError, match="lives on"):
        CachedDLRMTrainer(cfg, device="meta", embed_override=res)
    zeros = FullyResidentEmbeddingBag(10, 4, weight_init="zeros", dtype="bfloat16", device="cpu")
    assert zeros.cache_weight.dtype == torch.bfloat16 and not zeros.cache_weight.any()
