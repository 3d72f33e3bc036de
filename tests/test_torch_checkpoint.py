"""Checkpoint and resume in the port (``utils/checkpoint.py``): a round trip
through save and load evaluates bit for bit as the saved trainer (dense,
virtual and resident tables; DLRM and DeepFM), and checkpoints cross between
the packages in both directions."""

import json

import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.utils import checkpoint as jax_ckpt
from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

TABLES = [400, 300]


def _cfg(cache_cls=CacheConfig, cfg_cls=DLRMConfig, model="dlrm", **kw):
    return cfg_cls(
        model=model, deep_fm_dimension=8,
        num_embeddings_per_feature=TABLES, embedding_dim=16, dense_in_features=4,
        dense_arch_layer_sizes=(16, 16), over_arch_layer_sizes=(16, 8, 1),
        batch_size=128, learning_rate=0.3,
        cache=cache_cls(**{"cache_ratio": 0.4, "warmup_ratio": 0.7, "buffer_size": 0, "prefetch_num": 2, **kw}),
    )


def _data(cls, n, seed):
    return cls(TABLES, 128, n, dense_in_features=4, seed=seed)


def _scores(monkeypatch, mod, trainer, data):
    got = []

    class Recording(mod.StreamingMetrics):
        def update(self, s, labels):
            got.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)
    m = trainer.evaluate(data)
    return m, np.concatenate(got)


def _port_trainer(kind, cfg, freq):
    if kind == "resident":
        embed = FullyResidentEmbeddingBag(sum(TABLES), 16, table_sizes=TABLES, seed=cfg.seed, device="cpu")
        return port_trainer_mod.CachedDLRMTrainer(cfg, embed_override=embed)
    return port_trainer_mod.CachedDLRMTrainer(cfg, id_freq_map=freq, device="cpu")


@pytest.mark.parametrize("kind,model", [("uniform", "dlrm"), ("virtual", "dlrm"), ("resident", "dlrm"),
                                        ("uniform", "deepfm")])
def test_round_trip_evaluates_bit_for_bit(kind, model, tmp_path, monkeypatch):
    cfg = _cfg(model=model, weight_init="virtual" if kind == "virtual" else "uniform")
    data = _data(SyntheticLongTailDataset, 6, 1)
    t1 = _port_trainer(kind, cfg, data.id_freq_map())
    t1.train(data, num_iters=6)
    save_checkpoint(str(tmp_path / "ckpt"), t1)
    m1, s1 = _scores(monkeypatch, port_trainer_mod, t1, _data(SyntheticLongTailDataset, 2, 9))
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["step"] == 6 and meta["table_kind"] == ("virtual" if kind == "virtual" else "dense")
    assert (tmp_path / "ckpt" / ("overlay.npz" if kind == "virtual" else "host_table.npy")).exists()

    t2 = _port_trainer(kind, cfg, data.id_freq_map())
    assert load_checkpoint(str(tmp_path / "ckpt"), t2) == 6 and t2._step_idx == 6
    m2, s2 = _scores(monkeypatch, port_trainer_mod, t2, _data(SyntheticLongTailDataset, 2, 9))
    np.testing.assert_array_equal(s2, s1)
    assert m1 == m2
    rep = t2.train(data, num_iters=2)  # training continues
    assert np.isfinite(rep.losses).all()
    t1.close()
    t2.close()


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint the JAX package saved, loaded into the port, evaluates as
    JAX's own load of it does (f32 rows: scores within rtol 1e-5, AUROC
    within 1e-6); and the port's checkpoint loads into JAX with the same dense
    weights and table."""
    kw = dict(cache_dtype="float32")
    jdata = _data(JaxDataset, 6, 1)
    j1 = jax_trainer_mod.CachedDLRMTrainer(_cfg(JaxCacheConfig, JaxDLRMConfig, **kw), id_freq_map=jdata.id_freq_map())
    j1.train(jdata, num_iters=6)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), j1)
    j2 = jax_trainer_mod.CachedDLRMTrainer(_cfg(JaxCacheConfig, JaxDLRMConfig, **kw), id_freq_map=jdata.id_freq_map())
    jax_ckpt.load_checkpoint(str(tmp_path / "jax"), j2)
    mj, sj = _scores(monkeypatch, jax_trainer_mod, j2, _data(JaxDataset, 2, 9))

    p = port_trainer_mod.CachedDLRMTrainer(_cfg(**kw), id_freq_map=jdata.id_freq_map(), device="cpu")
    assert load_checkpoint(str(tmp_path / "jax"), p) == 6
    mp, sp = _scores(monkeypatch, port_trainer_mod, p, _data(SyntheticLongTailDataset, 2, 9))
    np.testing.assert_allclose(sp, sj, rtol=1e-5)
    assert abs(mp["auroc"] - mj["auroc"]) <= 1e-6 and mp["count"] == mj["count"]

    save_checkpoint(str(tmp_path / "port"), p)
    j3 = jax_trainer_mod.CachedDLRMTrainer(_cfg(JaxCacheConfig, JaxDLRMConfig, **kw), id_freq_map=jdata.id_freq_map())
    assert jax_ckpt.load_checkpoint(str(tmp_path / "port"), j3) == 6
    want = np.load(tmp_path / "jax" / "dense_params.npz")
    got = np.load(tmp_path / "port" / "dense_params.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "host_table.npy"),
                                  np.load(tmp_path / "jax" / "host_table.npy"))
    p.close()


def test_load_refuses_other_shapes(tmp_path):
    cfg = _cfg()
    t1 = port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
    save_checkpoint(str(tmp_path), t1)
    t1.close()
    other = _cfg()
    other.num_embeddings_per_feature = [400, 301]
    t2 = port_trainer_mod.CachedDLRMTrainer(other, device="cpu")
    with pytest.raises(ValueError, match="checkpoint table"):
        load_checkpoint(str(tmp_path), t2)
    t2.close()
    # Adagrad state loads into an Adagrad trainer, and must have the table's shape
    meta = json.loads((tmp_path / "meta.json").read_text())
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "optimizer": "rowwise_adagrad"}))
    acc = np.linspace(0.0, 2.0, sum(TABLES), dtype=np.float32)
    np.save(tmp_path / "accum.npy", acc)
    adagrad = _cfg()
    adagrad.embedding_optimizer = "rowwise_adagrad"
    t3 = port_trainer_mod.CachedDLRMTrainer(adagrad, device="cpu")
    assert load_checkpoint(str(tmp_path), t3) == 0
    np.testing.assert_array_equal(t3.embed.host_accum.arr, acc)
    t3.close()
    np.save(tmp_path / "accum.npy", acc[1:])
    t4 = port_trainer_mod.CachedDLRMTrainer(adagrad, device="cpu")
    with pytest.raises(ValueError, match="checkpoint accumulators"):
        load_checkpoint(str(tmp_path), t4)
    t4.close()
    assert torch.is_tensor(t4.embed.cache_weight)
