"""DeepFM in the port (``models/deepfm.py`` and the trainer's model-family
dispatch) against the JAX package's: the same init from the same seed, the
forward on carried parameters, and the cached trainer's losses step by step
through eviction churn."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.models import deepfm as jax_deepfm
from cachedembedding_tpu.train.trainer import CachedDLRMTrainer as JaxTrainer
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
from cachedembedding_tpu_torch.models import deepfm
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

B, F, D, DIN, HIDDEN, DI = 64, 4, 16, 13, 32, 8


def _jax_params(seed):
    return jax_deepfm.init_deepfm(seed, D, F, DIN, HIDDEN, DI)


def test_init_matches_jax_and_params_carry_both_ways():
    ref = _jax_params(11)
    got = deepfm.init_deepfm(11, D, F, DIN, HIDDEN, DI)
    flat = lambda p: [np.asarray(x) for x in [*(v for l in p["dense_arch"] for v in (l["w"], l["b"])),
                                              p["deep_fm"]["w"], p["deep_fm"]["b"],
                                              p["over_arch"]["w"], p["over_arch"]["b"]]]
    for a, b in zip(flat(got), flat(ref._asdict())):
        np.testing.assert_array_equal(a, b)
    model = deepfm.DeepFM(D, F, DIN, HIDDEN, DI, seed=11)
    for a, b in zip(flat(deepfm.params_to_jax(model)), flat(ref._asdict())):
        np.testing.assert_array_equal(a, b)
    sd = deepfm.params_from_jax(ref)
    assert sd["deep_fm.weight"].shape == (DI, (F + 1) * D) and sd["over_arch.weight"].shape == (1, D + DI + 1)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_matches_jax(compute):
    """Carried (perturbed) parameters, the same inputs: probabilities within
    1e-5 in f32 compute, 2e-3 in bf16 compute (bf16 roundings of f32 values
    summed in another order). The FM term and the BCE match in f32."""
    rng = np.random.default_rng(0)
    params = jax_deepfm.DeepFMParams(*[
        jax_deepfm.init_deepfm(3, D, F, DIN, HIDDEN, DI)[i] for i in range(3)])
    params = type(params)(
        dense_arch=[{k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32) for k, v in l.items()}
                    for l in params.dense_arch],
        deep_fm=params.deep_fm, over_arch=params.over_arch)
    dense = rng.random((B, DIN)).astype(np.float32)
    sparse = (0.3 * rng.standard_normal((B, F, D))).astype(np.float32)
    labels = rng.integers(0, 2, B).astype(np.float32)
    jdt = getattr(jnp, compute)
    want = np.asarray(jax_deepfm.deepfm_forward(params, jnp.asarray(dense), jnp.asarray(sparse), jdt))
    model = deepfm.DeepFM(D, F, DIN, HIDDEN, DI, compute_dtype=getattr(torch, compute))
    model.load_state_dict(deepfm.params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(sparse)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5 if compute == "float32" else 2e-3, atol=1e-6)
    x = np.concatenate([dense[:, :1, None].repeat(D, 2), sparse], axis=1)
    np.testing.assert_allclose(deepfm.factorization_machine(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_deepfm.factorization_machine(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(deepfm.bce_probs(torch.from_numpy(want.copy()), torch.from_numpy(labels))),
                               float(jax_deepfm.bce_probs(jnp.asarray(want), jnp.asarray(labels))), rtol=1e-6)


TABLES = [50, 300, 4000, 20000]


def _cfg(cache_cls, cfg_cls, cache_ratio, cache_dtype):
    return cfg_cls(
        model="deepfm", deep_fm_dimension=DI,
        num_embeddings_per_feature=TABLES, embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), batch_size=256, learning_rate=0.5, compute_dtype="float32",
        cache=cache_cls(cache_ratio=cache_ratio, resident_threshold=500, prefetch_num=4, weight_init="virtual",
                        cache_dtype=cache_dtype, id_wire="plain"),
    )


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_deepfm_trainer_matches_jax_through_eviction_churn(cache_dtype):
    """The cached DeepFM trainer at the JAX CLI's ship_sort_perm=False, 8
    steps through a cache that evicts trained rows, then an evaluation:
    equal cache counts; f32 rows: losses within rtol 1e-5 and AUROC within
    1e-5; bf16 rows: losses within rtol 2e-2 (JAX differentiates w.r.t. the
    bf16 rows and upcasts each addend in its scatter; the port sums the same
    bf16 addends in f32 in another order, which can move a row's rounding by
    one ulp)."""
    train_j = JaxDataset(TABLES, 256, 8, dense_in_features=13, skew=0.5, seed=7)
    jt = JaxTrainer(_cfg(JaxCacheConfig, JaxDLRMConfig, 0.02, cache_dtype), id_freq_map=train_j.id_freq_map())
    rj = jt.train(train_j, num_iters=8)
    ej = jt.evaluate(JaxDataset(TABLES, 256, 4, dense_in_features=13, skew=0.5, seed=99))

    train = SyntheticLongTailDataset(TABLES, 256, 8, dense_in_features=13, skew=0.5, seed=7)
    pt = CachedDLRMTrainer(_cfg(CacheConfig, DLRMConfig, 0.02, cache_dtype), id_freq_map=train.id_freq_map(),
                           device="cpu")
    rp = pt.train(train, num_iters=8)
    ep = pt.evaluate(SyntheticLongTailDataset(TABLES, 256, 4, dense_in_features=13, skew=0.5, seed=99))
    pt.close()
    for k in ("num_hits_history", "num_miss_history", "num_write_back_history"):
        assert getattr(pt.embed.stats, k) == getattr(jt.embed.stats, k), k
    assert sum(pt.embed.stats.num_write_back_history) > 0, "this config must evict"
    assert np.isfinite(rp.losses).all() and len(rp.losses) == 8
    if cache_dtype == "float32":
        np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
        assert abs(ep["auroc"] - ej["auroc"]) <= 1e-5
    else:
        np.testing.assert_allclose(rp.losses, rj.losses, rtol=2e-2)
    assert ep["count"] == ej["count"] == 1024
