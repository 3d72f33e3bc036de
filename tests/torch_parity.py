"""Shared by the trainer parity tests of the port (``test_torch_adagrad``,
``test_torch_sparse_grad``, ``test_torch_fp8_variants``): one small cached
DLRM run in the JAX package or in the port, on the same seeded synthetic
stream, and what the tests compare; and, for the table-wise and hybrid
tests, JAX's dense weights carried to spawned ranks and held against the
port's. The JAX trainer runs with
use_pallas_lookup=False (its evaluate vmaps the Pallas gather, which its CPU
interpreter cannot run; the jnp.take lookup computes the same function)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

TABLES = [50, 300, 4000, 20000]
BATCH = 256
STATS = ("num_hits_history", "num_miss_history", "num_write_back_history", "swap_in_bytes",
         "swap_out_bytes", "prepare_calls", "synth_rows")


def config(port: bool, compute="float32", cache_dtype="bfloat16", tables=TABLES, **kw):
    """The slice at a small width; ``kw`` sets DLRMConfig fields and, where
    they are CacheConfig's, the cache's."""
    cache_cls, cfg_cls = (CacheConfig, DLRMConfig) if port else (JaxCacheConfig, JaxDLRMConfig)
    cache_fields = set(cache_cls.__dataclass_fields__)
    cache_kw = dict(cache_ratio=0.1, resident_threshold=500, prefetch_num=4, weight_init="virtual",
                    ship_sort_perm=True, cache_dtype=cache_dtype, use_pallas_lookup=port)
    cache_kw.update({k: v for k, v in kw.items() if k in cache_fields})
    return cfg_cls(
        num_embeddings_per_feature=list(tables), embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1), batch_size=BATCH,
        learning_rate=kw.get("learning_rate", 1.0), compute_dtype=compute,
        **{k: v for k, v in kw.items() if k not in cache_fields and k != "learning_rate"},
        cache=cache_cls(**cache_kw),
    )


def data(port: bool, n: int, seed: int, tables=TABLES):
    cls = SyntheticLongTailDataset if port else JaxDataset
    return cls(list(tables), BATCH, n, dense_in_features=13, skew=0.5, seed=seed)


def run(port: bool, monkeypatch, steps=8, eval_batches=4, tables=TABLES, **kw):
    """Train ``steps`` steps and evaluate ``eval_batches`` batches. Returns the
    losses, the evaluation, its scores, the cache counts, the training
    stream's rows flushed to the host table, their row-wise Adagrad
    accumulators (None under SGD) and the trainer (closed)."""
    mod = port_trainer_mod if port else jax_trainer_mod
    cfg = config(port, tables=tables, **kw)
    scores = []

    class Recording(mod.StreamingMetrics):
        def update(self, s, labels):
            scores.append(np.asarray(s, np.float32).reshape(-1))
            super().update(s, labels)

    monkeypatch.setattr(mod, "StreamingMetrics", Recording)
    train = data(port, steps, 7, tables)
    test = data(port, eval_batches, 99, tables)
    extra = {"device": "cpu"} if port else {}
    tr = mod.CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), **extra)
    rep = tr.train(train, num_iters=steps)
    ev = tr.evaluate(test)
    rows = np.unique(np.concatenate([np.asarray(b.sparse_features.values) for b in train])).astype(np.int64)
    tr.embed.flush()
    flushed = np.asarray(tr.embed.host_table.gather(rows), np.float32)
    acc = tr.embed.host_accum.gather(rows) if getattr(tr.embed, "host_accum", None) is not None else None
    stats = {k: getattr(tr.embed.stats, k) for k in STATS}
    if port:
        tr.close()
    return dict(losses=np.asarray(rep.losses), ev=ev, scores=np.concatenate(scores), stats=stats,
                rows=flushed, accum=None if acc is None else np.asarray(acc, np.float32), trainer=tr)


def jax_uniform(seed, shape, device=None):
    """JAX's rounding uniforms for one step seed (what its emulation draws):
    monkeypatched over the port's ``philox_uniform`` so both round alike."""
    u = jax.random.uniform(jax.random.PRNGKey(jnp.uint32(seed)), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


def storage_steps(a: np.ndarray, b: np.ndarray, dtype) -> np.ndarray:
    """Distance in representables of ``dtype`` between arrays of its values."""
    from cachedembedding_tpu_torch.ops.rounding import storage_steps as steps

    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b)]
    return steps(*t, dtype).numpy()


def numpy_params(params) -> dict:
    """JAX's ``DLRMParams`` as a picklable dict of numpy arrays, which the
    port's ``models/dlrm.params_from_jax`` takes."""
    return {a: [{k: np.asarray(v) for k, v in layer.items()} for layer in getattr(params, a)]
            for a in ("dense_arch", "over_arch")}


def assert_params_close(port_params: dict, jax_params, rtol: float = 1e-4, atol: float = 1e-6) -> None:
    """The port's dense weights (``models/dlrm.params_to_jax``'s dict)
    against JAX's ``DLRMParams``, layer by layer."""
    want = numpy_params(jax_params)
    for arch in ("dense_arch", "over_arch"):
        assert len(port_params[arch]) == len(want[arch])
        for got, ref in zip(port_params[arch], want[arch]):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol)
