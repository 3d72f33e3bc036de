"""The bare module's surface (``CachedEmbeddingBag.forward`` / ``__call__``,
``set_cache_op``, ``cuda_row_num``, ``device_init``, ``cache_weight_mgr``)
in the port against the JAX package's bare module, on the CPU, on ids made
from a seed with numpy.

Tolerance: f32 rows, so a lookup is exact and a bag's sum differs only by
summation order (rtol 1e-6); the plans' counts are equal. The
``tests/test_cache.py`` property holds: a lookup equals the dense host table
under eviction churn."""

import numpy as np
import pytest
import torch

from cachedembedding_tpu.cache.manager import CachedEmbeddingBag as JaxBag
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag

SIZES = [400, 900, 200]
N = sum(SIZES)


def _bags(**kw):
    jax_kw = {k: v for k, v in kw.items()}
    jax_kw.setdefault("planner", "host")
    j = JaxBag(N, 8, table_sizes=SIZES, **jax_kw)
    p = CachedEmbeddingBag(N, 8, table_sizes=SIZES, device="cpu", **kw)
    return j, p


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


CASES = {
    "no_offsets": dict(),
    "offsets_last": dict(offsets=True, include_last_offset=True),
    "offsets_no_last": dict(offsets=True, include_last_offset=False),
    "per_sample_weights": dict(offsets=True, include_last_offset=True, weights=True),
    "shape_hook": dict(hook=True),
    "mean": dict(offsets=True, include_last_offset=True, mode="mean"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    c = CASES[case]
    rng = np.random.default_rng(1)
    kw = dict(cache_ratio=0.5, include_last_offset=c.get("include_last_offset", True), mode=c.get("mode", "sum"))
    jb, pb = _bags(**kw)
    F, B = 2, 6
    lengths = rng.integers(0, 4, F * B)
    values = rng.integers(0, N, int(lengths.sum())).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    if not c.get("include_last_offset", True):
        offsets = offsets[:-1]
    args = dict(num_features=F)
    if not c.get("offsets"):
        values = rng.integers(0, N, F * B).astype(np.int32)
        offsets = None
    w = rng.random(values.shape[0]).astype(np.float32) if c.get("weights") else None
    hook = (lambda t: t.reshape(t.shape[0], -1)) if c.get("hook") else None
    got = pb.forward(values, offsets, w, hook, **args)
    want = jb.forward(values, offsets, w, hook, **args)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    assert pb(values, offsets, w, hook, **args).shape == got.shape  # __call__
    assert pb.cache_weight_mgr is pb
    pb.close()


def test_set_cache_op_takes_slot_ids():
    """With ``cache_op`` off, forward takes pre-remapped slot ids and does no
    cache maintenance."""
    rng = np.random.default_rng(2)
    jb, pb = _bags(cache_ratio=0.3)
    ids = rng.integers(0, N, 40).astype(np.int32)
    slots = pb.prepare_ids(ids)
    jslots = jb.prepare_ids(ids)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    calls = pb.stats.prepare_calls
    pb.set_cache_op(False)
    jb.set_cache_op(False)
    got = pb.forward(slots)
    _close(got, jb.forward(jslots))
    assert pb.stats.prepare_calls == calls
    _close(got[:, 0], pb.dense_weight()[ids])
    pb.set_cache_op(True)
    _close(pb.forward(ids), got)
    pb.close()


def test_cuda_row_num_sets_capacity_and_exhaustion_raises():
    jb, pb = _bags(cuda_row_num=100)
    assert pb.capacity == jb.capacity == 100
    assert pb.cache_weight.shape[0] == 100
    pb.close()
    jb, pb = _bags(cuda_row_num=8)
    ids = np.arange(0, 64, dtype=np.int32)
    with pytest.raises(RuntimeError, match="capacity"):
        jb.prepare_ids(ids)
    with pytest.raises(RuntimeError, match="capacity"):
        pb.prepare_ids(ids)
    pb.close()


@pytest.mark.parametrize("device_init", ["auto", "on", "off"])
def test_device_init_matches_jax(device_init):
    """"auto"/"on": never-trained admits are synthesized on the device;
    "off": every admit is fetched from the host table. Same counts as JAX,
    same rows."""
    rng = np.random.default_rng(3)
    jb, pb = _bags(cache_ratio=0.2, device_init=device_init)
    assert pb.device_init == jb.device_init == (device_init != "off")
    for _ in range(3):
        ids = rng.integers(0, N, 120).astype(np.int32)
        _close(pb.forward(ids), jb.forward(ids))
    for k in ("synth_rows", "swap_in_bytes", "num_hits_history", "num_miss_history"):
        assert getattr(pb.stats, k) == getattr(jb.stats, k), k
    assert (pb.stats.synth_rows > 0) == (device_init != "off")
    pb.close()


def test_device_init_errors_match_jax():
    for kw in (dict(device_init="on", weight_init="zeros"), dict(device_init="sometimes")):
        with pytest.raises(ValueError):
            JaxBag(N, 8, table_sizes=SIZES, planner="host", **kw)
        with pytest.raises(ValueError):
            CachedEmbeddingBag(N, 8, table_sizes=SIZES, device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_equals_dense_table_under_churn(seed):
    """tests/test_cache.py's property: through a small cache with eviction
    churn (and with rows changed on the device before they are evicted), a
    lookup always equals the host table's rows, and JAX's lookup."""
    rng = np.random.default_rng(seed)
    jb, pb = _bags(cuda_row_num=64, buffer_size=0)
    for step in range(12):
        ids = np.unique(rng.integers(0, N, 48)).astype(np.int32)
        got = pb.forward(ids)
        _close(got, jb.forward(ids))
        _close(got[:, 0], pb.dense_weight()[ids])
        if step % 3 == 0:  # train a row in both: it must survive its eviction
            with torch.no_grad():
                pb.cache_weight.mul_(1.5)
            jb.cache_weight = jb.cache_weight * 1.5
    assert sum(pb.stats.num_write_back_history) > 0
    assert pb.stats.num_write_back_history == jb.stats.num_write_back_history
    pb.close()
