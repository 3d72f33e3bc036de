"""The packed window (one host-to-device transfer of ids, dense features,
labels and admits per window, ``train/wire.py``) through the port's trainer,
on the CPU: against the JAX package's ``CachedDLRMTrainer`` with int8 and
int4 dense inputs on uniform, ragged and fully resident windows; every id
wire against the plain one in the port; and the one copy per window.

Tolerances, as the trainer tests of the same branches state them: counts
equal; uniform windows on bf16 rows (the plan branch) losses and scores
within rtol 1e-4 and the flushed rows at most 0.5% of the elements one bf16
step apart; ragged windows as ``tests/test_torch_ragged_window.py`` (rtol
1e-5); the resident table as ``tests/test_torch_baselines.py`` (losses rtol
1e-5, scores 1e-4). The id wires are lossless: the same losses and rows, bit
for bit."""

import numpy as np
import pytest
import torch

import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
import torch_parity as tp
from cachedembedding_tpu.baselines.full_resident import FullyResidentEmbeddingBag as JaxResident
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.train.trainer import CachedDLRMTrainer as JaxTrainer
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset


@pytest.mark.parametrize("dense", ["int8", "int4"])
def test_uniform_windows_with_quantized_dense_match_jax(dense, monkeypatch):
    ref = tp.run(False, monkeypatch, dense_input_dtype=dense)
    got = tp.run(True, monkeypatch, dense_input_dtype=dense)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4, atol=1e-6)
    steps = tp.storage_steps(got["rows"], ref["rows"], torch.bfloat16)
    assert (steps > 0).mean() <= 5e-3 and steps.max() <= 1
    # the quantized features differ from the bf16 ones: the option is live
    plain = tp.run(True, monkeypatch)
    assert not np.array_equal(plain["losses"], got["losses"])


@pytest.mark.parametrize("dense", ["int8", "int4"])
def test_ragged_windows_with_quantized_dense_match_jax(dense, monkeypatch):
    from test_torch_ragged_window import _compare, _run

    ref = _run(False, monkeypatch, dense_input_dtype=dense)
    got = _run(True, monkeypatch, dense_input_dtype=dense)
    _compare(got, ref)


def test_resident_windows_with_int8_dense_match_jax(monkeypatch):
    """A fully resident table trains its uniform windows on the int8 dense
    wire (JAX packs them too) and scores batches on the f32 features."""
    from test_torch_baselines import TABLES, _cfg, _data, _port_resident, _recording

    from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
    from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
    import cachedembedding_tpu.train.trainer as jax_trainer_mod

    jscores, pscores = [], []
    _recording(monkeypatch, jax_trainer_mod, jscores)
    _recording(monkeypatch, port_trainer_mod, pscores)
    jcfg = _cfg(JaxCacheConfig, JaxDLRMConfig)
    jcfg.dense_input_dtype = "int8"
    jt = JaxTrainer(jcfg, embed_override=JaxResident(sum(TABLES), 16, table_sizes=TABLES, seed=jcfg.seed))
    rj = jt.train(_data(JaxDataset), num_iters=6)
    jt.evaluate(_data(JaxDataset, 2, seed=5))
    cfg = _cfg(CacheConfig, DLRMConfig)
    cfg.dense_input_dtype = "int8"
    pt = port_trainer_mod.CachedDLRMTrainer(cfg, embed_override=_port_resident(cfg))
    rp = pt.train(_data(SyntheticLongTailDataset), num_iters=6)
    pt.evaluate(_data(SyntheticLongTailDataset, 2, seed=5))
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(pscores), np.concatenate(jscores), rtol=1e-4)
    assert all(w["dense"] == "int8" and w["format"] == "fixed" for w in rp.window_wire)


def _wire_run(id_wire, resident_threshold=500, steps=32):
    """The port alone, its id wire's learning shortened (as the JAX tests
    shorten it): the escape spec freezes after 2 windows, the rank-tier spec
    skips 1 and freezes after 3."""
    cfg = tp.config(True, id_wire=id_wire, resident_threshold=resident_threshold)
    train = tp.data(True, steps, 7)
    tr = port_trainer_mod.CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device="cpu")
    tr.wire._esc_learn_windows = 2
    tr.wire._RT_SKIP_WINDOWS, tr.wire._RT_LEARN_WINDOWS = 1, 4
    rep = tr.train(train, num_iters=steps)
    ev = tr.evaluate(tp.data(True, 4, 99))
    rows = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in train])).astype(np.int64)
    tr.embed.flush()
    out = dict(losses=np.asarray(rep.losses), auroc=ev["auroc"], rows=tr.embed.host_table.gather(rows),
               formats=[w["format"] for w in rep.window_wire])
    tr.close()
    return out


@pytest.mark.parametrize("resident_threshold", [500, 0], ids=["resident_split", "all_cached"])
def test_id_wires_are_lossless(resident_threshold):
    """plain, escape and rank-tier ship the same ids: the same losses, AUROC
    and flushed rows, bit for bit, past each wire's freeze."""
    runs = {w: _wire_run(w, resident_threshold) for w in ("plain", "escape", "ranktier")}
    # an all-cached bag without the escape wire ships one fixed width, as in JAX
    assert set(runs["plain"]["formats"]) == {"plain" if resident_threshold else "fixed"}
    assert "rt" in runs["ranktier"]["formats"]
    # all-cached slot ids here do not narrow: the escape spec learns "off" (legal in JAX too)
    assert ("esc" in runs["escape"]["formats"]) == bool(resident_threshold)
    for w in ("escape", "ranktier"):
        np.testing.assert_array_equal(runs[w]["losses"], runs["plain"]["losses"])
        np.testing.assert_array_equal(runs[w]["rows"], runs["plain"]["rows"])
        assert runs[w]["auroc"] == runs["plain"]["auroc"]


@pytest.mark.parametrize("ragged", [False, True])
def test_one_host_to_device_copy_per_window(ragged, monkeypatch):
    """Every window, uniform or ragged, training or evaluation, makes
    exactly one host-to-device copy: its buffer (ids, dense features,
    labels, admits, update plans and the writebacks' slots)."""
    if ragged:
        from test_torch_ragged_window import BATCH, _cfg, _traces

        from cachedembedding_tpu_torch.data.synth import SynthTraceDataset

        traces, sizes = _traces()
        cfg = _cfg(True, sizes, cache_ratio=0.5)
        train = SynthTraceDataset(traces, sizes, batch_size=BATCH, num_batches=8, dense_in_features=4)
        test = SynthTraceDataset(traces, sizes, batch_size=BATCH, num_batches=4, dense_in_features=4, seed=99)
        tr = port_trainer_mod.CachedDLRMTrainer(cfg, device="cpu")
    else:
        cfg = tp.config(True, dense_input_dtype="int8", transfer_dtype="int8", cache_ratio=0.025)
        train, test = tp.data(True, 24, 7), tp.data(True, 8, 99)
        tr = port_trainer_mod.CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device="cpu")
    copies = []
    real = tr.embed.to_device
    monkeypatch.setattr(tr.embed, "to_device", lambda a: copies.append(a) or real(a))
    rep = tr.train(train, num_iters=len(train))
    windows = len(rep.window_wire)
    assert len(copies) == windows and all(c.dtype == torch.uint8 for c in copies)
    if not ragged:
        assert sum(w["bytes"]["admits"] > 0 for w in rep.window_wire) > 0
        assert sum(tr.embed.stats.num_write_back_history) > 0
    copies.clear()
    tr.evaluate(test)
    assert len(copies) == -(-len(test) // cfg.cache.prefetch_num)
    tr.close()
