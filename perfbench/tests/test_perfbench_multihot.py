"""Multi-hot bags (``traffic.py``'s ``companions_uniform`` rule) and row-wise
Adagrad in the check, on the CPU at a tiny size: the companions are fixed and
uniform, the frequency map follows the stream, and a configuration that the
harness takes as data alone (``tiny.multihot``) reads correct when sound and
not correct under each fault it can have."""

import copy

import numpy as np
import pytest
import torch
from scipy import stats as sps

from perfbench import faults, run
from perfbench.tests.tiny import multihot
from perfbench.traffic import Stream, companion

CPU = torch.device("cpu")
TABLES = [100, 2000, 30000, 7]
SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)


def _stream(hotness, seed=2**31 + 7, chunk=4, batch=64, freq_batches=50):
    mix = {"name": "t", "ids": {"law": "inverse_cdf_power", "skew": 0.5}, "labels": "random",
           "dense": "uniform01", "batch_size": batch, "chunk_batches": chunk, "freq_map_batches": freq_batches}
    if hotness is not None:
        mix["bags"] = {"rule": "companions_uniform", "hotness": list(hotness)}
    return Stream(mix, TABLES, 5, seed, CPU)


def _bags(batch, hotness):
    """Feature f's (B, h_f) bags of a batch."""
    vals, B = batch.sparse_features.values.numpy().astype(np.int64), batch.batch_size
    out, at = [], 0
    for h in hotness:
        out.append(vals[at:at + B * h].reshape(B, h))
        at += B * h
    return out


@pytest.mark.parametrize("hotness", [(3, 1, 5, 2), (4, 4, 4, 4)], ids=["ragged", "uniform"])
def test_bags_hold_the_drawn_id_and_its_fixed_companions(hotness):
    one_hot = _stream(None).batches(0, 6)
    multi = _stream(hotness).batches(0, 6)
    offs = np.concatenate([[0], np.cumsum(TABLES)])
    for b1, bm in zip(one_hot, multi):
        f = bm.sparse_features
        if len(set(hotness)) == 1:
            assert f.offsets is None and f.pooling == hotness[0]
        else:
            assert f.pooling is None and torch.equal(f.lengths(), torch.tensor(hotness).repeat_interleave(64).int())
        drawn = b1.sparse_features.values.numpy().reshape(len(TABLES), -1)
        for t, bag in enumerate(_bags(bm, hotness)):
            assert (bag[:, 0] == drawn[t]).all()  # the law's draw, as without bags
            for j in range(1, hotness[t]):
                want = companion(torch.from_numpy(bag[:, 0]), j) % TABLES[t] + offs[t]
                assert (bag[:, j] == want.numpy()).all()
        assert torch.equal(b1.dense_features, bm.dense_features) and torch.equal(b1.labels, bm.labels)


def test_companions_are_the_same_across_batches_chunks_and_seeds():
    hot = (3, 1, 5, 2)
    a = _stream(hot).batches(0, 8)
    for start, n in ((2, 6), (3, 2), (5, 3)):  # other calls, across the chunks of 4
        for x, y in zip(a[start:], _stream(hot).batches(start, n)):
            assert torch.equal(x.sparse_features.values, y.sparse_features.values)
    # another seed draws other ids; an id drawn under both has the same companions
    seen = {}
    for seed in (11, 12):
        for batch in _stream(hot, seed=seed).batches(0, 4):
            for bag in _bags(batch, hot)[2]:
                assert seen.setdefault(int(bag[0]), tuple(bag[1:])) == tuple(bag[1:])


def test_companions_are_uniform_over_a_table():
    E, gids = 101, torch.arange(5000, 35000)
    counts = np.zeros(E)
    for j in range(1, 5):
        counts += np.bincount((companion(gids, j) % E).numpy(), minlength=E)
    assert sps.chisquare(counts).pvalue > 1e-3
    # companions of one id differ from j to j as independent draws would
    c = torch.stack([companion(gids, j) % 30000 for j in range(1, 5)])
    assert (c[0] == c[1]).float().mean() < 1e-3


def test_frequency_map_follows_the_stream():
    hot, n = (3, 1, 5, 2), 200
    s = _stream(hot, freq_batches=n)
    freq = s.freq_map()
    seen = np.bincount(np.concatenate([b.sparse_features.values.numpy() for b in s.batches(0, n)]),
                       minlength=sum(TABLES))
    offs = np.concatenate([[0], np.cumsum(TABLES)])
    for t, h in enumerate(hot):
        f, e = freq[offs[t]:offs[t + 1]], seen[offs[t]:offs[t + 1]]
        # Poisson noise, and the map's truncation to whole counts (each contributing id's fraction)
        assert (np.abs(e - f) <= 6 * np.sqrt(f + 1) + 2 * h).all(), t
        assert abs(e.sum() - f.sum()) <= 0.02 * e.sum() + TABLES[t] * h, t
    assert np.array_equal(_stream(None).freq_map(), _stream((1, 1, 1, 1)).freq_map())


def _run(config, mix, limits, seed):
    return run.run_cell("tiny-multihot", seed, 0.5, False, CPU, config=config, mix=mix, limits=limits,
                        warmup_iters=8)


def test_reference_adagrad_agrees_with_the_programs():
    """With every dtype f32, the port's cached row-wise Adagrad on ragged
    bags (Kernel 5's dense ragged entry, its plain version here) and the
    reference agree to f32 round-off."""
    config, mix, limits = (copy.deepcopy(x) for x in multihot())
    config["dlrm"].update(compute_dtype="float32", dense_input_dtype="float32")
    config["cache"].update(cache_dtype="float32", transfer_dtype="float32")
    config["precision"].update(stored_rows="float32", dense_wire="float32")
    out, read = _run(config, mix, limits, SEEDS[0])
    assert out["correct"] and read["writeback_rows"] > 0
    for k, c in out["checks"].items():
        assert c["value"] < 1e-5, (k, c)


@pytest.mark.parametrize("seed", SEEDS)
def test_multihot_adagrad_case_is_correct(seed):
    out, read = _run(*multihot(), seed)
    assert out["correct"], out["checks"]
    assert read["writeback_rows"] > 0 and "accum_gap" in out["checks"]


@pytest.mark.parametrize("fault", faults.faults_of(multihot()[0]) + ["control"])
def test_multihot_adagrad_case_rejects_faults(fault):
    config, mix, limits = multihot()
    if fault == "control":
        out, _ = _run(faults.control_config(config), mix, limits, SEEDS[0])
    else:
        with faults.FAULTS[fault]():
            out, _ = _run(config, mix, limits, SEEDS[0])
    assert not out["correct"], out["checks"]


def test_accum_frozen_is_a_fault_of_adagrad_configurations_only():
    assert "accum_frozen" in faults.faults_of(multihot()[0])
    sgd = copy.deepcopy(multihot()[0])
    sgd["dlrm"]["embedding_optimizer"] = "sgd"
    assert "accum_frozen" not in faults.faults_of(sgd)
