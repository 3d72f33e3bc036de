"""The plain reference against the program at a tiny size on the CPU, and
the comparison's answer to faults planted under the timed path. These
tests import the program; the reference itself does not."""

import numpy as np
import pytest
import torch

import cachedembedding_tpu_torch.train.trainer as trainer_mod
from cachedembedding_tpu_torch.cache.host_table import row_bounds_of, table_bounds
from cachedembedding_tpu_torch.ops.synth_rows import synth_rows
from perfbench import faults, run
from perfbench.reference import training
from perfbench.tests.tiny import CASES, CELL, TABLES, tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77  # seeds may be larger than 32 signed bits hold


def _run(case, seed=SEED):
    config, mix, limits = tiny(case)
    return run.run_cell(CELL, seed, 0.5, False, CPU, config=config, mix=mix, limits=limits, warmup_iters=8)


def test_canonical_init_is_the_programs():
    rows = torch.tensor([0, 99, 100, 2099, 2100, 32099, 32100, 32106])
    offs = np.concatenate([[0], np.cumsum(TABLES)])
    bounds = torch.from_numpy(row_bounds_of(offs, table_bounds(TABLES), rows.numpy()))
    for seed in (0, 1024, SEED & 0xFFFFFFFF):
        want = synth_rows(rows, bounds, seed, 128)
        assert torch.equal(training.canonical_rows(rows, TABLES, seed, 128), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_agrees_with_the_reference(case):
    out, read = _run(case)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if case == "cached":  # the stretch wrote evicted rows back, and they were compared
        assert read["writeback_rows"] > 0 and "writeback_gap" in out["checks"]


def test_a_wrong_row_update_is_rejected(monkeypatch):
    orig = trainer_mod.binned_sgd_update

    def off_by_a_step(cw, g, perm, grouped, bins, slr):
        orig(cw, g, perm, grouped, bins, slr)
        rows = grouped[: grouped.shape[0] // 2].long()
        cw.index_add_(0, rows, torch.full((rows.shape[0], cw.shape[1]), 1e-3, dtype=cw.dtype))

    monkeypatch.setattr(trainer_mod, "binned_sgd_update", off_by_a_step)
    out, _ = _run("cached")
    assert not out["correct"]
    c = out["checks"]["stretch_change_gap_tables"]
    assert c["value"] > c["limit"]


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 0.5


def test_the_fed_grads_are_read(monkeypatch):
    """The tables' first gradient is the grad rows the update is fed: a
    backward that halves them on their way to the rows is seen there."""
    orig = trainer_mod.pool_uniform
    monkeypatch.setattr(trainer_mod, "pool_uniform", lambda *a, **k: _HalfGrad.apply(orig(*a, **k)))
    out, _ = _run("cached")
    c = out["checks"]["grad_gap_tables"]
    assert not out["correct"] and c["value"] > c["limit"]


@pytest.mark.parametrize("case, fault", [(c, f) for c in sorted(CASES) for f in faults.faults_of(tiny(c)[0])])
def test_planted_faults_are_rejected(case, fault):
    with faults.FAULTS[fault]():
        out, _ = _run(case)
    assert not out["correct"], out["checks"]
