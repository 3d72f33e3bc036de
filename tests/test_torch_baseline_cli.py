"""The port's baseline command line (``baselines/dlrm_main.py``) against the
JAX package's on the same Kaggle-format npy files, on the CPU: the same
flags (the port adds ``--platform``; its ``--hbm_gb`` default is an H100's
80, JAX's a v5e's 16), the same printed plan, and the same training: the
resident table (``hbm``, f32 rows), the cache (``cached``, bf16 rows) and the
plan executed (``auto``: its HBM_FULL tables resident in one mixed bag with
its CACHED ones, f32 rows). ``--num_devices`` and ``--hbm_gb`` are passed to
both (JAX sees the test harness's 8 virtual CPU devices). Tolerances as in
``tests/test_torch_cli.py``: f32 rows AUROC within 1e-4 and losses rtol
1e-5, bf16 rows 2e-2 and 2e-2."""

import json
import re

import numpy as np
import pytest

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import cachedembedding_tpu_torch.train.trainer as port_trainer_mod
from cachedembedding_tpu.baselines import dlrm_main as jax_main
from cachedembedding_tpu_torch.baselines import dlrm_main as port_main
from test_torch_cli import _record_losses, write_dataset

# the second table is above the planner's 4 MB replication threshold, so a
# small --hbm_gb demotes it to CACHED while the others stay resident
TABLES = [50, 200_000, 30]


def argv(d, *extra):
    return ["--dataset_dir", str(d), "--num_embeddings_per_feature", ",".join(map(str, TABLES)),
            "--batch_size", "16", "--embedding_dim", "16", "--limit_train_batches", "6",
            "--limit_val_batches", "4", "--num_devices", "1", "--cache_ratio", "0.5", *extra]


def test_flags_match_jax():
    """Every JAX flag with its default, but --hbm_gb (80 for an H100, 16 for
    a v5e); the port adds --platform."""
    got, want = vars(port_main.parse_args([])), vars(jax_main.parse_args([]))
    assert got.pop("platform") is None
    assert got.pop("hbm_gb") == 80.0 and want.pop("hbm_gb") == 16.0
    assert got == want


def _plan(out: str) -> str:
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("EmbeddingShardingPlan"))
    j = next(k for k, ln in enumerate(lines) if ln.startswith("HBM/device"))
    return "\n".join(lines[i : j + 1])


@pytest.mark.parametrize("kernel,hbm_gb,rows", [
    ("plan_only", "16", None), ("hbm", "16", "f32"), ("cached", "16", "bf16"), ("auto", "0.005", "f32"),
])
def test_baseline_matches_jax(tmp_path, capsys, monkeypatch, kernel, hbm_gb, rows):
    d = write_dataset(tmp_path / "criteo_kaggle")
    extra = ["--kernel", "auto" if kernel == "plan_only" else kernel, "--hbm_gb", hbm_gb]
    extra += ["--plan_only"] if kernel == "plan_only" else ["--use_freq"]
    jl, pl = [], []
    _record_losses(monkeypatch, jax_trainer_mod.CachedDLRMTrainer, jl)
    _record_losses(monkeypatch, port_trainer_mod.CachedDLRMTrainer, pl)
    jax_main.main(argv(d, *extra))
    want = capsys.readouterr()
    port_main.main(argv(d, *extra, "--platform", "cpu"))
    got = capsys.readouterr()
    assert _plan(got.out) == _plan(want.out)
    if kernel == "plan_only":
        assert "val:" not in got.out and not pl
        return
    tol, rtol = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}[rows]
    auroc = [float(re.search(r"val: auroc=([0-9.]+)", o).group(1)) for o in (got.out, want.out)]
    assert abs(auroc[0] - auroc[1]) <= tol
    assert len(pl) == len(jl) == 6 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    stats = json.loads(re.search(r"run stats: (\{.*\})", got.err).group(1))
    if kernel == "auto":
        # the mixed bag holds the plan's HBM_FULL tables whole: here all but the second
        assert stats["resident_tables"] == stats["plan_hbm_full_tables"] == [0, 2]
        assert "hbm_full" in got.out and "cached" in _plan(got.out)
        mixed = [ln for ln in got.err.splitlines() if ln.startswith("mixed-kernel:")]
        assert mixed == [ln for ln in want.err.splitlines() if ln.startswith("mixed-kernel:")]


def test_default_devices_are_the_visible_cards(monkeypatch):
    """Without --num_devices the plan spans the visible CUDA devices on the
    card, and one device on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert port_main.default_num_devices(torch.device("cuda", 0)) == 4
    assert port_main.default_num_devices(torch.device("cpu")) == 1
