"""The port stands alone: importing all of it (the data layer with every
source, the device planner, the resident baseline, the utilities, DeepFM,
the command lines, the sharding planner, the column-wise mesh, the id
exchanges, the table-wise layout, the hybrid step and model, and the
row-wise and row-sharded cached layouts and the headline bench included)
loads neither jax nor any module of the JAX package; its entry points
refuse to run silently on the CPU; and its kernel wrappers take their plain
versions only for CPU tensors. Its layers point one way: no module of
``parallel/`` imports ``train/``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cachedembedding_tpu_torch
from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
from cachedembedding_tpu_torch.ops.binned_scatter import (
    binned_scatter_add,
    binned_sgd_update,
    sort_plan_np,
)
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.ops.rounding import stochastic_astype, stochastic_sgd_round_

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import cachedembedding_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [k for k in sys.modules
       if k in ("jax", "cachedembedding_tpu") or k.startswith(("jax.", "cachedembedding_tpu."))]
print(len(names), bad)
assert len(names) >= 54, names
assert "cachedembedding_tpu_torch.ops.rounding" in names, names
new = ["data.npy_dataset", "data.feature_counter", "data.criteo", "data.avazu", "baselines.full_resident",
       "utils.misc", "utils.checkpoint", "models.deepfm", "train.dlrm_main", "ops.unique", "data.random_rec",
       "data.transform", "data.prefetch", "data.parquet", "data.dispatch", "utils.timer", "parallel",
       "parallel.planner", "parallel.mesh", "parallel.multiproc", "parallel.column", "train.mesh_window",
       "baselines.dlrm_main", "parallel.all_to_all", "parallel.tablewise", "parallel.hybrid", "models.hybrid",
       "parallel.row", "parallel.row_cached", "bench", "utils.spans"]
missing = [m for m in new if "cachedembedding_tpu_torch." + m not in names]
assert not missing, missing
assert not bad, bad
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_imports_nothing_of_train():
    train = "cachedembedding_tpu_torch.train"
    bad = []
    for path in sorted((REPO / "cachedembedding_tpu_torch" / "parallel").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            if any(n == train or n.startswith(train + ".") for n in names):
                bad.append(f"{path.name}:{node.lineno}")
    assert not bad, bad


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = DLRMConfig(
        num_embeddings_per_feature=[10, 20], embedding_dim=16, dense_in_features=4,
        dense_arch_layer_sizes=(16,), over_arch_layer_sizes=(8, 1), batch_size=8,
        cache=CacheConfig(ship_sort_perm=True),
    )
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedDLRMTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cachedembedding_tpu_torch.resolve_device("cuda")
    assert cachedembedding_tpu_torch.resolve_device("cpu").type == "cpu"


def _counts():
    return (gather_rows.launches, binned_sgd_update.launches, binned_scatter_add.launches,
            stochastic_astype.launches, stochastic_sgd_round_.launches)


def test_wrappers_take_the_plain_path_on_cpu_tensors():
    before = _counts()
    w = torch.randn(64, 16)
    ids = torch.randint(0, 64, (40,), dtype=torch.int32)
    out = gather_rows(w, ids, 2)
    assert out.shape == (20, 2, 16)
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(ids.numpy(), 64))
    binned_sgd_update(w, torch.randn(40, 16), perm, grouped, bins, 0.5)
    g32 = binned_scatter_add(torch.randn(40, 16).bfloat16(), perm, grouped, bins, 64)
    assert g32.shape == (64, 16) and g32.dtype == torch.float32
    assert stochastic_astype(g32, torch.float8_e4m3fn, 9).dtype == torch.float8_e4m3fn
    cw = torch.zeros(64, 16).to(torch.float8_e4m3fn)
    assert stochastic_sgd_round_(cw, g32, 0.5, 9) is cw
    # the counts move only where a CUDA kernel launches
    assert _counts() == before


def test_kernel_sources_and_build_dir_are_where_the_docs_say():
    from cachedembedding_tpu_torch import _build
    from cachedembedding_tpu_torch.ops import _cuda

    assert {lib for lib, _, _ in _cuda._PROTOTYPES.values()} == set(_cuda.SOURCES)
    assert set(_cuda.SOURCES) <= set(_cuda._PROTOTYPES)  # each library's own entry
    for src in _cuda.SOURCES.values():
        assert src.exists() and src.suffix == ".cu"
    for hdr in _cuda.HEADERS:
        assert hdr.exists() and f'#include "{hdr.name}"' in (hdr.parent / "binned_sgd.cu").read_text()
    assert _build.BUILD_DIR == REPO / "cachedembedding_tpu_torch" / "build"
    assert "cachedembedding_tpu_torch/build/" in (REPO / ".gitignore").read_text().split()
