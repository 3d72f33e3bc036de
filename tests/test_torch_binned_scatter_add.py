"""Kernel 3's plain version (the port's ``binned_scatter_add``) against the
JAX package's ``binned_scatter_add(..., interpret=True)``, on the cases of
``tests/test_binned_scatter.py``. Each package builds its own plan: 512-row
bins in JAX, 64-row bins in the port; the result does not depend on the bin
height. Sums are f32 in both, in different orders: rtol 1e-5, atol 1e-4, with
untouched rows exactly 0. On CPU tensors the wrapper runs the plain version,
which is what these tests exercise. The last tests feed the port's plan
(sorted by row) to the JAX kernels themselves, and hold the scratch size the
wrappers allocate to the chunk the CUDA kernels compile in."""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cachedembedding_tpu.ops.binned_scatter import binned_scatter_add as jax_binned_scatter_add
from cachedembedding_tpu.ops.binned_scatter import binned_sgd_update as jax_binned_sgd_update
from cachedembedding_tpu.ops.binned_scatter import sort_plan_np as jax_sort_plan
from cachedembedding_tpu_torch.ops import _cuda
from cachedembedding_tpu_torch.ops.binned_scatter import (
    BLOCK_ROWS,
    ROW_CHUNK,
    binned_scatter_add,
    sort_plan_np,
)


def _both(v, g, num_rows):
    """(JAX's result, the port's) as f32 numpy for ids v and grads g."""
    jp, jg, jb = jax_sort_plan(v, num_rows)
    ref = np.asarray(jax_binned_scatter_add(
        jnp.asarray(g), jnp.asarray(jp), jnp.asarray(jg), jnp.asarray(jb), num_rows, interpret=True,
    ))
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(v, num_rows))
    gt = torch.from_numpy(np.asarray(g, np.float32))
    if g.dtype != np.float32:
        gt = gt.to(torch.bfloat16)
    out = binned_scatter_add(gt, perm, grouped, bins, num_rows)
    assert out.dtype == torch.float32 and out.shape == (num_rows, g.shape[1])
    return ref, out.numpy()


def _check(v, ref, got, num_rows):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    untouched = np.setdiff1d(np.arange(num_rows), np.unique(v))
    assert np.all(got[untouched] == 0) and np.all(ref[untouched] == 0)


@pytest.mark.parametrize("L,num_rows,D", [(1000, 700, 128), (4096, 2048, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_random_ids(L, num_rows, D, dtype):
    rng = np.random.default_rng(0)
    v = rng.integers(0, num_rows, size=(L,)).astype(np.int32)
    g = rng.standard_normal((L, D)).astype(np.float32)
    if dtype == "bfloat16":
        g = g.astype(ml_dtypes.bfloat16)
    ref, got = _both(v, g, num_rows)
    _check(v, ref, got, num_rows)


def test_matches_jax_heavy_duplicates():
    """80% of the ids in [0, 8): one 64-row bin holds most of the stream."""
    rng = np.random.default_rng(1)
    L, num_rows, D = 8192, 512, 128
    v = np.concatenate([rng.integers(0, 8, size=(int(L * 0.8),)),
                        rng.integers(0, num_rows, size=(L - int(L * 0.8),))])
    rng.shuffle(v)
    v = v.astype(np.int32)
    g = rng.standard_normal((L, D)).astype(np.float32)
    ref, got = _both(v, g, num_rows)
    # ~800 addends per head row: atol as in tests/test_binned_scatter.py
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    untouched = np.setdiff1d(np.arange(num_rows), np.unique(v))
    assert np.all(got[untouched] == 0)


def test_matches_jax_empty_bins_and_unaligned_rows():
    """num_rows not a multiple of the bin height; most bins empty."""
    rng = np.random.default_rng(2)
    L, num_rows, D = 777, 1000, 128
    assert num_rows % BLOCK_ROWS and num_rows % 512
    v = rng.choice([3, 4, 700, 999], size=(L,)).astype(np.int32)
    g = rng.standard_normal((L, D)).astype(np.float32)
    ref, got = _both(v, g, num_rows)
    _check(v, ref, got, num_rows)


def test_validates_its_inputs():
    g = torch.zeros((10, 8))
    perm, grouped, bins = (torch.from_numpy(a) for a in sort_plan_np(np.zeros(10, np.int32), 100))
    with pytest.raises(ValueError, match="bin_starts"):
        binned_scatter_add(g, perm, grouped, bins[:-1], 100)
    with pytest.raises(ValueError, match="agree"):
        binned_scatter_add(g, perm[:-1], grouped, bins, 100)


@pytest.mark.parametrize("kernel", ["binned_sgd_update", "binned_scatter_add"])
def test_jax_kernels_take_the_row_sorted_plan(kernel):
    """The port's plan, each bin sorted by row, fed to the JAX kernel at the
    port's bin height gives what that kernel gives on JAX's own plan (512-row
    bins, grouped only): the JAX kernels need bin-contiguity only. f32
    tolerances as above (rtol 1e-5, atol 1e-4); the sums differ in order."""
    rng = np.random.default_rng(3)
    L, num_rows, D, lr = 3000, 1000, 128, 0.37
    v = np.where(rng.random(L) < 0.1, 321, rng.integers(0, num_rows, L)).astype(np.int32)
    g = rng.standard_normal((L, D)).astype(np.float32)
    jp, jg, jb = jax_sort_plan(v, num_rows)
    perm, grouped, bins = sort_plan_np(v, num_rows)
    assert not np.array_equal(perm, jp)  # the two plans differ inside bins
    if kernel == "binned_scatter_add":
        def run(plan, **kw):
            return np.asarray(jax_binned_scatter_add(
                jnp.asarray(g), *map(jnp.asarray, plan), num_rows, interpret=True, **kw))
    else:
        cw = rng.standard_normal((num_rows, D)).astype(np.float32)

        def run(plan, **kw):
            return np.asarray(jax_binned_sgd_update(
                jnp.asarray(cw), jnp.asarray(g), *map(jnp.asarray, plan), jnp.asarray(lr, jnp.float32),
                interpret=True, **kw))
    ref = run((jp, jg, jb))
    got = run((perm, grouped, bins), block_rows=BLOCK_ROWS)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_row_chunk_is_the_cuda_kernels_chunk():
    """The wrappers size the kernels' partials with ROW_CHUNK: it must be the
    kChunk that csrc/row_runs.cuh compiles in, which no CPU run executes."""
    header = next(h for h in _cuda.HEADERS if h.name == "row_runs.cuh")
    m = re.search(r"constexpr int kChunk = (\d+);", header.read_text())
    assert m is not None and int(m.group(1)) == ROW_CHUNK
