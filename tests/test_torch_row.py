"""The port's row-wise lookup (``parallel/row.py``) on spawned gloo ranks
against the JAX package's on a mesh of the same size: JAX's
``tests/test_planner.py::test_rowwise_lookup_matches_dense`` and
``test_rowwise_grads_land_on_owner_shards`` at 2 and 4 ranks. The rows are
bit-equal (each is one owner's row plus zeros) and so are the grads (sums
of ones)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from cachedembedding_tpu.parallel.mesh import make_mesh
from cachedembedding_tpu.parallel.row import make_rowwise_embedding_fn, row_shard_bounds
from cachedembedding_tpu_torch.parallel.row import row_shard_bounds as port_bounds


def _cases():
    rng = np.random.default_rng(0)
    lookup = dict(N=1000, w=rng.normal(size=(1000, 16)).astype(np.float32),
                  ids=rng.integers(0, 1000, 333).astype(np.int32))
    rng = np.random.default_rng(1)
    grads = dict(N=64, w=rng.normal(size=(64, 4)).astype(np.float32), ids=rng.integers(0, 64, 40).astype(np.int32))
    return {"lookup": lookup, "grads": grads}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Both cases on 2 and on 4 spawned ranks, one spawn each."""
    return {w: torch_dist.spawn("rowwise_lookup_cases", w, tmp_path_factory.mktemp(f"row{w}"), _cases())
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_rowwise_lookup_matches_dense(cpu_devices, port_runs, world):
    c = _cases()["lookup"]
    lookup, shard_weight = make_rowwise_embedding_fn(make_mesh(world), c["N"])
    want = np.asarray(jax.jit(lookup)(shard_weight(c["w"]), jnp.asarray(c["ids"])))
    np.testing.assert_allclose(want, c["w"][c["ids"]], rtol=1e-6)
    for res in port_runs[world]:  # every rank holds the full rows
        np.testing.assert_array_equal(res["lookup"]["rows"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_rowwise_grads_land_on_owner_shards(cpu_devices, port_runs, world):
    c = _cases()["grads"]
    lookup, shard_weight = make_rowwise_embedding_fn(make_mesh(world), c["N"])
    ids = jnp.asarray(c["ids"])
    want = np.asarray(jax.jit(jax.grad(lambda ws: lookup(ws, ids).sum()))(shard_weight(c["w"])))
    got = np.concatenate([res["grads"]["grad"] for res in port_runs[world]])  # the shards in rank order
    bounds = row_shard_bounds(c["N"], world)
    np.testing.assert_array_equal(port_bounds(c["N"], world), bounds)
    assert got.shape == want.shape == (bounds[-1], 4)
    np.testing.assert_array_equal(got, want)
    expect = np.zeros((c["N"], 4), np.float32)
    np.add.at(expect, c["ids"], 1.0)
    np.testing.assert_array_equal(got[: c["N"]], expect)
