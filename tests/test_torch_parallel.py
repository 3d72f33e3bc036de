"""The port's parallel pieces that need no ranks, against the JAX package
where it has them: the column split arithmetic (``get_partition``), the
canonical rows generated from a column start (on the device and on the
host, bit-equal to slicing the full row), the column-wise bag's refusal of an
uneven split, ``make_mesh``'s refusals, and the out-of-range ids' messages
of both planners."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.cache.manager import CachedEmbeddingBag as JaxBag
from cachedembedding_tpu.ops.synth_rows import synth_rows as jax_synth_rows
from cachedembedding_tpu.utils.misc import get_partition as jax_get_partition
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.host_table import VirtualHostTable
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.ops.synth_rows import synth_rows
from cachedembedding_tpu_torch.parallel import mesh as port_mesh
from cachedembedding_tpu_torch.parallel.column import ParallelCachedEmbeddingBag
from cachedembedding_tpu_torch.utils.misc import get_partition


@pytest.mark.parametrize("dim", [1, 7, 16, 128, 130])
def test_get_partition_matches_jax(dim):
    for world in (1, 2, 3, 4, 8):
        if dim < world:
            continue
        got = [get_partition(dim, r, world) for r in range(world)]
        assert got == [jax_get_partition(dim, r, world) for r in range(world)]
        assert got[0][0] == 0 and got[-1][1] == dim
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("col_start,dim", [(0, 16), (8, 8), (4, 4), (96, 32), (1, 5)])
def test_synth_rows_col_start_matches_jax_and_the_full_row(col_start, dim):
    """Columns [col_start, col_start + dim) of the canonical rows: the JAX
    function's with its ``col_start``, and the full row sliced, bit for bit
    (on the device and from the host's generator)."""
    rng = np.random.default_rng(col_start + dim)
    rows = rng.integers(0, 2**31 - 1, 257).astype(np.int32)
    bounds = (rng.random(257) * 0.5 + 1e-3).astype(np.float32)
    seed = 1234
    got = synth_rows(torch.from_numpy(rows), torch.from_numpy(bounds), seed, dim, col_start).numpy()
    want = np.asarray(jax_synth_rows(jnp.asarray(rows), jnp.asarray(bounds), jnp.uint32(seed), dim,
                                     jnp.int32(col_start)))
    full = synth_rows(torch.from_numpy(rows), torch.from_numpy(bounds), seed, col_start + dim).numpy()
    np.testing.assert_array_equal(got, full[:, col_start:])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the host generator: a slab of rows 100.. and a virtual table's unwritten rows
    slab = np.empty((64, dim), np.float32)
    hostops.fill_rows_canonical(slab, 100, seed, 0.25, col_start)
    whole = np.empty((64, col_start + dim), np.float32)
    hostops.fill_rows_canonical(whole, 100, seed, 0.25)
    np.testing.assert_array_equal(slab, whole[:, col_start:])
    vt = VirtualHostTable([500, 700], dim, seed=seed, col_start=col_start)
    vfull = VirtualHostTable([500, 700], col_start + dim, seed=seed)
    idx = np.arange(0, 1200, 7)
    np.testing.assert_array_equal(vt.gather(idx), vfull.gather(idx)[:, col_start:])


def test_column_bag_refuses_an_uneven_split():
    mesh = port_mesh.Mesh(group=None, host_group=None, rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="embedding_dim 16 must divide evenly over 3 devices"):
        ParallelCachedEmbeddingBag(100, 16, mesh=mesh, device="cpu")


def test_make_mesh_refusals(monkeypatch):
    """A mesh of several ranks needs their processes (a launcher, or an
    init_method and a rank each); on the card, more ranks than visible
    cards raise where JAX's make_mesh would take fewer devices."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs its processes"):
        port_mesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs n_devices and rank"):
        port_mesh.make_mesh(None, device="cpu", init_method="file:///nonexistent")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(port_mesh.dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="a mesh of 2 ranks needs 2 CUDA devices; 1 visible"):
        port_mesh.make_mesh(2, device="cuda")


@pytest.mark.parametrize("planner", ["host", "device"])
@pytest.mark.parametrize("bad", [-3, 1000], ids=["negative", "past_the_end"])
def test_out_of_range_message_matches_jax(planner, bad):
    """Both planners refuse an id outside [0, N) before planning, each in
    the JAX package's words: the host planner "embedding ids out of range
    [0, N): min=.. max=..", the device planner "id out of range: {id} not in
    [0, N) -- check table-size/hash configuration"."""
    ids = np.array([3, bad, 17, 500], np.int64)
    kw = dict(table_sizes=[400, 600], cache_ratio=0.5, warmup_ratio=0.0, buffer_size=0, planner=planner)
    messages = []
    for bag in (JaxBag(1000, 8, resident_tables=[0] if planner == "host" else None, **kw),
                CachedEmbeddingBag(1000, 8, device="cpu", resident_tables=[0] if planner == "host" else None,
                                   **kw)):
        with pytest.raises(ValueError) as err:
            bag.prepare_ids(ids)
        messages.append(str(err.value))
    assert messages[1] == messages[0]
    want = (f"embedding ids out of range [0, 1000): min={min(3, bad)} max={max(500, bad)}" if planner == "host"
            else f"id out of range: {bad} not in [0, 1000) — check table-size/hash configuration")
    assert messages[1] == want
