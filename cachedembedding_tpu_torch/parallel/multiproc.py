"""Collectives every multi-device layout shares (counterpart of
``cachedembedding_tpu/parallel/multiproc.py``).

The JAX package's single controller builds sharded global arrays from host
data and reads sharded values back under three rules. With one process a
rank they become:

  * ``put_addressable``: each rank puts only its own shard of a host array
    on its device;
  * ``replicate_fn``: a sharded value is made whole on every rank by an
    ``all_gather`` along its sharded axis (the column axis of the cache);
  * ``global_max``: ranks agree on a number by an ``all_reduce(MAX)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.parallel.mesh import Mesh


def shard_bounds(n: int, mesh: Mesh):
    """[start, end) of this rank's equal slice of ``n`` (``n % size == 0``)."""
    if n % mesh.size:
        raise ValueError(f"{n} does not split evenly over {mesh.size} ranks")
    k = n // mesh.size
    return mesh.rank * k, (mesh.rank + 1) * k


def put_addressable(mesh: Mesh, arr, axis: int) -> torch.Tensor:
    """This rank's shard of the host array ``arr`` along ``axis``, copied to
    the mesh's device (the other ranks' shards are never read here)."""
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
    a, b = shard_bounds(t.shape[axis], mesh)
    return t.narrow(axis, a, b - a).contiguous().to(mesh.device)


def replicate_fn(mesh: Mesh, axis: int = 1):
    """A function that makes a tensor sharded along ``axis`` whole on every
    rank: an ``all_gather`` of the ranks' shards (over the mesh's device
    group, or its host group for a tensor in host memory), concatenated in
    rank order."""

    def replicate(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group_for(t))
        return torch.cat(parts, dim=axis)

    return replicate


def global_max(v, mesh: Mesh):
    """Elementwise largest value of ``v`` (an int or a numpy array, on the
    host) across the mesh's ranks: an ``all_reduce(MAX)`` over its host
    group."""
    arr = np.asarray(v)
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    out = t.numpy()
    return int(out) if arr.ndim == 0 else out
