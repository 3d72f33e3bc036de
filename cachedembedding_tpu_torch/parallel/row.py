"""Row-wise sharded embedding lookup over a mesh (counterpart of
``cachedembedding_tpu/parallel/row.py``).

The torchrec baseline's ROW_WISE sharding: each rank owns a contiguous row
range of the fused table; every rank sees the global id stream, gathers only
the ids in its range (Kernel 1, ``ops/gather_rows``; the others give zero
rows), and an ``all_reduce(SUM)`` over the mesh's device group makes the
full rows on every rank. The backward is the transpose: the reduce's
cotangent is the identity on each rank, and the grads accumulate into the
rank's own rows only, so the optimizer step needs no collective.

Shards are equal (``per = ceil(N / w)`` rows), as ``shard_map`` needs them in
JAX; the table pads up to ``w * per`` rows, and no valid id addresses the
padding rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.parallel.mesh import Mesh


def row_shard_bounds(num_embeddings: int, world: int) -> np.ndarray:
    """(world + 1,) shard boundaries of equal shards of ``ceil(N / world)``
    rows."""
    per = -(-num_embeddings // world)
    return np.arange(world + 1, dtype=np.int64) * per


class _RowwiseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight_local: torch.Tensor, ids: torch.Tensor, bounds: np.ndarray, mesh: Mesh):
        lo, hi = int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])
        mine = (ids >= lo) & (ids < hi)
        local_ids = torch.where(mine, ids - lo, torch.zeros_like(ids)).to(torch.int32).contiguous()
        rows = gather_rows(weight_local, local_ids, 1)[:, 0]  # Kernel 1
        rows = torch.where(mine[:, None], rows, torch.zeros_like(rows)).float()
        dist.all_reduce(rows, group=mesh.group)
        ctx.mine, ctx.local_ids, ctx.shape, ctx.dtype = mine, local_ids, weight_local.shape, weight_local.dtype
        return rows

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # the reduce's cotangent is the identity on each rank; only its own rows take grads
        g_w = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        g_w.index_add_(0, ctx.local_ids[ctx.mine].long(), g[ctx.mine].float())
        return g_w.to(ctx.dtype), None, None, None


def rowwise_lookup_local(weight_local: torch.Tensor, ids_global: torch.Tensor, bounds: np.ndarray,
                         mesh: Mesh) -> torch.Tensor:
    """This rank's body: the masked gather of its rows (Kernel 1), zero rows
    for the ids it does not own, f32, summed over the ranks: (L, D) full
    rows on every rank, differentiable with respect to ``weight_local``."""
    return _RowwiseLookup.apply(weight_local, ids_global, bounds, mesh)


def make_rowwise_embedding_fn(mesh: Mesh, num_embeddings: int):
    """(lookup, shard_weight) for a row-wise sharded resident table.

    ``lookup(weight_local, ids)`` -> (L, D) f32 rows of the global (L,) ids,
    differentiable with respect to this rank's (per, D) shard (grads land on
    the owning shard only). ``shard_weight(weight_full)`` pads the (N, D)
    table to ``w * per`` rows and returns this rank's block on
    ``mesh.device``."""
    bounds = row_shard_bounds(num_embeddings, mesh.size)

    def lookup(weight_local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return rowwise_lookup_local(weight_local, ids, bounds, mesh)

    def shard_weight(weight_full) -> torch.Tensor:
        w = np.asarray(weight_full)
        lo = int(bounds[mesh.rank])
        hi = min(int(bounds[mesh.rank + 1]), w.shape[0])
        block = np.zeros((int(bounds[1]), w.shape[1]), w.dtype)  # the padding rows stay zero
        block[: max(hi - lo, 0)] = w[lo:hi]
        return torch.from_numpy(block).to(mesh.device)

    return lookup, shard_weight
