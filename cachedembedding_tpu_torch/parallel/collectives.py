"""The collectives the multi-device layouts share: the column-wise mesh
window (``train/mesh_window.py``), the table-wise (``parallel/tablewise.py``),
row-sharded (``parallel/row_cached.py``) and hybrid (``parallel/hybrid.py``)
steps, and the id exchanges (``parallel/all_to_all.py``).

  * ``all_to_all_rows``: row block j of a tensor to rank j, one
    ``all_to_all_single`` (the only one of the port);
  * ``reshard_pooled``: the column-wise layout's fused reshard of the pooled
    rows, (B, F, D/w) column shards to (B/w, F, D) batch rows, by
    ``fused_op`` (one of ``FUSED_OPS``), with the reverse exchange as its
    backward;
  * ``all_reduce_grads``: the dense grads summed over the ranks (the DDP
    all-reduce), as one flat buffer, before the dense SGD
    (``ops/dense_sgd.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from cachedembedding_tpu_torch.parallel.mesh import Mesh
from cachedembedding_tpu_torch.parallel.multiproc import replicate_fn

FUSED_OPS = ("all_to_all", "gather_scatter")


def all_to_all_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Row block j of ``t`` (its dim 0 split in ``mesh.size`` blocks) to rank
    j; returns the blocks received, in rank order along dim 0."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.group_for(t))
    return out


class _Reshard(torch.autograd.Function):
    """(B, F, D/w) column shards -> (B/w, F, D) batch rows, and back for the
    grad. ``all_to_all_single`` splits and concatenates along dim 0, where
    JAX's ``all_to_all(split_axis=0, concat_axis=2)`` concatenates the
    received chunks along the columns: the received (w, B/w, F, D/w) block
    is permuted to (B/w, F, w, D/w) and its last two axes flattened."""

    @staticmethod
    def forward(ctx, pooled: torch.Tensor, mesh: Mesh, fused_op: str) -> torch.Tensor:
        ctx.mesh = mesh
        w = mesh.size
        B, F, dpr = pooled.shape
        b = B // w
        if fused_op == "gather_scatter":
            # every rank's columns of the whole batch, then this rank's rows
            return replicate_fn(mesh, axis=2)(pooled)[mesh.rank * b : (mesh.rank + 1) * b].contiguous()
        got = all_to_all_rows(pooled, mesh).view(w, b, F, dpr)
        return got.permute(1, 2, 0, 3).reshape(b, F, w * dpr)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # both fused ops: the grad of this rank's batch rows, column block j
        # to rank j, which places it at this rank's rows (the gather's other
        # entries have zero grads)
        mesh = ctx.mesh
        w = mesh.size
        b, F, D = g.shape
        send = g.reshape(b, F, w, D // w).permute(2, 0, 1, 3)
        return all_to_all_rows(send, mesh).view(w * b, F, D // w), None, None


def reshard_pooled(pooled: torch.Tensor, mesh: Mesh, fused_op: str = "all_to_all") -> torch.Tensor:
    """(B_global, F, D/w) -> (B_local, F, D): the fused collective
    (``fused_op`` "all_to_all", or "gather_scatter": an all-gather of the
    columns and this rank's batch rows, which computes the same)."""
    if fused_op not in FUSED_OPS:
        raise ValueError(f"unknown fused_op {fused_op!r}")
    return _Reshard.apply(pooled, mesh, fused_op)


def all_reduce_grads(params: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum the dense grads over the ranks in place (the DDP all-reduce), as
    one flat buffer."""
    grads = [p.grad for p in params]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group)
    for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(v)
