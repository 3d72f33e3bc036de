"""The per-batch hybrid-parallel train step (counterpart of
``cachedembedding_tpu/parallel/hybrid.py``): a column-sharded embedding times
data-parallel dense towers.

Every rank holds columns [r * D/w, (r + 1) * D/w) of every cache row, a raw
f32 (C, D/w) shard, and consumes the global batch's slot ids. A step, in
this rank's process:
  * Kernel 1 gathers the global batch's rows of the shard and pools them,
    (B, F, D/w);
  * the fused reshard to (B/w, F, D), ``fused_op`` "all_to_all" or
    "gather_scatter" (``train/mesh_window.reshard_pooled``, whose backward
    sends each rank's columns of the grad back);
  * the DLRM dense forward on this rank's batch rows, the loss times
    ``B_local / B`` (summed over the ranks, the global mean), the backward,
    the dense grads summed over the ranks and the dense SGD;
  * Kernel 2 updates the shard, ``cw - slr * g`` with each row's grads summed
    in f32, from an update plan of the slot ids made where they lie. The
    sparse grad needs no collective: each rank saw the global batch for its
    columns.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.models.dlrm import DLRM, bce_with_logits
from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan
from cachedembedding_tpu_torch.ops.embedding_bag import pool_uniform
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.parallel.mesh import Mesh, make_mesh
from cachedembedding_tpu_torch.train.mesh_window import FUSED_OPS, all_reduce_grads, reshard_pooled


def hybrid_train_step(mesh: Mesh, *, num_features: int, global_batch: int, pooling: int = 1,
                      mode: str = "sum", fused_op: str = "all_to_all"):
    """The hybrid-parallel train step: ``step(model, cache_weight,
    dense_local, slot_values, labels_local, sparse_lr, dense_lr) -> loss``,
    with this rank's (C, D/w) f32 shard, its (B/w, Din) dense features and
    (B/w,) labels, and the global batch's (F * B * pooling,) feature-major
    slot ids. Updates ``model`` (a ``models/dlrm.DLRM``) and the shard in
    place; the loss is the global batch's (summed over the ranks)."""
    if fused_op not in FUSED_OPS:
        raise ValueError(f"unknown fused_op {fused_op!r}")
    F, B = num_features, global_batch

    def step(model, cache_weight, dense_local, slot_values, labels_local, sparse_lr, dense_lr) -> torch.Tensor:
        rows = gather_rows(cache_weight, slot_values, F)  # Kernel 1: (B * pooling, F, D/w)
        rows.requires_grad_(True)
        emb = reshard_pooled(pool_uniform(rows, B, mode), mesh, fused_op)
        loss = bce_with_logits(model(dense_local, emb), labels_local) * (labels_local.shape[0] / B)
        loss.backward()
        params = list(model.parameters())
        all_reduce_grads(params, mesh)
        plan = sort_plan(slot_values.view(F, -1).t().reshape(-1), cache_weight.shape[0])
        binned_sgd_update(cache_weight, rows.grad.reshape(-1, cache_weight.shape[1]), *plan, float(sparse_lr))
        with torch.no_grad():
            for prm in params:
                prm.sub_(prm.grad * float(dense_lr))
                prm.grad = None
        loss = loss.detach()
        dist.all_reduce(loss, group=mesh.group)
        return loss

    return step


def dryrun_hybrid_train_step(n_devices: int, device=None) -> float:
    """Run one hybrid-parallel step on tiny shapes over a mesh of
    ``n_devices`` ranks (this process is one of them; ``device`` as for
    ``make_mesh``). Returns its loss, which must be finite."""
    mesh = make_mesh(n_devices, device)
    F, D, Din, C = 4, 32 * max(1, n_devices), 8, 64
    B = 8 * n_devices
    b = B // mesh.size
    model = DLRM(D, F, Din, (16, D), (16, 8, 1), seed=0, device=mesh.device)
    step = hybrid_train_step(mesh, num_features=F, global_batch=B, pooling=1)
    cache_weight = torch.ones((C, D // mesh.size), dtype=torch.float32, device=mesh.device)
    dense = torch.ones((b, Din), dtype=torch.float32, device=mesh.device)
    labels = torch.ones((b,), dtype=torch.float32, device=mesh.device)
    slot_values = torch.zeros((F * B,), dtype=torch.int32, device=mesh.device)
    loss = float(step(model, cache_weight, dense, slot_values, labels, 0.1, 0.1))
    if not math.isfinite(loss):
        raise AssertionError(f"dry-run hybrid step: loss {loss}")
    return loss

