"""Window training and scoring over a column-wise mesh (counterpart of
``cachedembedding_tpu/train/mesh_window.py``), in the port's per-step idiom.

The JAX package runs a mesh window as one ``shard_map``-ped ``lax.scan``.
Here every rank is a process that runs the window's steps as the one-card
trainer does (``train/trainer.py``), on its column shard of the cache,
``cache_weight`` (C, D/w), and on its batch rows of the dense features and
labels:

  * the window's buffer carries the global batch's slot ids, this rank's
    dense features and labels, this rank's columns of the admits (fetched
    from its host table, or synthesized for its columns, ``col_start``) and
    the update plans, which every rank computes alike from the same ids; the
    admits land first (``_apply_admits_sharded``, the JAX function's
    counterpart, is the trainer's own ``_land_admits``);
  * each step gathers the global batch's rows of the shard (Kernel 1),
    pools them (f32 sums or means for pooling above 1) to (B, F, D/w) and
    reshards that to (B/w, F, D) with an all-to-all
    (``parallel/collectives.reshard_pooled``, whose backward is the reverse
    all-to-all);
  * the rank's loss is its batch rows' mean times ``b_local / B``, so the
    sum over ranks is the global mean; the dense grads are summed over the
    ranks (``parallel/collectives.all_reduce_grads``, the DDP all-reduce)
    and so are the losses, so the dense SGD (``ops/dense_sgd.py``) needs no
    scaling of its LR by the world size;
  * the embedding update runs on the shard by the JAX mesh's branch rule:
    the sparse branch (Kernel 5's ordered scatter; Kernel 2 on f32 rows),
    or the dense one, where SGD is Kernel 2 (f32 sums, one rounding), and
    row-wise Adagrad and stochastic rounding build the f32 grad with Kernel
    3. Adagrad's row mean square sums ``g32 ** 2`` over the shard's columns,
    all-reduces the sums and divides by the full width, as JAX does (Kernel
    2's Adagrad epilogue sees only the shard's columns, so it serves no
    world size here, not even 1). Stochastic rounding is Kernel 4's fused
    entry, its Philox counter the element ``row * (D/w) + d`` of the shard,
    as JAX's ``stochastic_astype`` counts inside ``shard_map``: a run on two
    ranks rounds otherwise than one on one card, as in JAX.

At a world of 1 the collectives are identities and the loss factor is 1.0,
so the SGD branches give the one-card trainer's losses and rows bit for bit.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.models.deepfm import model_loss, model_probs
from cachedembedding_tpu_torch.ops.binned_scatter import binned_scatter_add
from cachedembedding_tpu_torch.ops.dense_sgd import dense_sgd_
from cachedembedding_tpu_torch.ops.embedding_bag import pool_uniform
from cachedembedding_tpu_torch.ops.rounding import astype_storage, stochastic_sgd_round_
from cachedembedding_tpu_torch.parallel.collectives import all_reduce_grads, reshard_pooled
from cachedembedding_tpu_torch.parallel.multiproc import replicate_fn


def _update(tr, cw: torch.Tensor, g_rows: torch.Tensor, plan, slr: float, seed: int, branch: str) -> None:
    """The shard's embedding update of one step, in place (JAX's mesh
    window): SGD without rounding as the one-card trainer's branch (Kernel
    2, or Kernel 5 on the sparse branch); else Kernel 3's f32 grad, row-wise
    Adagrad's mean square over the full row (summed over the ranks), and
    Kernel 4's fused entry under stochastic rounding, else ``cw - slr * g``
    rounded once."""
    perm, grouped, bins = plan
    acc = tr.embed.cache_accum
    if acc is None and not tr._sr:
        tr._update(cw, g_rows, perm, grouped, bins, slr, branch)
        return
    g32 = binned_scatter_add(g_rows, perm, grouped, bins, cw.shape[0])
    if acc is not None:
        sq = (g32 * g32).sum(dim=1)
        dist.all_reduce(sq, group=tr.mesh.group)
        acc.add_(sq / tr.cfg.embedding_dim)
        g32.div_((torch.sqrt(acc) + tr.cfg.adagrad_eps)[:, None])
    if tr._sr:
        stochastic_sgd_round_(cw, g32, slr, seed)
    elif cw.dtype == torch.float32:
        cw.sub_(g32, alpha=slr)
    else:
        cw.copy_(astype_storage(cw.float().sub_(g32, alpha=slr), cw.dtype))


def train_window(tr, win, progresses: List[float]) -> torch.Tensor:
    """Land the window's admits and enqueue every step of it on this rank.
    Returns the (P,) global per-step losses (summed over the ranks; a
    device tensor, not yet read back)."""
    from cachedembedding_tpu_torch.train.trainer import _M32, _SEED_MUL

    mesh, cfg = tr.mesh, tr.cfg
    tr._land_admits(win)
    cw = tr.embed.cache_weight
    F = cfg.num_sparse_features
    b_local = win.labels.shape[1]
    B = b_local * mesh.size
    pooling = win.slot_ids.shape[1] // (B * F)
    branch = tr.branch_of(win)
    upcast = tr._upcasts(branch, cw, pooling)
    params = list(tr.model.parameters())
    losses = []
    for p, progress in enumerate(progresses):
        slr, dlr = tr._lrs(progress)
        rows = tr._gathered_rows(win, p)
        if upcast:
            rows = rows.float()
        rows.requires_grad_(True)
        emb = reshard_pooled(pool_uniform(rows, B, cfg.reduction_mode), mesh, cfg.fused_op)
        # the local mean over the global batch: summed over the ranks, the global mean
        loss = model_loss(cfg.model, tr.model(win.dense[p], emb), win.labels[p]) * (b_local / B)
        loss.backward()
        all_reduce_grads(params, mesh)
        seed = (tr._step_idx * _SEED_MUL + p) & _M32
        _update(tr, cw, rows.grad.reshape(-1, cw.shape[1]), tr._step_plan(win, p), slr, seed, branch)
        dense_sgd_(params, dlr)
        losses.append(loss.detach())
    out = torch.stack(losses)
    dist.all_reduce(out, group=mesh.group)
    return out


@torch.no_grad()
def eval_window(tr, win) -> List[torch.Tensor]:
    """Score a window's steps (its admits landed): each step's (B,)
    probabilities of the global batch, in its order (each rank scores its
    batch rows, then the ranks' scores are gathered in rank order)."""
    mesh, cfg = tr.mesh, tr.cfg
    B = win.labels.shape[1] * mesh.size
    gather = replicate_fn(mesh, axis=0)
    out = []
    for p in range(win.slot_ids.shape[0]):
        emb = reshard_pooled(pool_uniform(tr._gathered_rows(win, p), B, cfg.reduction_mode), mesh, cfg.fused_op)
        out.append(gather(model_probs(cfg.model, tr.model(win.dense[p], emb)).reshape(-1)))
    return out
