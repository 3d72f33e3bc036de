"""Row-sharded cached embedding over a mesh (counterpart of
``cachedembedding_tpu/parallel/row_cached.py``): the multi-host shape.

The host-memory master table is sharded row-wise: rank h owns the global
rows [h * per, (h + 1) * per) (``per = ceil(N / w)``, ``parallel/row.py``)
and holds only that shard, as its own ``cache/manager.CachedEmbeddingBag``
with its own host table, directory, frequency slice and device cache of
``capacity`` f32 rows. A row has exactly one owner, so no cache coherence
is needed between ranks.

The JAX package's single controller builds every shard and plans each one's
sub-stream; under several controllers each builds only the shards of its own
devices and the slot assignments are exchanged. Here one process is one rank
(``parallel/mesh.py``), so a rank always builds only its own shard, as the
table-wise layout does (``parallel/tablewise.py``):

  * ``prepare_ids_per_rank`` takes every rank's (W, L) global ids (every
    rank gets the same), plans the sub-stream its shard owns in the row-major
    order of that array (``owner = id // per``), writes ``enc = owner *
    capacity + slot`` there and -1 elsewhere, and an ``all_reduce(MAX)``
    over the mesh's host group fills in the other owners' slots, so every
    rank holds the JAX package's ``enc`` bit for bit;
  * ``aggregate_stats`` gathers every shard's counts over the host group, so
    every rank gets the single controller's totals (JAX's processes print
    their own shards' numbers);
  * ``global_cache`` / ``sync_shards`` are this rank's ``cache_weight[:capacity]``,
    which the steps update in place: there is nothing to assemble;
  * ``dense_weight`` flushes, and every rank returns the same (N, D) f32
    master: each owner broadcasts its shard over the host group, one shard
    at a time.

Every shard gets ``seed + 1`` and a single table of ``per`` rows, so without
``initial_weight`` every shard's host table holds the same rows by local
index, as in JAX; shards at other world sizes therefore train other weights.

The steps (JAX's ``build_rowwise_cached_step`` and
``build_rowwise_cached_window``, one ``shard_map`` each there) run step by
step on this rank, with this rank's (L_local,) slots ``enc`` in the layout
(F, B_local, pooling):

  1. ``_bucket_with_positions`` buckets ``enc`` by owner into (w, V), V =
     ``per_pair_budget`` or L_local, empty lanes 0, and gives each id its
     flat bucket position;
  2. an all-to-all of the buckets (``mesh_window._all_to_all``);
  3. the owner gathers ``clamp(received - rank * capacity, 0, capacity - 1)``
     from its cache with Kernel 1 (empty lanes read slot 0);
  4. an all-to-all of the rows back (an ``autograd.Function`` whose backward
     is the same exchange of the grads);
  5. the rows at each id's position, zero past w * V (ids an owner received
     beyond V), f32;
  6. the pooling and the model (``models/``) on (B_local, F, D), the loss
     times ``B_local / B``;
  7. the backward; the dense grads summed over the ranks
     (``mesh_window.all_reduce_grads``) and the dense SGD ``p - dlr * g``;
  8. Kernel 2 (``ops/binned_scatter.binned_sgd_update``) updates the f32
     cache rows by the grads of the gathered lanes, f32 sums and one
     rounding, from a plan of the w * V local slots made where they lie
     (``sort_plan``). The empty lanes name slot 0 with zero grads, and add
     +0 to it, as JAX's scatter does.

The losses are summed over the ranks, so each is the global batch's mean.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag, CacheStats
from cachedembedding_tpu_torch.cache.state import EvictionStrategy
from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan
from cachedembedding_tpu_torch.ops.embedding_bag import pool_uniform
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.parallel.mesh import Mesh
from cachedembedding_tpu_torch.parallel.multiproc import global_max, replicate_fn
from cachedembedding_tpu_torch.parallel.row import row_shard_bounds
from cachedembedding_tpu_torch.train.mesh_window import _all_to_all, all_reduce_grads


class RowShardedCachedEmbeddingBag:
    """This rank's shard of a row-sharded cached table over ``mesh``: a
    ``CachedEmbeddingBag`` of ``per`` rows (``shard``; ``shards`` holds it at
    this rank's index and None elsewhere) with ``capacity`` cache rows,
    ``cuda_row_num`` or ``max(1, int(cache_ratio * per))``."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        *,
        mesh: Mesh,
        cache_ratio: float = 0.01,
        cuda_row_num: Optional[int] = None,
        ids_freq_mapping: Optional[np.ndarray] = None,
        warmup_ratio: float = 0.7,
        buffer_size: int = 0,
        evict_strategy: EvictionStrategy = EvictionStrategy.LFU,
        seed: int = 1024,
        dtype=torch.float32,
        initial_weight: Optional[np.ndarray] = None,
        weight_init: str = "uniform",
        transfer_dtype: str = "float32",
    ):
        self.mesh = mesh
        self.world = W = mesh.size
        self.rank = h = mesh.rank
        self.num_embeddings = N = int(num_embeddings)
        self.embedding_dim = D = int(embedding_dim)
        self.per = per = int(row_shard_bounds(N, W)[1])
        self.capacity = int(cuda_row_num) if cuda_row_num else max(1, int(cache_ratio * per))
        lo, n = h * per, max(min((h + 1) * per, N) - h * per, 0)
        iw = freq = None
        if initial_weight is not None:
            iw = np.zeros((per, D), np.float32)
            iw[:n] = initial_weight[lo: lo + n]
        if ids_freq_mapping is not None:
            freq = np.zeros((per,), np.int64)
            freq[:n] = np.asarray(ids_freq_mapping)[lo: lo + n]
        self.shard = CachedEmbeddingBag(
            per, D, cuda_row_num=self.capacity, ids_freq_mapping=freq, warmup_ratio=warmup_ratio,
            buffer_size=buffer_size, evict_strategy=evict_strategy,
            seed=seed + 1,  # every shard alike: the same rows by local index without initial_weight
            dtype=dtype, initial_weight=iw, weight_init=weight_init if iw is None else "uniform",
            planner="host", transfer_dtype=transfer_dtype, device=mesh.device,
        )
        self.shards: List[Optional[CachedEmbeddingBag]] = [None] * W
        self.shards[h] = self.shard
        self.table_init_s = self.shard.table_init_s

    # -- control plane -----------------------------------------------------
    def prepare_ids_per_rank(self, ids_by_rank: np.ndarray) -> np.ndarray:
        """``ids_by_rank``: (W, L) global ids, rank r's stream in row r (the
        same array on every rank). Plans this rank's shard's sub-stream and
        returns every rank's (W, L) int32 slots ``owner * capacity + slot``."""
        ids = np.asarray(ids_by_rank)
        W, L = ids.shape
        if W != self.world:
            raise ValueError(f"ids for {W} ranks on a mesh of {self.world}")
        if ids.size:
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= self.num_embeddings:
                raise ValueError(f"id out of range: {lo if lo < 0 else hi} not in [0, {self.num_embeddings})")
        out = np.full((W, L), -1, np.int32)
        mask = ids // self.per == self.rank
        if mask.any():
            local = np.ascontiguousarray(ids[mask] - self.rank * self.per, dtype=np.int32)
            ws = self.shard.begin_window_staging(local, local.shape)
            self.shard.enqueue_writebacks(ws)
            self.shard.apply_admits(ws)
            out[mask] = ws.slot_ids + self.rank * self.capacity
        if W > 1:
            # the slot exchange: each rank planned the sub-stream it owns
            out = global_max(out, self.mesh)
            if (out < 0).any():
                raise RuntimeError("slot exchange left unassigned ids — a shard owner failed to plan its "
                                   "sub-stream")
        return out

    def aggregate_stats(self) -> CacheStats:
        """Every shard's counts in rank order (the histories one after
        another, as the JAX package's single controller joins them), on
        every rank."""
        s = self.shard.stats
        mine = (s.prepare_calls, s.swap_in_bytes, s.swap_out_bytes, list(s.num_hits_history),
                list(s.num_miss_history), list(s.num_write_back_history))
        parts = [mine]
        if self.world > 1:
            parts = [None] * self.world
            dist.all_gather_object(parts, mine, group=self.mesh.host_group)
        agg = CacheStats()
        for calls, swap_in, swap_out, hits, miss, wb in parts:
            agg.prepare_calls += calls
            agg.swap_in_bytes += swap_in
            agg.swap_out_bytes += swap_out
            agg.num_hits_history += hits
            agg.num_miss_history += miss
            agg.num_write_back_history += wb
        return agg

    # -- the device rows ----------------------------------------------------
    def global_cache(self) -> torch.Tensor:
        """This rank's (capacity, D) cache rows (a view the steps update in
        place)."""
        return self.shard.cache_weight[: self.capacity]

    def sync_shards(self, cache: torch.Tensor) -> None:
        """Write ``cache`` into this rank's cache rows, unless it is them."""
        own = self.global_cache()
        if cache.data_ptr() != own.data_ptr():
            own.copy_(cache.to(own.dtype))

    def flush(self) -> None:
        self.shard.flush()

    def close(self) -> None:
        self.shard.close()

    def dense_weight(self) -> np.ndarray:
        """The full (num_embeddings, D) f32 master after a flush, the same on
        every rank (each owner broadcasts its shard over the host group, one
        shard at a time, so a rank holds at most one other shard at once)."""
        self.flush()
        own = np.asarray(self.shard.host_table.gather(np.arange(self.per, dtype=np.int64)), np.float32)
        if self.world == 1:
            return own[: self.num_embeddings]
        blocks = []
        for h in range(self.world):
            blk = torch.from_numpy(own.copy()) if h == self.rank else torch.empty(own.shape, dtype=torch.float32)
            dist.broadcast(blk, src=h, group=self.mesh.host_group)
            blocks.append(blk.numpy())
        return np.concatenate(blocks, axis=0)[: self.num_embeddings]


def _bucket_with_positions(enc: torch.Tensor, owners: torch.Tensor, w: int, V: int):
    """JAX's ``_bucket_with_positions``: (buckets (w, V) of ``enc`` by owner,
    in stream order, empty lanes 0; the counts, at most V; each element's
    flat position ``owner * V + rank within its owner``). Elements past an
    owner's V are dropped from the buckets; their positions are >= w * V."""
    oh = (owners[:, None] == torch.arange(w, dtype=owners.dtype, device=owners.device)[None, :]).to(torch.int32)
    rank_within = (torch.cumsum(oh, dim=0, dtype=torch.int32) - oh).gather(1, owners[:, None].long())[:, 0]
    counts = oh.sum(dim=0, dtype=torch.int32)
    pos = owners * V + rank_within
    target = torch.where(rank_within < V, pos, torch.full_like(pos, w * V))
    out = torch.zeros((w * V + 1,), dtype=enc.dtype, device=enc.device)
    out[target.long()] = enc  # the spare last slot takes the dropped elements
    return out[: w * V].reshape(w, V), torch.clamp(counts, max=V), pos


class _Exchange(torch.autograd.Function):
    """The rows' all-to-all (block j to rank j); its backward sends the grads
    back by the same exchange."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return _all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_to_all(g, ctx.mesh), None


def _rows_of(cw, enc, mesh: Mesh, capacity: int, V: int, with_grad: bool):
    """Steps 1-5: (the owner's gathered lanes (w * V, D), a leaf that takes
    their grad where ``with_grad``; their local slots; this rank's (L, D)
    f32 rows in ``enc``'s order)."""
    w = mesh.size
    buckets, _, pos = _bucket_with_positions(enc, torch.div(enc, capacity, rounding_mode="floor"), w, V)
    received = _all_to_all(buckets, mesh)
    local_slots = (received - mesh.rank * capacity).clamp_(0, capacity - 1).reshape(-1)
    owned = gather_rows(cw, local_slots, 1).reshape(w * V, cw.shape[1])  # Kernel 1
    if with_grad:
        owned.requires_grad_(True)
    back = _Exchange.apply(owned, mesh)
    valid = pos < w * V
    rows = back.index_select(0, torch.where(valid, pos, torch.zeros_like(pos)).long())
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows)).float()
    return owned, local_slots, rows


def _embedded(rows, F: int, B_local: int, mode: str):
    """(F, B_local, pooling) rows -> (B_local, F, D) pooled."""
    D = rows.shape[1]
    return pool_uniform(rows.view(F, -1, D).transpose(0, 1), B_local, mode)


def _check_dtype(net, compute_dtype) -> None:
    if getattr(net, "compute_dtype", compute_dtype) != compute_dtype:
        raise ValueError(f"the model computes in {net.compute_dtype}, the step in {compute_dtype}")


def _train_one(net, cw, enc, dense, labels, slr, dlr, *, mesh, capacity, V, F, B, mode, model) -> torch.Tensor:
    """One training step on this rank, in place on ``net`` and ``cw``.
    Returns this rank's loss term (its batch rows' mean times B_local / B)."""
    from cachedembedding_tpu_torch.train.trainer import _model_loss

    b_local = labels.shape[0]
    owned, local_slots, rows = _rows_of(cw, enc, mesh, capacity, V, with_grad=True)
    loss = _model_loss(model, net(dense, _embedded(rows, F, b_local, mode)), labels) * (b_local / B)
    loss.backward()
    params = list(net.parameters())
    all_reduce_grads(params, mesh)
    binned_sgd_update(cw, owned.grad, *sort_plan(local_slots, cw.shape[0]), float(slr))  # Kernel 2
    with torch.no_grad():
        for prm in params:
            prm.sub_(prm.grad * float(dlr))
            prm.grad = None
    return loss.detach()


def _sizes(mesh: Mesh, num_features: int, global_batch: int, pooling: int, per_pair_budget: Optional[int]):
    if global_batch % mesh.size:
        raise ValueError(f"batch {global_batch} does not split evenly over {mesh.size} ranks")
    L_local = num_features * (global_batch // mesh.size) * pooling
    return per_pair_budget or L_local  # the worst case: one owner gets every id


def build_rowwise_cached_step(mesh: Mesh, *, num_features: int, global_batch: int, pooling: int, capacity: int,
                              mode: str = "sum", compute_dtype=torch.float32, model: str = "dlrm",
                              per_pair_budget: Optional[int] = None, train: bool = True):
    """One row-sharded cached step on this rank.

    train: ``step(net, cache_weight, enc (L_local,), dense (B_local, Din),
    labels (B_local,), sparse_lr, dense_lr) -> loss`` (the global batch's,
    summed over the ranks), updating ``net`` (a ``models/`` DLRM or DeepFM,
    ``model`` naming which, computing in ``compute_dtype``) and this rank's
    (capacity, D) f32 ``cache_weight`` in place.
    eval: ``step(net, cache_weight, enc, dense) -> (w, B_local)``
    probabilities of the global batch, on every rank."""
    V = _sizes(mesh, num_features, global_batch, pooling, per_pair_budget)
    kw = dict(mesh=mesh, capacity=capacity, V=V, F=num_features, B=global_batch, mode=mode, model=model)
    if train:
        def step(net, cache_weight, enc, dense, labels, sparse_lr, dense_lr) -> torch.Tensor:
            _check_dtype(net, compute_dtype)
            loss = _train_one(net, cache_weight, enc, dense, labels, sparse_lr, dense_lr, **kw)
            dist.all_reduce(loss, group=mesh.group)
            return loss

        return step
    from cachedembedding_tpu_torch.train.trainer import _model_probs

    gather = replicate_fn(mesh, axis=0)

    @torch.no_grad()
    def score(net, cache_weight, enc, dense) -> torch.Tensor:
        _check_dtype(net, compute_dtype)
        _, _, rows = _rows_of(cache_weight, enc, mesh, capacity, V, with_grad=False)
        probs = _model_probs(model, net(dense, _embedded(rows, num_features, dense.shape[0], mode)))
        return gather(probs.reshape(1, -1))

    return score


def build_rowwise_cached_window(mesh: Mesh, *, num_features: int, global_batch: int, pooling: int, capacity: int,
                                mode: str = "sum", compute_dtype=torch.float32, model: str = "dlrm",
                                per_pair_budget: Optional[int] = None):
    """A prefetch window of row-sharded cached training, step after step
    (each step sees the last one's rows): ``step(net, cache_weight, enc (P,
    L_local), dense (P, B_local, Din), labels (P, B_local), sparse_lrs (P,),
    dense_lrs (P,)) -> (P,)`` global losses (one ``all_reduce`` a window).
    The same math a step as ``build_rowwise_cached_step``."""
    V = _sizes(mesh, num_features, global_batch, pooling, per_pair_budget)
    kw = dict(mesh=mesh, capacity=capacity, V=V, F=num_features, B=global_batch, mode=mode, model=model)

    def step(net, cache_weight, enc, dense, labels, sparse_lrs, dense_lrs) -> torch.Tensor:
        _check_dtype(net, compute_dtype)
        losses = torch.stack([_train_one(net, cache_weight, enc[p], dense[p], labels[p], sparse_lrs[p],
                                         dense_lrs[p], **kw) for p in range(enc.shape[0])])
        dist.all_reduce(losses, group=mesh.group)
        return losses

    return step
