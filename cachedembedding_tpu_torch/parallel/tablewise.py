"""Table-wise model parallelism (counterpart of
``cachedembedding_tpu/parallel/tablewise.py``): each rank owns whole
embedding tables, with their host table, directory and device cache.

Placement, as the JAX package keeps the reference's:
  * ``TablewiseEmbeddingBagConfig``: ``num_embeddings``, ``cuda_row_num``
    (the table's cache rows, ``min(int(cache_ratio * n) + 2000, n)``),
    ``assigned_rank`` and ``ids_freq_mapping``;
  * ``get_tablewise_rank_arrange``: the reference's hand-tuned table -> rank
    maps by world size; ``auto_rank_arrange``: greedy balance on access
    frequency (or rows);
  * ``prepare_tablewise_config``: the configs, the hand-tuned map where
    there is one, else the automatic one.

``ParallelCachedEmbeddingBagTablewise`` is this rank's part of the layout.
The JAX package stacks every rank's cache as a (w, C_max, D) array and, on
one controller, plans every rank it holds. Here one process is one rank
(``parallel/mesh.py``), and it holds only its own tables' host table, native
directory and (C_max, D) f32 ``cache_weight``, as the JAX package's
processes do under several controllers (its ``local_ranks``). Rank r's tables
form one local id space of ``local_sizes[r]`` rows, followed by the pad row
``pad_row = N_max - 1``, the same on every rank: ``route_ids`` fills a
rank's unused feature slots (``F_max`` of them a rank) with it. A rank whose
tables hold fewer rows than the largest rank's has a host table of only
``local_sizes[r] + 1`` rows, so its pad lanes name a row past its table, as
in JAX: the host gather reads row 0 for it and the host scatter skips it
(``_native/hostops.cpp``), and the flush leaves the pad row out. The pad
lanes' rows are dropped by the reshard (``feature_select_perm``), so they
reach no loss, and their grads are zero.

Planning, staging and writebacks are rank-local and call no device
collective: each window's admits are read from the host table and land in
the cache after the evicted occupants' values have been read for their
writeback (``_stage``, JAX's ``_stage_inner``), and those writebacks land
in the host table at the next window or flush. The cache statistics sum
every rank's hits, misses and swap bytes over the mesh's host group (one
``all_reduce`` a window and one a flush), so ``print_comm_stats`` prints
JAX's totals.

The steps (JAX's ``tablewise_train_step``, ``tablewise_window_step`` and
``tablewise_eval_step``) run per step on this rank, as
``train/mesh_window.py`` does for the column-wise mesh: Kernel 1 gathers the
global batch's rows of this rank's features, (B, F_max, D); ``reshard``
(an ``autograd.Function``) trades batch rows for features with one
``all_to_all_single``, (B/w, F, D); the DLRM dense forward, the loss times
``B_local / B``, the backward, the dense grads summed over the ranks
(``parallel/collectives.all_reduce_grads``), the dense SGD
(``ops/dense_sgd.py``), and Kernel 2's update of the f32 cache rows (f32
sums, one rounding) from an update plan of the step's slot ids made where
they lie (``ops/binned_scatter.sort_plan``). The losses are summed over the
ranks, so each is the global batch's mean.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cachedembedding_tpu_torch.cache.host_directory import make_directory
from cachedembedding_tpu_torch.cache.host_table import DenseHostTable, VirtualHostTable
from cachedembedding_tpu_torch.cache.manager import CacheStats, default_table_init, host_to_device
from cachedembedding_tpu_torch.cache.state import EvictionStrategy
from cachedembedding_tpu_torch.models.dlrm import bce_with_logits
from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan
from cachedembedding_tpu_torch.ops.dense_sgd import dense_sgd_
from cachedembedding_tpu_torch.ops.embedding_bag import pool_uniform
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.parallel.collectives import all_reduce_grads, all_to_all_rows
from cachedembedding_tpu_torch.parallel.mesh import Mesh
from cachedembedding_tpu_torch.parallel.multiproc import replicate_fn


@dataclasses.dataclass
class TablewiseEmbeddingBagConfig:
    """One table's placement (the reference's TablewiseEmbeddingBagConfig)."""

    num_embeddings: int
    cuda_row_num: int
    assigned_rank: int
    ids_freq_mapping: Optional[np.ndarray] = None


def get_tablewise_rank_arrange(dataset: str, world_size: int) -> List[int]:
    """The reference's hand-tuned placements of the 26 Criteo tables."""
    if dataset and "criteo" in dataset and "kaggle" in dataset:
        table = {
            1: [0] * 26,
            2: [0, 1, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 1, 0, 1, 0],
            3: [2, 1, 0, 1, 1, 2, 2, 1, 0, 0, 1, 1, 0, 1, 0, 2, 0, 2, 2, 0, 2, 2, 0, 1, 1, 0],
            4: [3, 1, 0, 3, 1, 0, 2, 1, 0, 2, 3, 1, 3, 1, 2, 3, 1, 2, 3, 0, 2, 0, 0, 2, 3, 2],
            8: [6, 6, 0, 4, 7, 2, 5, 7, 0, 5, 7, 1, 7, 3, 5, 3, 1, 6, 6, 0, 2, 2, 1, 4, 3, 4],
        }
    elif dataset and "criteo" in dataset:
        table = {
            1: [0] * 26,
            2: [1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0],
            4: [1, 3, 3, 3, 3, 0, 2, 2, 1, 2, 2, 2, 0, 1, 2, 1, 0, 1, 0, 0, 2, 3, 3, 3, 1, 0],
        }
    else:
        raise NotImplementedError(f"no hand-tuned arrangement for {dataset!r}")
    if world_size not in table:
        raise NotImplementedError(
            f"no hand-tuned arrangement for world_size={world_size}; use auto_rank_arrange"
        )
    return table[world_size]


def auto_rank_arrange(table_sizes: Sequence[int], world_size: int,
                      id_freq_map: Optional[np.ndarray] = None) -> List[int]:
    """Greedy longest-processing-time placement balancing each rank's cost
    (its tables' access frequency where known, else their rows)."""
    sizes = np.asarray(table_sizes, np.int64)
    if id_freq_map is not None:
        offs = np.concatenate([[0], np.cumsum(sizes)])
        cost = np.array([id_freq_map[offs[i]: offs[i + 1]].sum() for i in range(len(sizes))], np.float64)
    else:
        cost = sizes.astype(np.float64)
    order = np.argsort(-cost)
    load = np.zeros(world_size)
    out = [0] * len(sizes)
    for t in order:
        r = int(np.argmin(load))
        out[t] = r
        load[r] += cost[t]
    return out


def prepare_tablewise_config(
    num_embeddings_per_feature: Sequence[int],
    cache_ratio: float,
    id_freq_map_total: Optional[np.ndarray] = None,
    dataset: Optional[str] = "criteo_kaggle",
    world_size: int = 2,
    rank_arrange: Optional[Sequence[int]] = None,
) -> List[TablewiseEmbeddingBagConfig]:
    """Each table's config: its cache rows ``min(int(cache_ratio * n) +
    2000, n)``, its rank from ``rank_arrange``, else the hand-tuned map of
    ``dataset`` (its first F entries), else ``auto_rank_arrange``, and its
    slice of the frequency map."""
    if rank_arrange is None:
        try:
            rank_arrange = get_tablewise_rank_arrange(dataset or "", world_size)
        except NotImplementedError:
            rank_arrange = auto_rank_arrange(num_embeddings_per_feature, world_size, id_freq_map_total)
    offs = np.concatenate([[0], np.cumsum(np.asarray(num_embeddings_per_feature, np.int64))])
    configs = []
    for i, n in enumerate(num_embeddings_per_feature):
        freq = None
        if id_freq_map_total is not None:
            freq = np.asarray(id_freq_map_total[offs[i]: offs[i + 1]])
        configs.append(TablewiseEmbeddingBagConfig(
            num_embeddings=int(n), cuda_row_num=min(int(cache_ratio * n) + 2000, n),
            assigned_rank=int(rank_arrange[i]), ids_freq_mapping=freq,
        ))
    return configs


class ParallelCachedEmbeddingBagTablewise:
    """This rank's tables of a table-wise layout over ``mesh``: its host
    table, directory and (C_max, D) f32 ``cache_weight``. ``host_tables``
    and ``dirs`` are indexed by rank, None for the other ranks.
    ``begin_prepare`` / ``begin_prepare_window`` take the global batch's
    (B, F) per-feature ids (every rank gets the same) and return this rank's
    slot ids on its device, and the plans (this rank's; None for the
    others), which ``finish_prepare`` stages."""

    def __init__(
        self,
        configs: List[TablewiseEmbeddingBagConfig],
        embedding_dim: int,
        mesh: Mesh,
        *,
        mode: str = "sum",
        warmup_ratio: float = 0.7,
        buffer_size: int = 0,
        evict_strategy: EvictionStrategy = EvictionStrategy.LFU,
        weight_init: str = "uniform",
        seed: int = 1024,
    ):
        self.configs = configs
        self.embedding_dim = D = int(embedding_dim)
        self.mesh = mesh
        self.device = mesh.device
        self.mode = mode
        self.buffer_size = buffer_size
        self.evict_strategy = evict_strategy
        self.world = w = mesh.size
        F = len(configs)

        # the table partition, each feature's (rank, local position)
        self.tables_of_rank: List[List[int]] = [[] for _ in range(w)]
        for t, c in enumerate(configs):
            if not 0 <= c.assigned_rank < w:
                raise ValueError(f"table {t}: rank {c.assigned_rank} out of a mesh of {w}")
            self.tables_of_rank[c.assigned_rank].append(t)
        self.F_max = max(len(ts) for ts in self.tables_of_rank)
        self.feat_pos = np.zeros((F, 2), np.int64)
        for r, ts in enumerate(self.tables_of_rank):
            for j, t in enumerate(ts):
                self.feat_pos[t] = (r, j)
        # each rank's local id space, then the pad row at N_max - 1
        self.local_sizes = np.array(
            [sum(configs[t].num_embeddings for t in ts) for ts in self.tables_of_rank], np.int64)
        self.N_max = int(self.local_sizes.max()) + 1
        self.pad_row = self.N_max - 1
        self.capacities = np.array(
            [max(1, sum(configs[t].cuda_row_num for t in ts)) + 1 for ts in self.tables_of_rank], np.int64)
        self.C_max = int(self.capacities.max())
        self.table_local_offset = np.zeros((F,), np.int64)
        for ts in self.tables_of_rank:
            off = 0
            for t in ts:
                self.table_local_offset[t] = off
                off += configs[t].num_embeddings

        r = mesh.rank
        t0 = time.perf_counter()
        sizes = [configs[t].num_embeddings for t in self.tables_of_rank[r]] or [1]
        sizes = sizes + [1]  # this rank's own pad row, at local_sizes[r]
        if weight_init == "virtual":
            table = VirtualHostTable(sizes, D, seed=seed + r)
        elif weight_init == "uniform":
            arr = np.empty((sum(sizes), D), np.float32)
            default_table_init(sizes, seed + r)(arr)
            table = DenseHostTable(arr)
        elif weight_init == "zeros":
            table = DenseHostTable(np.zeros((sum(sizes), D), np.float32))
        else:
            raise ValueError(weight_init)
        self.table_init_s = time.perf_counter() - t0
        self.host_tables: List = [None] * w
        self.host_tables[r] = table
        self.dirs: List = [None] * w
        self.dirs[r] = make_directory(self.N_max, self.C_max, evict_strategy)
        if evict_strategy == EvictionStrategy.DATASET:
            self.dirs[r].set_dataset_freq(np.minimum(self._local_freq(), 2**31 - 1))
        self.cache_weight = torch.zeros((self.C_max, D), dtype=torch.float32, device=self.device)

        self.stats = CacheStats()
        self._pending_wb: list = []  # (evicted rows, their values in host memory, CUDA event or None)
        self._swap_unreduced = [0, 0]  # this rank's swap-in and swap-out bytes not yet summed over the ranks
        if warmup_ratio > 0 and any(c.ids_freq_mapping is not None for c in configs):
            self._warmup(warmup_ratio)

    # ------------------------------------------------------------------
    @property
    def _rank(self) -> int:
        return self.mesh.rank

    def _local_freq(self) -> np.ndarray:
        """(N_max,) dataset frequencies of this rank's local id space."""
        freq = np.zeros((self.N_max,), np.int64)
        off = 0
        for t in self.tables_of_rank[self._rank]:
            f, n = self.configs[t].ids_freq_mapping, self.configs[t].num_embeddings
            if f is not None:
                freq[off: off + n] = f
            off += n
        return freq

    def _to_device(self, arr) -> torch.Tensor:
        return host_to_device(arr, self.device)

    def route_ids(self, ids_bf: np.ndarray) -> np.ndarray:
        """The global batch's (B, F) per-feature ids (0..num_embeddings_t) ->
        every rank's local ids, feature-major, (w, B * F_max), the unused
        feature slots filled with the pad row."""
        B, F = ids_bf.shape
        out = np.full((self.world, B * self.F_max), self.pad_row, np.int64)
        for t in range(F):
            r, j = self.feat_pos[t]
            out[r, j * B: (j + 1) * B] = ids_bf[:, t] + self.table_local_offset[t]
        return out

    def begin_prepare(self, ids_bf: np.ndarray):
        """Plan this rank's part of one batch on the host. Returns (this
        rank's (B * F_max,) int32 slot ids on its device, the plans)."""
        routed = self.route_ids(np.asarray(ids_bf))
        r = self._rank
        plans: List = [None] * self.world
        plans[r] = self.dirs[r].plan(np.ascontiguousarray(routed[r], np.int32))
        return self._to_device(plans[r].slot_ids), plans

    def begin_prepare_window(self, ids_bf_list):
        """Plan a whole prefetch window (a list of P (B, F) id matrices): one
        directory plan over its P batches. Returns (this rank's (P, B *
        F_max) int32 slot ids on its device, the plans)."""
        routed = np.stack([self.route_ids(np.asarray(b))[self._rank] for b in ids_bf_list])
        r = self._rank
        plans: List = [None] * self.world
        plans[r] = self.dirs[r].plan(np.ascontiguousarray(routed.reshape(-1), np.int32))
        return self._to_device(plans[r].slot_ids.reshape(len(ids_bf_list), -1)), plans

    def finish_prepare(self, plans) -> None:
        """Land the previous windows' writebacks, stage this rank's plan,
        and count every rank's hits and misses."""
        self._drain_writebacks()
        p = plans[self._rank]
        hits = 0 if p is None else p.n_hit_unique
        misses = 0 if p is None else int(p.admit_rows.shape[0])
        if p is not None:
            self._stage(p)
        hits, misses = self._reduce_stats(hits, misses)
        self.stats.prepare_calls += 1
        self.stats.num_hits_history.append(hits)
        self.stats.num_miss_history.append(misses)

    def _reduce_stats(self, *counts: int):
        """Sum ``counts`` and the swap bytes not yet summed over the ranks
        (one ``all_reduce`` over the host group); returns the summed
        counts."""
        t = torch.tensor([*counts, *self._swap_unreduced], dtype=torch.int64)
        dist.all_reduce(t, group=self.mesh.host_group)
        self._swap_unreduced = [0, 0]
        *summed, swap_in, swap_out = (int(x) for x in t)
        self.stats.swap_in_bytes += swap_in
        self.stats.swap_out_bytes += swap_out
        return summed

    def _stage(self, plan) -> None:
        """Read the admit slots' occupants for their writeback (a device
        gather copied to host memory behind an event), then land the admits
        from the host table."""
        n = int(plan.admit_rows.shape[0])
        if n == 0:
            return
        t0 = time.perf_counter()
        table = self.host_tables[self._rank]
        vals = table.gather(np.ascontiguousarray(plan.admit_rows, np.int64))
        wb = plan.evict_rows >= 0
        if wb.any():
            occupied = self._to_device(plan.admit_slots[wb].astype(np.int64))
            on_cuda = self.device.type == "cuda"
            host = torch.empty((int(wb.sum()), self.embedding_dim), dtype=torch.float32, pin_memory=on_cuda)
            host.copy_(self.cache_weight.index_select(0, occupied), non_blocking=on_cuda)
            event = None
            if on_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            self._pending_wb.append((plan.evict_rows[wb], host, event))
        self.cache_weight.index_copy_(0, self._to_device(plan.admit_slots.astype(np.int64)), self._to_device(vals))
        self._swap_unreduced[0] += n * self.embedding_dim * 4
        self.stats.swap_in_time += time.perf_counter() - t0

    def _drain_writebacks(self) -> None:
        """Write the evicted rows read so far to the host table."""
        t0 = time.perf_counter()
        for rows, host, event in self._pending_wb:
            if event is not None:
                event.synchronize()
            self.host_tables[self._rank].scatter(rows, host.numpy())
            self._swap_unreduced[1] += rows.shape[0] * self.embedding_dim * 4
        if self._pending_wb:
            self.stats.swap_out_time += time.perf_counter() - t0
        self._pending_wb.clear()

    def _warmup(self, warmup_ratio: float) -> None:
        """Preload this rank's hottest ``warmup_ratio * (capacity - 1)`` rows
        by dataset frequency into slots 0..k-1."""
        r = self._rank
        freq = self._local_freq()
        k = min(int(warmup_ratio * (self.capacities[r] - 1)), int(self.local_sizes[r]))
        if k <= 0:
            return
        top = np.argpartition(freq[: self.local_sizes[r]], -k)[-k:].astype(np.int64)
        self.dirs[r].warmup(top, np.minimum(freq[top], 2**31 - 1))
        self.cache_weight[:k] = self._to_device(self.host_tables[r].gather(top))

    def flush(self) -> None:
        """Write every cached row but the pad row back to the host table
        (every rank calls it: it sums the swap bytes over the ranks)."""
        self._drain_writebacks()
        r = self._rank
        slots, rows = self.dirs[r].resident()
        real = rows != self.pad_row
        slots, rows = slots[real], rows[real]
        if slots.size:
            vals = self.cache_weight.index_select(0, self._to_device(slots.astype(np.int64)))
            self.host_tables[r].scatter(rows, vals.cpu().numpy())
        self._reduce_stats()

    def print_comm_stats(self) -> None:
        print(self.stats.summary())

    print_comm_stats_ = print_comm_stats

    def feature_select_perm(self) -> np.ndarray:
        """(F,) positions in the rank-major (w * F_max) feature concat of the
        real features, in their original order."""
        F = len(self.configs)
        perm = np.zeros((F,), np.int64)
        for t in range(F):
            r, j = self.feat_pos[t]
            perm[t] = r * self.F_max + j
        return perm


# ---------------------------------------------------------------------------
# the steps


class _Reshard(torch.autograd.Function):
    """(B, F_max, D) rows of this rank's features for the global batch ->
    (B/w, F, D) rows of every feature for this rank's batch rows, and back
    for the grad. JAX's ``all_to_all(split_axis=1, concat_axis=0)`` on (F_max,
    B, D) joins the received chunks along the features; ``all_to_all_single``
    splits and joins along dim 0 only, so the batch is split (chunk j to
    rank j), the received (w, B/w, F_max, D) block is permuted to (B/w,
    w * F_max, D), and ``perm`` picks the F real features in their order.
    The backward scatters the grad back to (B/w, w * F_max, D), zeros at the
    pad features, and sends it by the reverse all-to-all."""

    @staticmethod
    def forward(ctx, pooled: torch.Tensor, mesh: Mesh, perm: torch.Tensor) -> torch.Tensor:
        w = mesh.size
        B, f_max, D = pooled.shape
        b = B // w
        ctx.mesh, ctx.perm, ctx.f_max = mesh, perm, f_max
        got = all_to_all_rows(pooled, mesh).view(w, b, f_max, D)
        return got.permute(1, 0, 2, 3).reshape(b, w * f_max, D).index_select(1, perm)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh, perm, f_max = ctx.mesh, ctx.perm, ctx.f_max
        w = mesh.size
        b, _, D = g.shape
        full = g.new_zeros((b, w * f_max, D))
        full.index_copy_(1, perm, g)
        send = full.view(b, w, f_max, D).permute(1, 0, 2, 3)
        return all_to_all_rows(send, mesh).view(w * b, f_max, D), None, None


def reshard(pooled: torch.Tensor, mesh: Mesh, perm: torch.Tensor) -> torch.Tensor:
    """(B_global, F_max, D) -> (B_local, F, D): the table-wise all-to-all,
    ``perm`` the (F,) int64 ``feature_select_perm`` on the rows' device."""
    return _Reshard.apply(pooled, mesh, perm)


def _embedded(cw, ids, mesh, perm, f_max, B, mode, with_grad: bool):
    """Kernel 1's (B, F_max, D) rows of the step (a leaf that takes their
    grad where ``with_grad``) and their (B/w, F, D) reshard."""
    rows = gather_rows(cw, ids, f_max)
    if with_grad:
        rows.requires_grad_(True)
    return rows, reshard(pool_uniform(rows, B, mode), mesh, perm)


def _train_one(model, cw, ids, dense, labels, slr, dlr, *, mesh, perm, f_max, B, mode) -> torch.Tensor:
    """One training step on this rank, in place on ``model`` and ``cw``.
    Returns this rank's loss term (its batch rows' mean times B_local / B)."""
    rows, emb = _embedded(cw, ids, mesh, perm, f_max, B, mode, with_grad=True)
    loss = bce_with_logits(model(dense, emb), labels) * (labels.shape[0] / B)
    loss.backward()
    params = list(model.parameters())
    all_reduce_grads(params, mesh)
    # the update plan of the step's ids in the order of the gathered rows, (B, F_max)
    plan = sort_plan(ids.view(f_max, -1).t().reshape(-1), cw.shape[0])
    binned_sgd_update(cw, rows.grad.reshape(-1, cw.shape[1]), *plan, float(slr))  # Kernel 2
    dense_sgd_(params, float(dlr))
    return loss.detach()


def tablewise_train_step(mesh: Mesh, *, feature_perm: np.ndarray, f_max: int, global_batch: int,
                         mode: str = "sum"):
    """The table-wise train step: ``step(model, cache_weight, dense_local,
    slot_ids, labels_local, sparse_lr, dense_lr) -> loss``, with this rank's
    (C_max, D) f32 cache rows, its (B/w, Din) dense features and (B/w,)
    labels, and its (F_max * B,) slot ids of the global batch
    (``begin_prepare``). Updates ``model`` (a ``models/dlrm.DLRM``, whose
    compute dtype is JAX's ``compute_dtype``) and the cache rows in place;
    the loss is the global batch's (summed over the ranks)."""
    perm = torch.as_tensor(np.asarray(feature_perm), dtype=torch.long, device=mesh.device)

    def step(model, cache_weight, dense_local, slot_ids, labels_local, sparse_lr, dense_lr) -> torch.Tensor:
        loss = _train_one(model, cache_weight, slot_ids, dense_local, labels_local, sparse_lr, dense_lr,
                          mesh=mesh, perm=perm, f_max=f_max, B=global_batch, mode=mode)
        dist.all_reduce(loss, group=mesh.group)
        return loss

    return step


def tablewise_window_step(mesh: Mesh, *, feature_perm: np.ndarray, f_max: int, global_batch: int,
                          mode: str = "sum"):
    """A prefetch window of table-wise training, step after step:
    ``step(model, cache_weight, slot_ids (P, F_max * B), dense (P, B/w,
    Din), labels (P, B/w), sparse_lrs (P,), dense_lrs (P,)) -> (P,)`` global
    losses (one ``all_reduce`` a window). The same math a step as
    ``tablewise_train_step``."""
    perm = torch.as_tensor(np.asarray(feature_perm), dtype=torch.long, device=mesh.device)

    def step(model, cache_weight, slot_ids, dense, labels, sparse_lrs, dense_lrs) -> torch.Tensor:
        losses = torch.stack([
            _train_one(model, cache_weight, slot_ids[p], dense[p], labels[p], sparse_lrs[p], dense_lrs[p],
                       mesh=mesh, perm=perm, f_max=f_max, B=global_batch, mode=mode)
            for p in range(slot_ids.shape[0])
        ])
        dist.all_reduce(losses, group=mesh.group)
        return losses

    return step


def tablewise_eval_step(mesh: Mesh, *, feature_perm: np.ndarray, f_max: int, global_batch: int,
                        mode: str = "sum"):
    """Forward-only table-wise scoring of a window: ``step(model,
    cache_weight, slot_ids (P, F_max * B), dense (P, B/w, Din)) -> (P, B)``
    Sigmoid probabilities of the global batch, on every rank (each rank's
    rows gathered in rank order)."""
    perm = torch.as_tensor(np.asarray(feature_perm), dtype=torch.long, device=mesh.device)
    gather = replicate_fn(mesh, axis=1)

    @torch.no_grad()
    def step(model, cache_weight, slot_ids, dense) -> torch.Tensor:
        probs = []
        for p in range(slot_ids.shape[0]):
            _, emb = _embedded(cache_weight, slot_ids[p], mesh, perm, f_max, global_batch, mode, with_grad=False)
            probs.append(torch.sigmoid(model(dense[p], emb)))
        return gather(torch.stack(probs))

    return step
