"""Sparse-id batch exchange (counterpart of
``cachedembedding_tpu/parallel/all_to_all.py``): every rank contributes its
local batch of per-feature ids and every rank ends up with what it needs of
the global batch.

The JAX package writes these as functions inside ``shard_map`` over the mesh
axis. Here each is a function on this rank's tensors with the ``Mesh`` in
place of the axis name, and its collective a ``torch.distributed`` call over
the mesh's device group (or its host group for tensors in host memory):

  * ``gather_global_uniform``: uniform-pooling ids, one ``all_gather`` along
    the batch;
  * ``exchange_ragged``: ragged ids padded to a per-rank budget, lengths then
    values, one ``all_gather`` each;
  * ``exchange_to_owners``: each rank sends each peer only the ids that peer
    owns, counts then values, one ``collectives.all_to_all_rows`` each;
  * ``bucket_by_owner``, ``permute_bags``, ``rank_major_to_feature_major_perm``
    and ``compact_ragged_global``: the static-shape local reshuffles around
    them, with no collective.

Where JAX scatters with ``mode="drop"``, an index past the end lands in one
spare slot that is cut off afterwards.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch.parallel.collectives import all_to_all_rows
from cachedembedding_tpu_torch.parallel.mesh import Mesh
from cachedembedding_tpu_torch.parallel.multiproc import replicate_fn


def gather_global_uniform(values_local: torch.Tensor, num_features: int, pooling: int,
                          mesh: Mesh) -> torch.Tensor:
    """Local (F * B_local * P,) feature-major ids -> global (F * B_global *
    P,) feature-major ids: for each feature, rank 0's bags first, then rank
    1's, ... (an ``all_gather`` along the batch axis)."""
    b_local = values_local.shape[0] // (num_features * pooling)
    fbp = values_local.reshape(num_features, b_local, pooling)
    return replicate_fn(mesh, axis=1)(fbp).reshape(-1)


def exchange_ragged(values_local: torch.Tensor, lengths_local: torch.Tensor, max_values_per_rank: int,
                    mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase ragged exchange: ``values_local`` (V,) ids padded to the
    per-rank budget ``max_values_per_rank`` (anything past the true count),
    ``lengths_local`` (num_bags_local,) the true bag lengths. Returns
    (values_global (w*V,), lengths_global (w*num_bags,)), in rank order."""
    if values_local.shape[0] != max_values_per_rank:
        raise ValueError(f"values_local holds {values_local.shape[0]} ids, the budget is {max_values_per_rank}")
    lengths_global = replicate_fn(mesh, axis=0)(lengths_local)
    values_global = replicate_fn(mesh, axis=0)(values_local)
    return values_global, lengths_global


def exchange_to_owners(values_by_dest: torch.Tensor, counts_by_dest: torch.Tensor,
                       mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Owner-routed two-phase exchange: ``values_by_dest`` (w, V), row d this
    rank's ids for rank d padded to the per-pair budget V; ``counts_by_dest``
    (w,) their true counts. Returns (received (w, V), recv_counts (w,)): row
    j the ids rank j sent to this rank, with their true count. Each rank
    moves w*V ids, not the whole batch."""
    w = mesh.size
    if values_by_dest.shape[0] != w or counts_by_dest.shape != (w,):
        raise ValueError(f"values_by_dest (w, V) and counts_by_dest (w,) need w = {w}")
    recv_counts = all_to_all_rows(counts_by_dest, mesh)
    received = all_to_all_rows(values_by_dest, mesh)
    return received, recv_counts


def bucket_by_owner(values: torch.Tensor, owners: torch.Tensor, num_ranks: int,
                    per_pair_budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketing for ``exchange_to_owners``: each id goes to its owner's row
    at its stable rank among the ids of that owner. Ids past the per-pair
    budget are dropped (the caller sizes the budget to the worst case).
    Returns ((num_ranks, per_pair_budget) ids, zeros past each count;
    (num_ranks,) counts, at most the budget)."""
    owners = owners.long()
    oh = (owners[:, None] == torch.arange(num_ranks, device=owners.device)[None, :]).to(torch.int32)
    rank_within = (torch.cumsum(oh, dim=0) - oh)[torch.arange(values.shape[0], device=values.device), owners]
    counts = oh.sum(dim=0)
    spill = num_ranks * per_pair_budget
    target = torch.where(rank_within < per_pair_budget, owners * per_pair_budget + rank_within,
                         torch.full_like(rank_within, spill)).long()
    out = torch.zeros((spill + 1,), dtype=values.dtype, device=values.device)
    out[target] = values
    return out[:spill].reshape(num_ranks, per_pair_budget), torch.clamp(counts, max=per_pair_budget)


def permute_bags(values: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor,
                 out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder ragged bags: output bag j is input bag ``perm[j]``. Returns
    ((out_size,) values, zeros past the last bag; (len(perm)+1,) int32
    offsets)."""
    perm = perm.long()
    in_lengths = offsets[1:] - offsets[:-1]
    out_lengths = in_lengths[perm]
    out_offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=offsets.device),
                             torch.cumsum(out_lengths, dim=0).to(torch.int32)])
    pos = torch.arange(out_size, dtype=torch.int32, device=offsets.device)
    b = torch.searchsorted(out_offsets, pos, right=True).long() - 1
    b = torch.clamp(b, 0, perm.shape[0] - 1)
    src = offsets[perm[b]].long() + (pos - out_offsets[b]).long()
    valid = pos < out_offsets[-1]
    vals = torch.where(valid, values[torch.clamp(src, 0, values.shape[0] - 1)], torch.zeros_like(values[:1]))
    return vals, out_offsets


def rank_major_to_feature_major_perm(num_ranks: int, num_features: int, bags_per_feature: int) -> torch.Tensor:
    """Bag permutation from the order (rank, feature, bag) to (feature, rank,
    bag), the global feature-major layout: (int32)."""
    idx = np.arange(num_ranks * num_features * bags_per_feature).reshape(num_ranks, num_features, bags_per_feature)
    return torch.from_numpy(idx.transpose(1, 0, 2).reshape(-1).astype(np.int32))


def compact_ragged_global(values_global: torch.Tensor, lengths_global: torch.Tensor, num_ranks: int,
                          max_values_per_rank: int, out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the per-rank pad tails of ``exchange_ragged``'s output: each
    rank's first sum-of-lengths values into one contiguous (out_size,)
    stream (zeros past its end), and the global (n_bags+1,) int32 offsets."""
    V = max_values_per_rank
    vals = values_global.reshape(num_ranks, V)
    per_rank = lengths_global.reshape(num_ranks, -1).sum(dim=1)
    rank_starts = torch.cat([torch.zeros((1,), dtype=per_rank.dtype, device=per_rank.device),
                             torch.cumsum(per_rank, dim=0)[:-1]])
    pos = torch.arange(V, device=values_global.device).expand(num_ranks, V)
    valid = pos < per_rank[:, None]
    target = torch.where(valid, rank_starts[:, None] + pos, torch.full_like(pos, out_size)).long()
    target.clamp_(max=out_size)  # values past out_size are dropped
    out = torch.zeros((out_size + 1,), dtype=values_global.dtype, device=values_global.device)
    out[target.reshape(-1)] = vals.reshape(-1)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=lengths_global.device),
                         torch.cumsum(lengths_global, dim=0).to(torch.int32)])
    return out[:out_size], offsets
