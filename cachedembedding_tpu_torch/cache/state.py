"""Cache state on torch tensors (counterpart of
``cachedembedding_tpu/cache/state.py``).

The device planner: ``CacheState``, three int32 tensors that hold the whole
directory on the device, and ``plan_ids``, one cache-maintenance step

    (state, ids) -> (new_state, Plan)

that uniques a window's ids (``ops/unique.py::unique_mask``), splits hits
from misses, picks victims (empty slots, then the lowest LFU or dataset
frequency, by a stable argsort; slots the window hits are protected) and
packs the admit/evict plan for one readback. It is a sequence of torch
ops, with no output shape that depends on the data, so enqueuing it on the
card waits for nothing; the manager (``cache/manager.py``) reads the plan
back and moves the rows. The same function runs on CPU tensors, which is
how it is checked against the card and against JAX.

Besides: the slot gather/scatter of the device cache and the int8/int4
admit payloads' dequantizing scatters.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from cachedembedding_tpu_torch.ops.rounding import index_copy_storage_
from cachedembedding_tpu_torch.ops.unique import unique_mask


class EvictionStrategy(enum.Enum):
    """Mirror of the reference's ``EvictionStrategy`` enum."""

    LFU = "lfu"          # runtime frequency counters
    DATASET = "dataset"  # static dataset id frequency


class CacheState(NamedTuple):
    """The device planner's directory, all int32.

    slot_to_row: (C,) global row held by each cache slot; -1 = empty.
    row_to_slot: (N,) inverse map; -1 = not cached.
    slot_freq:   (C,) eviction priority: LFU hit counters, or the dataset
                 frequency of the resident row.
    """

    slot_to_row: torch.Tensor
    row_to_slot: torch.Tensor
    slot_freq: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.slot_to_row.shape[0]

    @property
    def num_rows(self) -> int:
        return self.row_to_slot.shape[0]


class Plan(NamedTuple):
    """The admit/evict plan of one ``plan_ids`` step, packed for two
    readbacks.

    indices: (3, U) int32 rows [admit_rows, admit_slots, evict_rows]; lanes
             at and past ``n_miss`` are -1. The admit slots are the victims,
             and evict_rows their previous occupants (-1 where empty).
    scalars: (6,) int32 [n_miss, n_unique, capacity_ok, n_hit_unique,
             n_hit_weighted, n_ids]; capacity_ok == 0 means the window needs
             more slots than the cache has.
    """

    indices: torch.Tensor
    scalars: torch.Tensor


def init_cache_state(num_rows: int, capacity: int, device=None) -> CacheState:
    return CacheState(
        slot_to_row=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        row_to_slot=torch.full((num_rows,), -1, dtype=torch.int32, device=device),
        slot_freq=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def _set_dropping(base: torch.Tensor, *writes) -> torch.Tensor:
    """A new ``base`` with each (idx, src) of ``writes`` set in turn, where
    an index equal to ``len(base)`` drops its lane (JAX's ``mode="drop"``):
    those writes land in one extra element that is cut off. The kept lanes
    of one write must have distinct indices."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,))])
    for idx, src in writes:
        if not isinstance(src, torch.Tensor):
            src = torch.full(idx.shape, src, dtype=base.dtype, device=base.device)
        out.scatter_(0, idx.long(), src)
    return out[:n]


def plan_ids(
    state: CacheState,
    ids: torch.Tensor,
    dataset_freq: Optional[torch.Tensor] = None,
    *,
    unique_budget: int,
    strategy: EvictionStrategy = EvictionStrategy.LFU,
    approx_evict: bool = False,
) -> tuple:
    """One cache-maintenance step: make every id of ``ids`` resident, in plan
    form. Returns (new_state, Plan); ``state`` is left as it was.

    ids: (L,) int32 global rows in [0, N) (the caller validates the range).
    dataset_freq: (N,) int32, required for EvictionStrategy.DATASET.
    unique_budget: U >= the expected unique count; where the true count
        exceeds min(U, C) the plan is incomplete, which ``n_unique`` shows.
    approx_evict: JAX selects the victims by ``lax.approx_min_k`` and sorts
        within them; this computes the exact selection for either value.
    """
    del approx_evict
    if strategy == EvictionStrategy.DATASET and dataset_freq is None:
        raise ValueError("EvictionStrategy.DATASET requires dataset_freq")
    C, N = state.capacity, state.num_rows
    U = min(int(unique_budget), C)
    dev = state.slot_to_row.device
    uids, counts, n_unique = unique_mask(ids, U, N)
    valid = uids >= 0
    slots = state.row_to_slot.index_select(0, torch.where(valid, uids, 0))
    is_hit = valid & (slots >= 0)
    miss = valid & (slots < 0)
    n_miss = miss.sum(dtype=torch.int32)

    # slots the window hits are protected from eviction
    hit_slots = torch.where(is_hit, slots, C)
    protected = _set_dropping(torch.zeros((C,), dtype=torch.bool, device=dev), (hit_slots, True))
    # victims: empty slots first, then the lowest frequency; protected never
    score = torch.where(state.slot_to_row < 0, -1.0, state.slot_freq.float())
    score = torch.where(protected, torch.inf, score)
    victim_slots = torch.argsort(score, stable=True)[:U]
    victim_scores = score[victim_slots]
    victim_slots = victim_slots.to(torch.int32)

    # misses compacted to the front: admit i goes to victim slot i
    miss_rank = torch.cumsum(miss, 0, dtype=torch.int32) - 1
    target = torch.where(miss, miss_rank, U)
    admit_rows = _set_dropping(torch.full((U,), -1, dtype=torch.int32, device=dev), (target, uids))
    admit_counts = _set_dropping(torch.zeros((U,), dtype=torch.int32, device=dev), (target, counts))
    active = torch.arange(U, dtype=torch.int32, device=dev) < n_miss
    admit_slots = torch.where(active, victim_slots, -1)
    evict_rows = torch.where(active, state.slot_to_row.index_select(0, victim_slots), -1)
    # an active victim that is protected: the working set exceeds C
    capacity_ok = ~torch.any(active & torch.isinf(victim_scores))

    r2s = _set_dropping(state.row_to_slot, (torch.where(evict_rows >= 0, evict_rows, N), -1),
                        (torch.where(active, admit_rows, N), admit_slots))
    safe_admit_slots = torch.where(active, admit_slots, C)
    s2r = _set_dropping(state.slot_to_row, (safe_admit_slots, admit_rows))
    if strategy == EvictionStrategy.LFU:
        # hit slots are never victims, so JAX's add onto them reads the old counters
        hit_freq = state.slot_freq.index_select(0, hit_slots.clamp(max=C - 1)) + counts
        freq = _set_dropping(state.slot_freq, (safe_admit_slots, admit_counts), (hit_slots, hit_freq))
    else:
        admit_freq = dataset_freq.index_select(0, admit_rows.clamp(0, N - 1)).to(torch.int32)
        freq = _set_dropping(state.slot_freq, (safe_admit_slots, admit_freq))

    plan = Plan(
        indices=torch.stack([admit_rows, admit_slots, evict_rows]),
        scalars=torch.stack([
            n_miss, n_unique.to(torch.int32), capacity_ok.to(torch.int32), is_hit.sum(dtype=torch.int32),
            torch.where(is_hit, counts, 0).sum(dtype=torch.int32),
            torch.full((), ids.shape[0], dtype=torch.int32, device=dev),  # a fill: no copy that waits
        ]),
    )
    return CacheState(slot_to_row=s2r, row_to_slot=r2s, slot_freq=freq), plan


def remap_ids(state: CacheState, ids: torch.Tensor) -> torch.Tensor:
    """Global rows -> cache slots (valid once ``plan_ids`` made them resident)."""
    return state.row_to_slot.index_select(0, ids)


def gather_slots(
    cache_weight: torch.Tensor, slots: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Read rows out of the device cache (eviction writeback / flush).
    ``slots`` are valid slot ids (the port ships exact counts, no padding).
    fp8 rows widen exactly to ``out_dtype`` (bf16 or f32)."""
    rows = cache_weight.index_select(0, slots)
    return rows.to(out_dtype) if out_dtype is not None else rows


def scatter_admits(
    cache_weight: torch.Tensor, slots: torch.Tensor, values: torch.Tensor
) -> None:
    """Land admitted rows in their cache slots, in place. ``values`` arrive in
    the transfer dtype (f32 or bf16) and are cast to the cache dtype as
    ``jnp.astype`` casts them (``ops/rounding.astype_storage``)."""
    index_copy_storage_(cache_weight, slots, values)


def gather_slots_q8(cache_weight: torch.Tensor, slots: torch.Tensor):
    """Rows read out of the device cache with a per-row symmetric int8
    quantization on the device: (q (n, D) int8, scales (n,) f32)."""
    rows = cache_weight.index_select(0, slots).float()
    absmax = rows.abs().amax(dim=1)
    # XLA divides by the constant as a multiply by its f32 reciprocal
    scale = torch.where(absmax > 0, absmax * np.float32(1.0 / 127.0).item(), torch.ones_like(absmax))
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequant_q8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(n, D) f32 rows of int8 payloads: ``q * scale``, rounded to f32."""
    return q.float() * scales[:, None]


def dequant_rows_q4(packed: torch.Tensor, scales: torch.Tensor, D: int) -> torch.Tensor:
    """Inverse of the host's ``_quant_rows_host4``: (n, D/2) uint8 nibble
    pairs (element 2k low, biased by 8) and (n,) f32 scales -> (n, D) f32."""
    u = packed.to(torch.int32)
    q = torch.stack([(u & 0xF) - 8, (u >> 4) - 8], dim=-1).reshape(packed.shape[0], D)
    return q.float() * scales[:, None]


def scatter_admits_q8(cache_weight: torch.Tensor, slots: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor) -> None:
    """Land int8 admitted rows: dequantized to f32 on the device, then cast
    to the cache dtype (two roundings, as JAX's ``scatter_admits_q8``)."""
    index_copy_storage_(cache_weight, slots, dequant_q8(q, scales))


def scatter_admits_q4(cache_weight: torch.Tensor, slots: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> None:
    """Land int4 admitted rows (nibble pairs, per-row scales)."""
    index_copy_storage_(cache_weight, slots, dequant_rows_q4(packed, scales, cache_weight.shape[1]))
