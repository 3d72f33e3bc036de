"""Cache-state helpers on torch tensors (counterpart of
``cachedembedding_tpu/cache/state.py``).

Only what the host-planner slice uses is here: the eviction strategy enum and
the slot gather/scatter of the device cache. The jit-style device planner
(``plan_ids``) is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from cachedembedding_tpu_torch.ops.rounding import index_copy_storage_


class EvictionStrategy(enum.Enum):
    """Mirror of the reference's ``EvictionStrategy`` enum."""

    LFU = "lfu"          # runtime frequency counters
    DATASET = "dataset"  # static dataset id frequency


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
