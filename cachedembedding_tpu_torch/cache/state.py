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


class EvictionStrategy(enum.Enum):
    """Mirror of the reference's ``EvictionStrategy`` enum."""

    LFU = "lfu"          # runtime frequency counters
    DATASET = "dataset"  # static dataset id frequency


def gather_slots(
    cache_weight: torch.Tensor, slots: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Read rows out of the device cache (eviction writeback / flush).
    ``slots`` are valid slot ids (the port ships exact counts, no padding)."""
    rows = cache_weight.index_select(0, slots)
    return rows.to(out_dtype) if out_dtype is not None else rows


def scatter_admits(
    cache_weight: torch.Tensor, slots: torch.Tensor, values: torch.Tensor
) -> None:
    """Land admitted rows in their cache slots, in place. ``values`` may arrive
    in a narrower transfer dtype (bf16) and is converted to the cache dtype."""
    cache_weight.index_copy_(0, slots, values.to(cache_weight.dtype))
