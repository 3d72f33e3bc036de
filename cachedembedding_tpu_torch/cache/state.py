"""Cache-state helpers on torch tensors (counterpart of
``cachedembedding_tpu/cache/state.py``).

Only what the host-planner slice uses is here: the eviction strategy enum,
the slot gather/scatter of the device cache and the int8/int4 admit
payloads' dequantizing scatters. The jit-style device planner
(``plan_ids``) is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
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
