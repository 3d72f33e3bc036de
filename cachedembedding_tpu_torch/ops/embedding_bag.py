"""Embedding-bag lookup for uniform and ragged bags (counterpart of
``cachedembedding_tpu/ops/embedding_bag.py``).

Uniform pooling is a gather ``(F, B, P) -> (B, F, D)``: Kernel 1
(``ops/gather_rows.py``) lands rows straight in the (B, P, F, D) layout, and a
pooling factor P > 1 sums over P in f32. P == 1 — the Criteo/Avazu hot path —
is the gather alone, and f32 and bf16 rows keep their storage dtype; fp8 rows
are upcast to f32 right after the gather, as the JAX package does.

Ragged bags (``bag_pool_ragged``, the fbgemm-trace workload) gather the flat
value stream with Kernel 1 (F = 1), upcast to f32 and sum each bag's rows
into its segment (``pool_ragged``; an XLA ``segment_sum`` in JAX, torch ops
here, summed in f32). Empty bags give zeros. ``mean`` divides by
``max(count, 1)``, with the count summed in ``count_dtype`` as JAX sums its
ones: in the weight's dtype for a lookup (so a bf16 count stops at 256 and an
float8_e4m3fn one at 16, where adding 1 rounds back), in f32 on the
trainer's sparse branch. ``per_sample_weights`` scale the f32 rows (``sum``
only).
"""

from __future__ import annotations

from typing import Optional

import torch

from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _check_mode(mode: str, per_sample_weights) -> None:
    if mode not in ("sum", "mean"):
        raise ValueError(f"unsupported mode {mode!r}")
    if per_sample_weights is not None and mode != "sum":
        raise ValueError("per_sample_weights requires mode='sum'")


def pool_uniform(rows: torch.Tensor, batch_size: int, mode: str = "sum",
                 per_sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pool Kernel 1's (B*P, F, D) rows over the pooling axis P: (B, F, D).
    P == 1 is the identity and f32/bf16 rows keep their storage dtype; P > 1
    sums (or averages) in f32. fp8 rows become f32 first.
    ``per_sample_weights`` (F, B, P) scale the rows in f32."""
    _check_mode(mode, per_sample_weights)
    if rows.dtype in _FP8:
        rows = rows.float()
    _, F, D = rows.shape
    rows = rows.reshape(batch_size, -1, F, D)
    if per_sample_weights is not None:
        rows = rows.float() * per_sample_weights.permute(1, 2, 0)[..., None]
    if rows.shape[1] == 1:
        return rows[:, 0]
    rows = rows.float()
    return rows.sum(dim=1) if mode == "sum" else rows.mean(dim=1)


def bag_pool_uniform(weight: torch.Tensor, ids_fbp: torch.Tensor, mode: str = "sum",
                     per_sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled lookup for uniform pooling. weight (C, D); ids_fbp (F, B, P)
    int32 indices into weight. Returns (B, F, D)."""
    F, B, _ = ids_fbp.shape
    return pool_uniform(gather_rows(weight, ids_fbp.reshape(-1), F), B, mode, per_sample_weights)


def count_cap(dtype: torch.dtype) -> int:
    """Where a count of ones summed in ``dtype`` stops: 2 ** (mantissa bits
    + 1), past which adding 1 rounds back (f32 2^24, bf16 256, float8_e4m3fn
    16, float8_e5m2 8)."""
    return int(round(2.0 / torch.finfo(dtype).eps))


def pool_ragged(rows: torch.Tensor, segment_ids: torch.Tensor, lengths: torch.Tensor, num_bags: int,
                mode: str = "sum", count_dtype: torch.dtype = torch.float32,
                per_sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-sum pooling of gathered (L, D) rows, in f32: (num_bags, D).
    ``segment_ids`` (L,) is each row's bag (num_bags or more: dropped);
    ``lengths`` (num_bags,) the ids per bag, which ``mean`` divides by as a
    count summed in ``count_dtype``."""
    _check_mode(mode, per_sample_weights)
    rows = rows.float()
    if per_sample_weights is not None:
        rows = rows * per_sample_weights.float()[:, None]
    seg = torch.clamp_max(segment_ids.long(), num_bags)  # one spill bag for the dropped rows
    pooled = torch.zeros((num_bags + 1, rows.shape[1]), dtype=torch.float32, device=rows.device)
    pooled = pooled.index_add(0, seg, rows)[:num_bags]
    if mode == "mean":
        counts = torch.clamp(lengths.to(torch.int64), 1, count_cap(count_dtype)).float()
        pooled = pooled / counts[:, None]
    return pooled


def bag_pool_ragged(weight: torch.Tensor, values: torch.Tensor, segment_ids: torch.Tensor, num_bags: int,
                    mode: str = "sum", per_sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled lookup for ragged bags: values (L,) int32 ids into weight (C, D),
    segment_ids (L,) each id's bag (sorted, feature-major). Returns
    (num_bags, D) f32; empty bags give zeros, ``mean`` counts in the
    weight's dtype."""
    rows = gather_rows(weight, values, 1)[:, 0]
    seg = segment_ids.long()
    lengths = torch.bincount(seg[seg < num_bags], minlength=num_bags)
    return pool_ragged(rows, seg, lengths, num_bags, mode, weight.dtype, per_sample_weights)


def embedding_bag(weight: torch.Tensor, features: RaggedFeatures, mode: str = "sum",
                  per_sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching lookup: (B, F, D) for uniform pooling, else (F*B, D)
    reshaped to (B, F, D) from the feature-major ragged stream.
    ``per_sample_weights`` is (L,), flat and feature-major."""
    F, B = features.num_features, features.batch_size
    if features.pooling is not None:
        psw = None if per_sample_weights is None else per_sample_weights.reshape(F, B, features.pooling)
        return bag_pool_uniform(weight, features.to_fbp(), mode=mode, per_sample_weights=psw)
    pooled = bag_pool_ragged(weight, features.values, features.segment_ids(), F * B, mode=mode,
                             per_sample_weights=per_sample_weights)
    return pooled.reshape(F, B, -1).transpose(0, 1)
