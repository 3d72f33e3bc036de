"""Embedding-bag lookup for uniform pooling (counterpart of
``cachedembedding_tpu/ops/embedding_bag.py``).

The lookup is a gather ``(F, B, P) -> (B, F, D)``: Kernel 1
(``ops/gather_rows.py``) lands rows straight in the (B, P, F, D) layout, and a
pooling factor P > 1 sums over P in f32. P == 1 — the Criteo/Avazu hot path —
is the gather alone, and f32 and bf16 rows keep their storage dtype; fp8 rows
are upcast to f32 right after the gather, as the JAX package does. Ragged
bags (``bag_pool_ragged``) and ``per_sample_weights`` are ROADMAP Queue 1
item 2.
"""

from __future__ import annotations

import torch

from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def pool_uniform(rows: torch.Tensor, batch_size: int, mode: str = "sum") -> torch.Tensor:
    """Pool Kernel 1's (B*P, F, D) rows over the pooling axis P: (B, F, D).
    P == 1 is the identity and f32/bf16 rows keep their storage dtype; P > 1
    sums (or averages) in f32. fp8 rows become f32 first."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"unsupported mode {mode!r}")
    if rows.dtype in _FP8:
        rows = rows.float()
    _, F, D = rows.shape
    rows = rows.reshape(batch_size, -1, F, D)
    if rows.shape[1] == 1:
        return rows[:, 0]
    rows = rows.float()
    return rows.sum(dim=1) if mode == "sum" else rows.mean(dim=1)


def bag_pool_uniform(weight: torch.Tensor, ids_fbp: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """Pooled lookup for uniform pooling. weight (C, D); ids_fbp (F, B, P)
    int32 indices into weight. Returns (B, F, D)."""
    F, B, _ = ids_fbp.shape
    return pool_uniform(gather_rows(weight, ids_fbp.reshape(-1), F), B, mode)


def embedding_bag(weight: torch.Tensor, features: RaggedFeatures, mode: str = "sum") -> torch.Tensor:
    """Dispatching lookup: (B, F, D) for uniform pooling."""
    if features.pooling is None:
        raise NotImplementedError("ragged bags (bag_pool_ragged) are ROADMAP Queue 1 item 2")
    return bag_pool_uniform(weight, features.to_fbp(), mode=mode)
