"""Ragged sparse-feature containers on torch tensors (counterpart of
``cachedembedding_tpu/jagged.py``, the analog of torchrec's KeyedJaggedTensor).

Ids are laid out *feature-major*: all of feature 0's bags, then feature 1's,
and so on, with ``stride == batch_size``. Criteo and Avazu have one id per
(sample, feature), so the slice only needs uniform pooling: values reshape to
``(F, B, P)`` and the offsets are implicit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RaggedFeatures:
    """Flat feature-major sparse id batch.

    values:  (L,) int32 — bag order (feature 0, sample 0), (feature 0, sample 1), ...
    offsets: (F*B + 1,) int32 bag boundaries, or None under uniform pooling.
    pooling: ids per bag when every bag has the same count.
    """

    values: torch.Tensor
    offsets: Optional[torch.Tensor]
    num_features: int
    batch_size: int
    pooling: Optional[int] = None

    @staticmethod
    def from_uniform(values_fbp: torch.Tensor) -> "RaggedFeatures":
        """Build from a (F, B, P) uniform-pooling id tensor."""
        F, B, P = values_fbp.shape
        return RaggedFeatures(
            values=values_fbp.reshape(-1).to(torch.int32),
            offsets=None,
            num_features=F,
            batch_size=B,
            pooling=P,
        )

    def to_fbp(self) -> torch.Tensor:
        """(F, B, P) view; only valid for uniform pooling."""
        if self.pooling is None:
            raise ValueError("to_fbp requires uniform pooling")
        return self.values.reshape(self.num_features, self.batch_size, self.pooling)


@dataclasses.dataclass(frozen=True)
class Batch:
    """One training batch (analog of torchrec.datasets.utils.Batch)."""

    dense_features: torch.Tensor  # (B, D_in) float32
    sparse_features: RaggedFeatures
    labels: torch.Tensor  # (B,) int32

    @property
    def batch_size(self) -> int:
        return self.sparse_features.batch_size


def concat_uniform_values(batches: List[Batch]) -> np.ndarray:
    """Concatenate the sparse values of several uniform batches into one flat
    id stream — what the trainer plans for far-sighted prefetch."""
    return np.concatenate([b.sparse_features.values.numpy() for b in batches])
