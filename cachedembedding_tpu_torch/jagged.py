"""Ragged sparse-feature containers on torch tensors (counterpart of
``cachedembedding_tpu/jagged.py``, the analog of torchrec's KeyedJaggedTensor).

Ids are laid out *feature-major*: all of feature 0's bags, then feature 1's,
and so on, with ``stride == batch_size``. Criteo and Avazu have one id per
(sample, feature): under uniform pooling the values reshape to ``(F, B, P)``
and the offsets are implicit. Ragged bags (the fbgemm-trace workload,
``data/synth.py``) carry explicit ``(F*B + 1,)`` offsets, include-last-offset.
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

    @property
    def num_bags(self) -> int:
        return self.num_features * self.batch_size

    def offsets_or_implicit(self) -> torch.Tensor:
        """(F*B + 1,) int32 bag boundaries (``arange * pooling`` when uniform)."""
        if self.offsets is not None:
            return self.offsets
        if self.pooling is None:
            raise ValueError("ragged features need offsets")
        return torch.arange(self.num_bags + 1, dtype=torch.int32, device=self.values.device) * self.pooling

    def lengths(self) -> torch.Tensor:
        """(F*B,) ids per bag."""
        off = self.offsets_or_implicit()
        return off[1:] - off[:-1]

    def segment_ids(self) -> torch.Tensor:
        """(L,) int32 bag index of each value; positions past the last offset
        map to F*B, out of range, where a segment sum drops them."""
        off = self.offsets_or_implicit()
        pos = torch.arange(self.values.shape[0], dtype=off.dtype, device=off.device)
        return (torch.searchsorted(off, pos, right=True) - 1).to(torch.int32)

    @staticmethod
    def from_dense_ids(ids_bf: torch.Tensor) -> "RaggedFeatures":
        """Build from a (B, F) one-id-per-feature matrix (the Criteo/Avazu shape)."""
        B, F = ids_bf.shape
        return RaggedFeatures(values=ids_bf.t().reshape(-1).to(torch.int32), offsets=None,
                              num_features=F, batch_size=B, pooling=1)

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
    """Concatenate the sparse values of several batches into one flat id
    stream — what the trainer plans for far-sighted prefetch."""
    return np.concatenate([b.sparse_features.values.numpy() for b in batches])
