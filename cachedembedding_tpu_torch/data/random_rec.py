"""Uniform-random recommendation batches (counterpart of
``cachedembedding_tpu/data/random_rec.py``, torchrec's RandomRecDataset
analog): the same numpy draws as the JAX package, so both yield equal
batches for one seed, as the port's ``Batch`` of CPU tensors."""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures


class RandomRecDataset:
    """Uniform ids (no skew: the worst case for a frequency-aware cache),
    normal dense features, Bernoulli labels."""

    def __init__(
        self,
        table_sizes: Sequence[int],
        batch_size: int,
        num_batches: int = 10,
        *,
        dense_in_features: int = 13,
        pooling_factor: int = 1,
        seed: int = 0,
        global_ids: bool = True,
    ):
        self.table_sizes = list(table_sizes)
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.dense_in_features = dense_in_features
        self.pooling_factor = pooling_factor
        self.seed = seed
        self.global_ids = global_ids
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(np.int64)

    def make_batch(self, index: int) -> Batch:
        rng = np.random.default_rng(self.seed * 100003 + index)
        F, B, P = len(self.table_sizes), self.batch_size, self.pooling_factor
        ids = np.empty((F, B, P), np.int64)
        for f, n in enumerate(self.table_sizes):
            ids[f] = rng.integers(0, n, (B, P))
            if self.global_ids:
                ids[f] += self.offsets[f]
        dense = rng.normal(0.0, 1.0, (B, self.dense_in_features)).astype(np.float32)
        labels = rng.integers(0, 2, (B,)).astype(np.float32)
        return Batch(
            dense_features=torch.from_numpy(dense),
            sparse_features=RaggedFeatures(
                values=torch.from_numpy(ids.reshape(-1).astype(np.int32)), offsets=None,
                num_features=F, batch_size=B, pooling=P,
            ),
            labels=torch.from_numpy(labels),
        )

    def id_freq_map(self) -> np.ndarray:
        return np.ones((int(self.offsets[-1]),), np.int64)

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self.make_batch(i)

    def __len__(self) -> int:
        return self.num_batches
