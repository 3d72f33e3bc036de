"""Procedural long-tail synthetic dataset — runs with no data on disk.

A copy of ``cachedembedding_tpu/data/synthetic.py`` that yields the port's
``Batch`` (CPU torch tensors over the same numpy draws, so both packages see
identical batches for the same seed). Per-feature Zipf-like ids come from
inverse-CDF sampling

    u ~ U[(1/E)^s, 1],  id = floor(u^(-1/s)) - 1

which yields a heavy head (id 0 most likely) and a long tail over E ids. Labels
can be made learnable (a logistic function of a hidden per-id weight plus
dense noise); ids are emitted in the fused global id space (per-feature table
offsets applied).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures


class SyntheticLongTailDataset:
    def __init__(
        self,
        table_sizes: Sequence[int],
        batch_size: int,
        num_batches: int,
        *,
        dense_in_features: int = 13,
        pooling_factor: int = 1,
        skew: float = 0.25,
        seed: int = 0,
        learnable_labels: bool = True,
        global_ids: bool = True,
        label_seed: int = 7919,  # shared across splits: the label function is
        # a property of the synthetic world, not of the sampling seed
        label_scale: float = 1.0,  # multiplies the logit before the sigmoid
    ):
        self.table_sizes = list(table_sizes)
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.dense_in_features = dense_in_features
        self.pooling_factor = pooling_factor
        self.skew = skew
        self.seed = seed
        self.learnable_labels = learnable_labels
        self.label_scale = float(label_scale)
        self.global_ids = global_ids
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(np.int64)
        self.label_seed = label_seed
        if learnable_labels:
            rng = np.random.default_rng(label_seed)
            # hidden logit contribution for the head ids only; tail ids get 0
            self._hidden = [
                rng.normal(0.0, 1.0, size=min(n, 32)).astype(np.float32)
                for n in self.table_sizes
            ]

    @property
    def num_features(self) -> int:
        return len(self.table_sizes)

    def _sample_feature_ids(self, rng: np.random.Generator, E: int, n: int) -> np.ndarray:
        s = self.skew
        min_u = (1.0 / E) ** s
        u = rng.random(n, dtype=np.float64) * (1.0 - min_u) + min_u
        ids = np.floor(u ** (-1.0 / s)).astype(np.int64) - 1
        return np.clip(ids, 0, E - 1)

    def make_batch(self, batch_idx: int) -> Batch:
        rng = np.random.default_rng(self.seed * 1_000_003 + batch_idx)
        B, F, P = self.batch_size, self.num_features, self.pooling_factor
        values = np.empty((F, B, P), dtype=np.int64)
        logit = np.zeros((B,), dtype=np.float32)
        for f, E in enumerate(self.table_sizes):
            ids = self._sample_feature_ids(rng, E, B * P).reshape(B, P)
            if self.learnable_labels:
                h = self._hidden[f]
                head = ids < h.shape[0]
                logit += np.where(head, h[np.minimum(ids, h.shape[0] - 1)], 0.0).sum(axis=1)
            values[f] = ids + (self.offsets[f] if self.global_ids else 0)
        dense = rng.random((B, self.dense_in_features), dtype=np.float32)
        if self.learnable_labels:
            logit = self.label_scale * (
                logit / np.sqrt(F * P) + 2.0 * (dense[:, 0] - 0.5)
            )
            p = 1.0 / (1.0 + np.exp(-logit))
            labels = (rng.random(B) < p).astype(np.int32)
        else:
            labels = rng.integers(0, 2, size=B).astype(np.int32)
        feats = RaggedFeatures(
            values=torch.from_numpy(values.reshape(-1).astype(np.int32)),
            offsets=None,
            num_features=F,
            batch_size=B,
            pooling=P,
        )
        return Batch(
            dense_features=torch.from_numpy(dense),
            sparse_features=feats,
            labels=torch.from_numpy(labels),
        )

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self.make_batch(i)

    def __len__(self) -> int:
        return self.num_batches

    def id_freq_map(self, sample_batches: Optional[int] = None) -> np.ndarray:
        """Exact long-tail expected frequency per global id (analytic, no scan) —
        stands in for the reference's get_id_freq_map."""
        total = sum(self.table_sizes)
        freq = np.zeros((total,), dtype=np.int64)
        draws = self.batch_size * self.pooling_factor * self.num_batches
        s = self.skew
        for f, E in enumerate(self.table_sizes):
            ids = np.arange(1, E + 1, dtype=np.float64)
            # P(id = k-1) ∝ measure of u in [(k+1)^-s, k^-s]
            cdf_hi = ids ** (-s)
            cdf_lo = (ids + 1) ** (-s)
            p = cdf_hi - cdf_lo
            p[-1] += (E + 1.0) ** (-s) - (1.0 / E) ** s + p[-1] * 0  # tail mass clamp
            p = np.maximum(p, 0)
            p /= p.sum()
            freq[self.offsets[f] : self.offsets[f + 1]] = np.maximum(
                (p * draws).astype(np.int64), 0
            )
        return freq
