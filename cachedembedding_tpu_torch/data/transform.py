"""Dict batch -> ``Batch`` (counterpart of
``cachedembedding_tpu/data/transform.py``, the KJTTransform analog): columns
of an NVTabular-style dict batch become the port's ``Batch``, each feature's
ids hashed into its table and shifted into the fused global id space."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures


class DictBatchTransform:
    def __init__(
        self,
        dense_cols: Sequence[str],
        sparse_cols: Sequence[str],
        table_sizes: Sequence[int],
        label_col: str = "label",
        *,
        hash_ids: bool = True,
        global_ids: bool = True,
    ):
        if len(sparse_cols) != len(table_sizes):
            raise ValueError(f"{len(sparse_cols)} sparse columns for {len(table_sizes)} tables")
        self.dense_cols = list(dense_cols)
        self.sparse_cols = list(sparse_cols)
        self.table_sizes = np.asarray(table_sizes, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)])
        self.label_col = label_col
        self.hash_ids = hash_ids
        self.global_ids = global_ids

    def __call__(self, columns: Mapping[str, np.ndarray]) -> Batch:
        dense = np.stack([np.asarray(columns[c], np.float32).reshape(-1) for c in self.dense_cols], axis=1)
        sparse = np.stack([np.asarray(columns[c], np.int64).reshape(-1) for c in self.sparse_cols], axis=1)
        if self.hash_ids:
            sparse = sparse % self.table_sizes[None, :]
        if self.global_ids:
            sparse = sparse + self.offsets[None, :-1]
        labels = np.asarray(columns[self.label_col], np.float32).reshape(-1)
        return Batch(
            dense_features=torch.from_numpy(dense),
            sparse_features=RaggedFeatures(
                values=torch.from_numpy(sparse.T.reshape(-1).astype(np.int32)), offsets=None,
                num_features=len(self.sparse_cols), batch_size=dense.shape[0], pooling=1,
            ),
            labels=torch.from_numpy(labels),
        )
