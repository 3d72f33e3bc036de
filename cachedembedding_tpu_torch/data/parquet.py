"""Streaming parquet reader (counterpart of
``cachedembedding_tpu/data/parquet.py``, the reference's petastorm path for
Criteo-1TB-scale data), over pyarrow row groups:

  * rank sharding by row-group round-robin (petastorm's cur_shard /
    shard_count);
  * batches re-chunked to exactly ``batch_size`` rows across row groups, the
    partial tail dropped;
  * ``% hash`` into each table, then the global-id offsets;
  * columns: the label, ``int_X`` dense, ``cat_X`` categorical.

pyarrow is imported when a reader is made: without it that raises an
ImportError that names it (the port needs it for this source only).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures


def import_parquet():
    """``pyarrow.parquet``, or an ImportError that says this source needs it."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("the criteo_parquet source (ParquetDataReader, SampledParquetCounter) needs pyarrow, "
                          "which is not installed") from e
    return pq


class ParquetDataReader:
    def __init__(
        self,
        parquet_dir: str,
        batch_size: int,
        table_sizes: Sequence[int],
        *,
        rank: int = 0,
        world_size: int = 1,
        dense_prefix: str = "int_",
        cat_prefix: str = "cat_",
        label_col: str = "label",
        log_transform: bool = True,
        global_ids: bool = True,
        limit_batches: Optional[int] = None,
    ):
        pq = import_parquet()
        self._pq = pq
        self.files = sorted(
            glob.glob(os.path.join(parquet_dir, "*.parquet"))
            or glob.glob(os.path.join(parquet_dir, "**", "*.parquet"), recursive=True)
        )
        if not self.files:
            raise FileNotFoundError(f"no .parquet files under {parquet_dir}")
        self.batch_size = batch_size
        self.table_sizes = np.asarray(table_sizes, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)])
        self.rank = rank
        self.world_size = world_size
        self.label_col = label_col
        self.log_transform = log_transform
        self.global_ids = global_ids
        self.limit_batches = limit_batches
        names = pq.ParquetFile(self.files[0]).schema_arrow.names
        self.dense_cols = sorted([n for n in names if n.startswith(dense_prefix)],
                                 key=lambda n: int(n[len(dense_prefix):]))
        self.cat_cols = sorted([n for n in names if n.startswith(cat_prefix)],
                               key=lambda n: int(n[len(cat_prefix):]))
        if len(self.cat_cols) != len(table_sizes):
            raise ValueError(f"{len(self.cat_cols)} cat columns vs {len(table_sizes)} tables")

    def _row_group_stream(self):
        """pyarrow tables of this rank's row groups, dealt round-robin."""
        g = 0
        for path in self.files:
            f = self._pq.ParquetFile(path)
            for rg in range(f.num_row_groups):
                if g % self.world_size == self.rank:
                    yield f.read_row_group(rg, columns=[self.label_col] + self.dense_cols + self.cat_cols)
                g += 1

    def _emit(self, dense, sparse, labels) -> Batch:
        if self.log_transform:
            dense = np.log(np.maximum(dense, 0.0) + 2.0, dtype=np.float32)
        sparse = sparse % self.table_sizes[None, :]
        if self.global_ids:
            sparse = sparse + self.offsets[None, :-1]
        return Batch(
            dense_features=torch.from_numpy(np.ascontiguousarray(dense, np.float32)),
            sparse_features=RaggedFeatures(
                values=torch.from_numpy(np.ascontiguousarray(sparse.T.reshape(-1), np.int32)),
                offsets=None, num_features=len(self.cat_cols), batch_size=labels.shape[0], pooling=1,
            ),
            labels=torch.from_numpy(np.ascontiguousarray(labels, np.float32)),
        )

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        emitted = buffered = 0
        buf_dense: List[np.ndarray] = []
        buf_sparse: List[np.ndarray] = []
        buf_labels: List[np.ndarray] = []
        for tbl in self._row_group_stream():
            buf_dense.append(np.stack([tbl[c].to_numpy(zero_copy_only=False) for c in self.dense_cols],
                                      axis=1).astype(np.float32))
            buf_sparse.append(np.stack([tbl[c].to_numpy(zero_copy_only=False) for c in self.cat_cols],
                                       axis=1).astype(np.int64))
            buf_labels.append(tbl[self.label_col].to_numpy(zero_copy_only=False).astype(np.float32))
            buffered += buf_labels[-1].shape[0]
            while buffered >= B:
                d, s, lab = (np.concatenate(x) for x in (buf_dense, buf_sparse, buf_labels))
                yield self._emit(d[:B], s[:B], lab[:B])
                emitted += 1
                if self.limit_batches is not None and emitted >= self.limit_batches:
                    return
                buf_dense, buf_sparse, buf_labels = [d[B:]], [s[B:]], [lab[B:]]
                buffered -= B
