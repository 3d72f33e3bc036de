"""Id-frequency counting for cache warmup and DATASET eviction (counterpart
of ``cachedembedding_tpu/data/feature_counter.py``).

``GlobalFeatureCounter`` streams the npy sparse shards through a native
bincount in the fused global id space (after ``% hash`` and the table
offsets). ``get_id_freq_map`` loads or computes the map and caches it as
``id_freq_map.npy`` in the dataset directory, in the JAX package's format (a
(num_rows,) int64 array): a directory prepared by either package serves
both. The parquet counter waits for ``data/parquet.py`` (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence

import numpy as np

from cachedembedding_tpu_torch._native import hostops

FREQ_CACHE_NAME = "id_freq_map.npy"


class GlobalFeatureCounter:
    def __init__(self, sparse_files: List[str], table_sizes: Sequence[int]):
        self.sparse_files = sparse_files
        self.table_sizes = np.asarray(table_sizes, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)[:-1]])
        self.total = int(self.table_sizes.sum())

    def compute(self, chunk_rows: int = 1_000_000) -> np.ndarray:
        freq = np.zeros((self.total,), np.int64)
        for path in self.sparse_files:
            arr = np.load(path, mmap_mode="r")
            for s in range(0, arr.shape[0], chunk_rows):
                chunk = np.array(arr[s : s + chunk_rows], dtype=np.int64)  # a writable copy
                chunk %= self.table_sizes[None, :]
                chunk += self.offsets[None, :]
                hostops.bincount(chunk, self.total, out=freq)
        return freq


def get_id_freq_map(
    path: str,
    table_sizes: Sequence[int],
    *,
    is_rank_zero: bool = True,
    sparse_glob: str = "*sparse*",
) -> np.ndarray:
    """Load the cached frequency map of ``path``, or count it over the sparse
    shards and (on rank zero) cache it there."""
    cache_path = os.path.join(path, FREQ_CACHE_NAME)
    if os.path.exists(cache_path):
        return np.load(cache_path, mmap_mode="r")
    sparse_files = sorted(glob.glob(os.path.join(path, sparse_glob)))
    if not sparse_files:
        raise FileNotFoundError(f"no sparse npy shards matching {sparse_glob} in {path}")
    freq = GlobalFeatureCounter(sparse_files, table_sizes).compute()
    if is_rank_zero:
        np.save(cache_path, freq)
    return freq
