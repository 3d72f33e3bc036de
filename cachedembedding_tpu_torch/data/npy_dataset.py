"""In-memory npy dataset pipeline (counterpart of
``cachedembedding_tpu/data/npy_dataset.py``).

The preprocessed Criteo and Avazu layout: per day (or split) one
``*dense*.npy`` (rows, num_dense) float32, one ``*sparse*.npy`` (rows,
num_tables) of raw categorical values and one ``*labels*.npy`` (rows,).
What this module keeps of the JAX package, value for value:
  * per-rank contiguous row ranges across the concatenated files, the
    remainder going to the first ranks (``rank_row_ranges``);
  * the ``% hash`` remap of raw categorical values, then global-id offsets
    (``sparse += cumsum(table_sizes)`` shifts), so all tables share one fused
    id space;
  * tablewise mode: only ``assigned_tables`` are served;
  * train = every day but the final one, val/test = the first/second half of
    the final day, by doubling rank and world (``stage_files``);
  * an optional unison shuffle of each batch, seeded by ``seed + rank``;
  * the last partial batch is dropped.

Batches are the port's ``jagged.Batch`` of CPU tensors: uniform pooling 1,
feature-major int32 ids, float32 dense features, int32 labels.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures


def rank_row_ranges(lengths: Sequence[int], rank: int, world_size: int) -> Dict[int, Tuple[int, int]]:
    """Split the concatenation of files (with the given row counts) into
    ``world_size`` contiguous chunks; return {file_idx: (start_row,
    end_row_exclusive)} of this rank's chunk. Remainder rows go to the first
    ranks (the ``torch.tensor_split`` convention)."""
    total = int(sum(lengths))
    chunk, rem = divmod(total, world_size)
    start = rank * chunk + min(rank, rem)
    end = start + chunk + (1 if rank < rem else 0)
    out: Dict[int, Tuple[int, int]] = {}
    file_start = 0
    for i, n in enumerate(lengths):
        file_end = file_start + n
        lo, hi = max(start, file_start), min(end, file_end)
        if lo < hi:
            out[i] = (lo - file_start, hi - file_start)
        file_start = file_end
    return out


def _npy_num_rows(path: str) -> int:
    return int(np.load(path, mmap_mode="r").shape[0])


class InMemoryNpyDataset:
    """Loads this rank's row range of (dense, sparse, labels) npy shards into
    memory and serves fixed-size batches in the fused global id space."""

    def __init__(
        self,
        dense_paths: List[str],
        sparse_paths: List[str],
        labels_paths: List[str],
        batch_size: int,
        *,
        rank: int = 0,
        world_size: int = 1,
        shuffle_batches: bool = False,
        hashes: Optional[Sequence[int]] = None,
        assigned_tables: Optional[Sequence[int]] = None,
        seed: int = 0,
    ):
        if not len(dense_paths) == len(sparse_paths) == len(labels_paths):
            raise ValueError("need one dense, sparse and labels file per shard")
        self.batch_size = batch_size
        self.shuffle_batches = shuffle_batches
        self._rng = np.random.default_rng(seed + rank)

        ranges = rank_row_ranges([_npy_num_rows(p) for p in dense_paths], rank, world_size)
        dense_l, sparse_l, labels_l = [], [], []
        for i, (lo, hi) in ranges.items():
            dense_l.append(np.load(dense_paths[i], mmap_mode="r")[lo:hi].astype(np.float32))
            sparse_l.append(np.load(sparse_paths[i], mmap_mode="r")[lo:hi].astype(np.int64))
            labels_l.append(np.load(labels_paths[i], mmap_mode="r")[lo:hi].astype(np.int32))
        self.dense = np.concatenate(dense_l) if dense_l else np.zeros((0, 1), np.float32)
        sparse = np.concatenate(sparse_l) if sparse_l else np.zeros((0, 0), np.int64)
        self.labels = np.concatenate(labels_l).reshape(-1) if labels_l else np.zeros((0,), np.int32)

        num_tables = sparse.shape[1] if sparse.size else (len(hashes) if hashes else 0)
        if assigned_tables is None:
            assigned_tables = list(range(num_tables))
        self.assigned_tables = np.asarray(assigned_tables)
        if sparse.size:
            sparse = sparse[:, self.assigned_tables]
            if hashes is not None:
                h = np.asarray(hashes, np.int64)
                offsets = np.concatenate([[0], np.cumsum(h)[:-1]])
                sparse %= h[self.assigned_tables][None, :]
                sparse += offsets[self.assigned_tables][None, :]
        else:
            sparse = sparse.reshape(0, len(self.assigned_tables))
        self.sparse = sparse.astype(np.int64)
        self.num_batches = self.dense.shape[0] // batch_size

    @property
    def num_features(self) -> int:
        return int(self.assigned_tables.shape[0])

    def make_batch(self, idx: int) -> Batch:
        s, e = idx * self.batch_size, (idx + 1) * self.batch_size
        dense, sparse, labels = self.dense[s:e], self.sparse[s:e], self.labels[s:e]
        if self.shuffle_batches:
            perm = self._rng.permutation(self.batch_size)
            dense, sparse, labels = dense[perm], sparse[perm], labels[perm]
        feats = RaggedFeatures(
            values=torch.from_numpy(np.ascontiguousarray(sparse.T.reshape(-1), np.int32)),  # feature-major
            offsets=None,
            num_features=self.num_features,
            batch_size=self.batch_size,
            pooling=1,
        )
        return Batch(
            dense_features=torch.from_numpy(np.ascontiguousarray(dense)),
            sparse_features=feats,
            labels=torch.from_numpy(np.ascontiguousarray(labels)),
        )

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self.make_batch(i)

    def __len__(self) -> int:
        return self.num_batches


def stage_files(dataset_dir: str, stage: str, final_day: int) -> Tuple[List[str], List[str], List[str], int, int]:
    """Train = every day but ``final_day``; val = the first half of the final
    day, test = the second (by the rank/world doubling the caller applies).
    Returns (dense, sparse, labels paths, extra_rank_offset, world_multiplier)."""
    files = os.listdir(dataset_dir)
    final = f"day_{final_day}"
    if stage == "train":
        files = [f for f in files if final not in f]
        extra_rank, world_mult = 0, 1
    else:
        files = [f for f in files if final in f]
        extra_rank, world_mult = (0 if stage == "val" else 1), 2
    dense, sparse, labels = (
        sorted(os.path.join(dataset_dir, f) for f in files if kind in f) for kind in ("dense", "sparse", "labels")
    )
    return dense, sparse, labels, extra_rank, world_mult
