"""fbgemm embedding-trace replayer (counterpart of
``cachedembedding_tpu/data/synth.py``), the analog of the reference's synth
dataset, which replays Meta's dlrm_datasets ``fbgemm_t856_bs65536`` traces:
per-table (indices, offsets) pools captured from production, giving
realistic skew without shipping raw data.

Trace files: ``.pt`` pairs as the reference saves them (read with
``torch.load``) or an ``.npz`` with arrays ``indices``/``offsets``.
``choose_tables`` mirrors the reference's named subsets: keep the first
tables whose total id space reaches the requested size. Batches are ragged
(variable pooling) with explicit offsets, and equal the JAX package's for the
same traces and seed: the same numpy generator draws the dense features and
the labels.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch.jagged import Batch, RaggedFeatures

DATA_SIZE_TABLES = {  # name -> total id-space target
    "4M": 4_000_000,
    "52M": 52_000_000,
    "512M": 512_000_000,
    "2G": 2_000_000_000,
}


def load_trace(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load one (indices, offsets) trace file (.pt or .npz) as int64 arrays."""
    if path.endswith(".npz"):
        z = np.load(path)
        return np.asarray(z["indices"], np.int64), np.asarray(z["offsets"], np.int64)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    indices, offsets = obj[0], obj[1]
    return indices.numpy().astype(np.int64), offsets.numpy().astype(np.int64)


def compact_ids(indices: np.ndarray) -> Tuple[np.ndarray, int]:
    """Remap raw trace ids to a dense [0, n_unique) space (the reference's
    offline preprocessing, torch.unique with return_inverse)."""
    uniq, inverse = np.unique(indices, return_inverse=True)
    return inverse.astype(np.int64), int(uniq.shape[0])


def choose_tables(table_sizes: Sequence[int], data_size: str) -> List[int]:
    """First K tables whose cumulative id space reaches the named target."""
    target = DATA_SIZE_TABLES[data_size]
    out, total = [], 0
    for i, n in enumerate(table_sizes):
        out.append(i)
        total += n
        if total >= target:
            break
    return out


class SynthTraceDataset:
    """Replays per-table trace pools as ragged batches.

    Each table t has a trace (indices_t, offsets_t) over ``stride`` bags; a
    batch of size B takes bags [i*B, (i+1)*B) from every table, wrapping
    around the pool (the reference iterates its 65,536-bag pool the same
    way). A run of consecutive bags is one slice of the indices, so a batch
    costs a few array slices per table.
    """

    def __init__(
        self,
        traces: Sequence[Tuple[np.ndarray, np.ndarray]],  # per-table (indices, offsets)
        table_sizes: Sequence[int],
        batch_size: int,
        num_batches: int,
        *,
        dense_in_features: int = 13,
        seed: int = 0,
        global_ids: bool = True,
    ):
        if len(traces) != len(table_sizes):
            raise ValueError("one trace per table")
        self.traces = [(np.asarray(i, np.int64), np.asarray(o, np.int64)) for i, o in traces]
        self.table_sizes = list(table_sizes)
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.dense_in_features = dense_in_features
        self.seed = seed
        self.global_ids = global_ids
        self.offsets = np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(np.int64)
        self.strides = [int(off.shape[0] - 1) for _, off in self.traces]

    @classmethod
    def from_dir(cls, trace_dir: str, batch_size: int, num_batches: int, *, data_size: str = "4M",
                 compact: bool = True, **kw) -> "SynthTraceDataset":
        """One table per ``.pt``/``.npz`` file of ``trace_dir`` (sorted by
        name), ids compacted, the first tables that reach ``data_size``."""
        files = sorted(f for f in os.listdir(trace_dir) if f.endswith((".pt", ".npz")))
        if not files:
            raise FileNotFoundError(f"no trace files in {trace_dir}")
        traces, sizes = [], []
        for f in files:
            idx, off = load_trace(os.path.join(trace_dir, f))
            if compact:
                idx, n = compact_ids(idx)
            else:
                n = int(idx.max()) + 1 if idx.size else 1
            traces.append((idx, off))
            sizes.append(n)
        keep = choose_tables(sizes, data_size)
        return cls([traces[i] for i in keep], [sizes[i] for i in keep], batch_size, num_batches, **kw)

    def _bags(self, f: int, lo: int) -> Tuple[np.ndarray, np.ndarray]:
        """Table f's bags [lo, lo + B) of its pool, wrapping: (values, lengths)."""
        idx, off = self.traces[f]
        stride, B = self.strides[f], self.batch_size
        bags = np.arange(lo, lo + B) % stride
        lengths = off[bags + 1] - off[bags]
        # consecutive bags are one slice of the indices; a wrap starts another
        cuts = np.flatnonzero(np.diff(bags) != 1) + 1
        runs = np.split(bags, cuts)
        vals = [idx[off[r[0]]:off[r[-1] + 1]] for r in runs if r.size]
        return (np.concatenate(vals) if vals else np.zeros(0, np.int64)), lengths

    def make_batch(self, index: int) -> Batch:
        F, B = len(self.traces), self.batch_size
        rng = np.random.default_rng(self.seed * 99991 + index)
        values_parts: List[np.ndarray] = []
        lengths = np.empty((F, B), np.int64)
        for f in range(F):
            vals, lengths[f] = self._bags(f, (index * B) % self.strides[f])
            values_parts.append(vals + self.offsets[f] if self.global_ids else vals)
        values = np.concatenate(values_parts) if values_parts else np.zeros(0, np.int64)
        bag_offsets = np.concatenate([[0], np.cumsum(lengths.reshape(-1))]).astype(np.int32)
        dense = rng.normal(0.0, 1.0, (B, self.dense_in_features)).astype(np.float32)
        labels = rng.integers(0, 2, (B,)).astype(np.float32)
        return Batch(
            dense_features=torch.from_numpy(dense),
            sparse_features=RaggedFeatures(
                values=torch.from_numpy(values.astype(np.int32)), offsets=torch.from_numpy(bag_offsets),
                num_features=F, batch_size=B, pooling=None,
            ),
            labels=torch.from_numpy(labels),
        )

    def id_freq_map(self) -> np.ndarray:
        """Occurrences of each global id over the whole trace pools."""
        ids = [idx + (self.offsets[f] if self.global_ids else 0) for f, (idx, _) in enumerate(self.traces)]
        return np.bincount(np.concatenate(ids), minlength=int(self.offsets[-1])).astype(np.int64)

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self.make_batch(i)

    def __len__(self) -> int:
        return self.num_batches
