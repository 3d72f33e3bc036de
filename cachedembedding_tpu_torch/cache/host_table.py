"""Host-DRAM master tables behind the cache (counterpart of
``cachedembedding_tpu/cache/host_table.py``).

Two implementations of one protocol (gather/scatter/num_rows/dim, plus the
lazy-device-init hooks written_mask/row_bounds/seed):

  * ``DenseHostTable`` — a materialized float32 numpy array. With procedural
    metadata (the canonical per-row init) it tracks which rows have been
    written back, so the cache can synthesize never-trained rows on the GPU
    instead of transferring them (ops/synth_rows.py).
  * ``VirtualHostTable`` — rows are generated procedurally (same canonical
    generator) until first written back, after which they live in a native
    hash-table overlay. Host memory is the touched working set only.

Beside them, the host master of row-wise Adagrad's per-row accumulators
(4 bytes a row), which tiers with the cache as the rows do:
``DenseAccumStore`` for a dense table, ``OverlayAccumStore`` (a dim-1
overlay) for a virtual one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from cachedembedding_tpu_torch._native import hostops


def table_bounds(table_sizes: Sequence[int]) -> np.ndarray:
    """Per-table U(-1/sqrt(n), 1/sqrt(n)) init bound (torchrec
    EmbeddingBagConfig default)."""
    return (np.asarray(table_sizes, np.float64) ** -0.5).astype(np.float32)


def row_bounds_of(table_offsets: np.ndarray, bounds: np.ndarray, idx: np.ndarray) -> np.ndarray:
    table = np.searchsorted(table_offsets, idx, side="right") - 1
    return bounds[np.clip(table, 0, len(bounds) - 1)]


class DenseHostTable:
    def __init__(
        self,
        array: np.ndarray,
        *,
        procedural_seed: Optional[int] = None,
        table_sizes: Optional[Sequence[int]] = None,
    ):
        if array.ndim != 2 or array.dtype != np.float32:
            raise ValueError("DenseHostTable needs a 2-D float32 array")
        self.array = array
        self.seed = procedural_seed
        if procedural_seed is not None:
            if table_sizes is None:
                raise ValueError("procedural_seed needs table_sizes")
            self.table_sizes = np.asarray(table_sizes, np.int64)
            self.table_offsets = np.concatenate([[0], np.cumsum(self.table_sizes)])
            self._bounds = table_bounds(table_sizes)
            # rows whose host value differs from the canonical init (ever
            # written back): 1 byte per row
            self._written = np.zeros((array.shape[0],), np.bool_)
        else:
            self._written = None

    @property
    def supports_device_init(self) -> bool:
        return self._written is not None

    @property
    def num_rows(self) -> int:
        return self.array.shape[0]

    @property
    def dim(self) -> int:
        return self.array.shape[1]

    def gather(self, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        return hostops.gather_rows(self.array, idx, out)

    def scatter(self, idx: np.ndarray, vals: np.ndarray) -> None:
        hostops.scatter_rows(self.array, idx, vals)
        if self._written is not None:
            self._written[idx] = True

    def written_mask(self, idx: np.ndarray) -> np.ndarray:
        return self._written[idx]

    def row_bounds(self, idx: np.ndarray) -> np.ndarray:
        return row_bounds_of(self.table_offsets, self._bounds, idx)

    def mark_all_written(self) -> None:
        """After restoring arbitrary values (a checkpoint load), no row can be
        assumed to still hold its canonical init."""
        if self._written is not None:
            self._written[:] = True


class DenseAccumStore:
    """Host master of the row-wise Adagrad accumulators of a dense table: an
    (N,) float32 array, every row ``initial`` until written back."""

    def __init__(self, num_rows: int, initial: float = 0.0):
        self.arr = np.full((int(num_rows),), initial, np.float32)
        self.initial = float(initial)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return self.arr[np.asarray(idx, np.int64)]

    def scatter(self, idx: np.ndarray, vals: np.ndarray) -> None:
        self.arr[np.asarray(idx, np.int64)] = np.asarray(vals, np.float32).reshape(-1)

    def save_state(self) -> dict:
        return {"kind": "dense", "arr": self.arr}


class OverlayAccumStore:
    """Host master of the row-wise Adagrad accumulators of a virtual table:
    written rows live in a dim-1 native overlay; a row never written back
    reads as ``initial``."""

    def __init__(self, initial: float = 0.0, capacity_hint: int = 1 << 16):
        self._lib = hostops.load_lib()
        self._h = self._lib.overlay_create(1, 0, 0, capacity_hint)
        self.initial = float(initial)

    def written_mask(self, idx: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((idx.shape[0],), np.uint8)
        self._lib.overlay_contains(self._h, idx.ctypes.data, out.ctypes.data, idx.shape[0])
        return out.astype(np.bool_)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((idx.shape[0], 1), np.float32)
        bounds = np.zeros((idx.shape[0],), np.float32)  # unwritten rows: overwritten below
        self._lib.overlay_gather_f32(self._h, idx.ctypes.data, bounds.ctypes.data, out.ctypes.data, idx.shape[0])
        out = out.reshape(-1)
        out[~self.written_mask(idx)] = self.initial
        return out

    def scatter(self, idx: np.ndarray, vals: np.ndarray) -> None:
        idx = np.ascontiguousarray(idx, np.int64)
        vals = np.ascontiguousarray(vals, np.float32).reshape(-1, 1)
        if vals.shape[0] != idx.shape[0]:
            raise ValueError(f"{vals.shape[0]} accumulators for {idx.shape[0]} rows")
        self._lib.overlay_scatter_f32(self._h, idx.ctypes.data, vals.ctypes.data, idx.shape[0])

    def written_rows(self) -> np.ndarray:
        n = int(self._lib.overlay_used(self._h))
        out = np.empty((n,), np.int64)
        if n:
            self._lib.overlay_keys(self._h, out.ctypes.data)
        return out

    def save_state(self) -> dict:
        rows = self.written_rows()
        return {"kind": "overlay", "rows": rows, "vals": self.gather(rows)}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.overlay_free(h)
            self._h = None


class VirtualHostTable:
    """``dim`` columns from ``col_start`` of each row (a column-sharded
    table keeps its rank's columns only)."""

    def __init__(
        self,
        table_sizes: Sequence[int],
        dim: int,
        seed: int = 0,
        capacity_hint: int = 1 << 20,
        col_start: int = 0,
    ):
        self.table_sizes = np.asarray(table_sizes, np.int64)
        self.table_offsets = np.concatenate([[0], np.cumsum(self.table_sizes)])
        self._num_rows = int(self.table_sizes.sum())
        self._dim = int(dim)
        self.seed = seed
        self._bounds = table_bounds(table_sizes)
        self._lib = hostops.load_lib()
        self._h = self._lib.overlay_create(dim, int(col_start), seed, capacity_hint)

    supports_device_init = True

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def overlay_rows(self) -> int:
        return int(self._lib.overlay_used(self._h))

    def row_bounds(self, idx: np.ndarray) -> np.ndarray:
        return row_bounds_of(self.table_offsets, self._bounds, idx)

    def gather(self, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64)
        if out is None:
            out = np.empty((idx.shape[0], self._dim), np.float32)
        if out.shape != (idx.shape[0], self._dim) or out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous (n, dim) float32 array")
        bounds = np.ascontiguousarray(self.row_bounds(idx), np.float32)
        self._lib.overlay_gather_f32(
            self._h, idx.ctypes.data, bounds.ctypes.data, out.ctypes.data, idx.shape[0]
        )
        return out

    def scatter(self, idx: np.ndarray, vals: np.ndarray) -> None:
        idx = np.ascontiguousarray(idx, np.int64)
        vals = np.ascontiguousarray(vals, np.float32)
        if vals.shape != (idx.shape[0], self._dim):
            raise ValueError(f"vals has shape {vals.shape}, expected {(idx.shape[0], self._dim)}")
        self._lib.overlay_scatter_f32(self._h, idx.ctypes.data, vals.ctypes.data, idx.shape[0])

    def written_mask(self, idx: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((idx.shape[0],), np.uint8)
        self._lib.overlay_contains(self._h, idx.ctypes.data, out.ctypes.data, idx.shape[0])
        return out.astype(np.bool_)

    def written_rows(self) -> np.ndarray:
        """Row ids that have been written back."""
        n = self.overlay_rows
        out = np.empty((n,), np.int64)
        if n:
            self._lib.overlay_keys(self._h, out.ctypes.data)
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.overlay_free(h)
            self._h = None
