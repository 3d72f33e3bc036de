"""Host-authoritative cache directory — the native planner behind prepare_ids
(counterpart of ``cachedembedding_tpu/cache/host_directory.py``).

All cache bookkeeping (unique over the id stream, hit/miss split, LFU or
dataset-frequency victim selection, id->slot remap) runs in multithreaded C++
on the host (``_native/directory.cpp``), while the GPU only executes dense
work. The plan for window k+1 is computed on host CPUs while the GPU executes
window k, and no device readback is ever on the critical path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.state import EvictionStrategy


class HostPlan(NamedTuple):
    """Result of one directory window (already-applied state transition)."""

    slot_ids: np.ndarray    # (L,) int32 — ids remapped to cache-slot space
    admit_rows: np.ndarray  # (n_miss,) int64 — rows to copy host->device
    admit_slots: np.ndarray  # (n_miss,) int32 — destination slots
    evict_rows: np.ndarray  # (n_miss,) int64 — previous occupants (-1 = empty)
    n_unique: int
    n_hit_unique: int
    n_hit_weighted: int
    n_ids: int


class CapacityError(RuntimeError):
    pass


class HostDirectory:
    """ctypes wrapper over the native directory."""

    def __init__(
        self,
        num_rows: int,
        capacity: int,
        strategy: EvictionStrategy = EvictionStrategy.LFU,
    ):
        self._lib = hostops.load_lib()
        self.num_rows = int(num_rows)
        self.capacity = int(capacity)
        self.strategy = strategy
        self._h = self._lib.dir_create(
            self.num_rows, self.capacity, 0 if strategy == EvictionStrategy.LFU else 1
        )
        # reusable plan output buffers
        self._admit_rows = np.empty((self.capacity,), np.int64)
        self._admit_slots = np.empty((self.capacity,), np.int32)
        self._evict_rows = np.empty((self.capacity,), np.int64)
        self._stats = np.empty((6,), np.int64)

    def set_dataset_freq(self, freq: np.ndarray) -> None:
        freq = np.ascontiguousarray(freq, np.int64)
        if freq.shape != (self.num_rows,):
            raise ValueError(f"freq has shape {freq.shape}, expected ({self.num_rows},)")
        self._lib.dir_set_dataset_freq(self._h, freq.ctypes.data)

    def warmup(self, rows: np.ndarray, freqs: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, np.int64)
        freqs = np.ascontiguousarray(freqs, np.int64)
        if rows.shape != freqs.shape or rows.shape[0] > self.capacity:
            raise ValueError("warmup rows/freqs must match and fit the capacity")
        self._lib.dir_warmup(self._h, rows.ctypes.data, freqs.ctypes.data, rows.shape[0])

    def plan(self, ids: np.ndarray) -> HostPlan:
        ids = np.ascontiguousarray(ids, np.int32)
        L = ids.shape[0]
        slot_ids = np.empty((L,), np.int32)
        n_miss = self._lib.dir_plan(
            self._h, ids.ctypes.data, L, slot_ids.ctypes.data,
            self._admit_rows.ctypes.data, self._admit_slots.ctypes.data,
            self._evict_rows.ctypes.data, self._stats.ctypes.data,
        )
        s = self._stats
        if n_miss < 0:
            if s[5] == 2:
                raise ValueError(
                    f"id out of range at position {s[1]}: {s[2]} not in "
                    f"[0, {self.num_rows}) — check table-size/hash configuration"
                )
            raise CapacityError(
                f"cache capacity exhausted: working set needs {s[0]} new slots on "
                f"top of {s[2]} protected hits but capacity is {self.capacity}. "
                f"Reduce prefetch_num/batch or raise cache_ratio."
            )
        return HostPlan(
            slot_ids=slot_ids,
            admit_rows=self._admit_rows[:n_miss].copy(),
            admit_slots=self._admit_slots[:n_miss].copy(),
            evict_rows=self._evict_rows[:n_miss].copy(),
            n_unique=int(s[1]),
            n_hit_unique=int(s[2]),
            n_hit_weighted=int(s[3]),
            n_ids=L,
        )

    def resident(self) -> tuple[np.ndarray, np.ndarray]:
        """(slots, rows) of every resident row — for flush."""
        slots = np.empty((self.capacity,), np.int32)
        rows = np.empty((self.capacity,), np.int64)
        n = self._lib.dir_resident(self._h, slots.ctypes.data, rows.ctypes.data)
        return slots[:n], rows[:n]

    @property
    def num_free(self) -> int:
        return int(self._lib.dir_num_free(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dir_free(h)
            self._h = None


def make_directory(num_rows: int, capacity: int, strategy: EvictionStrategy) -> HostDirectory:
    """The native directory (the port has no numpy fallback planner)."""
    return HostDirectory(num_rows, capacity, strategy)
