"""Host-DRAM staging ops over the port's own native library.

Counterpart of ``cachedembedding_tpu/_native/hostops.py``. The C++ sources
beside this file (``hostops.cpp``, ``directory.cpp``) are the port's copy of
the functions the cached-training slice calls. They are built at first use
with ``g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread`` into
``cachedembedding_tpu_torch/build/`` (see ``_build.py``). Unlike the JAX
package, there is no numpy fallback: if the build fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from cachedembedding_tpu_torch import _build

_SOURCES = [Path(__file__).with_name("hostops.cpp"), Path(__file__).with_name("directory.cpp")]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

# (name, argtypes, restype) of every C entry the port calls
_PROTOTYPES = [
    ("gather_rows_f32", [_P, _P, _P, _I64, _I64, _I64], None),
    ("scatter_rows_f32", [_P, _P, _P, _I64, _I64, _I64], None),
    ("sort_plan_i32", [_P, _I64, _I64, _I64, _P, _P, _P], None),
    ("bincount_i64", [_P, _P, _I64, _I64], None),
    ("fill_rows_canonical", [_P, _I64, _I64, _I64, ctypes.c_uint32, ctypes.c_float], None),
    ("overlay_create", [_I64, ctypes.c_uint64, _I64], _P),
    ("overlay_free", [_P], None),
    ("overlay_used", [_P], _I64),
    ("overlay_keys", [_P, _P], None),
    ("overlay_gather_f32", [_P, _P, _P, _P, _I64], None),
    ("overlay_contains", [_P, _P, _P, _I64], None),
    ("overlay_scatter_f32", [_P, _P, _P, _I64], None),
    ("dir_create", [_I64, _I64, ctypes.c_int], _P),
    ("dir_free", [_P], None),
    ("dir_set_dataset_freq", [_P, _P], None),
    ("dir_warmup", [_P, _P, _P, _I64], None),
    ("dir_plan", [_P, _P, _I64, _P, _P, _P, _P, _P], _I64),
    ("dir_resident", [_P, _P, _P], _I64),
    ("dir_num_free", [_P], _I64),
]


def build_lib():
    """Build (if needed) the host library; returns (path, seconds, output)."""
    return _build.build("libhostops", _SOURCES, _build.gxx_command)


@functools.lru_cache(maxsize=None)
def load_lib() -> ctypes.CDLL:
    """The host library, built at first use. Raises if the build fails."""
    path, _, _ = build_lib()
    lib = ctypes.CDLL(str(path))
    for name, argtypes, restype in _PROTOTYPES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _f32_c(a: np.ndarray, name: str) -> None:
    if a.dtype != np.float32 or not a.flags.c_contiguous or a.ndim != 2:
        raise ValueError(f"{name} must be a C-contiguous 2-D float32 array")


def gather_rows(table: np.ndarray, idx: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """out[i] = table[idx[i]] for a 2-D float32 C-contiguous ``table``."""
    _f32_c(table, "table")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if out is None:
        out = np.empty((idx.shape[0], table.shape[1]), dtype=np.float32)
    _f32_c(out, "out")
    if out.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"out has shape {out.shape}, expected {(idx.shape[0], table.shape[1])}")
    load_lib().gather_rows_f32(
        table.ctypes.data, idx.ctypes.data, out.ctypes.data,
        idx.shape[0], table.shape[1], table.shape[0],
    )
    return out


def scatter_rows(table: np.ndarray, idx: np.ndarray, values: np.ndarray) -> None:
    """table[idx[i]] = values[i] (idx must hold no duplicates)."""
    _f32_c(table, "table")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float32)
    if values.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"values has shape {values.shape}, expected {(idx.shape[0], table.shape[1])}")
    load_lib().scatter_rows_f32(
        table.ctypes.data, idx.ctypes.data, values.ctypes.data,
        idx.shape[0], table.shape[1], table.shape[0],
    )


def fill_rows_canonical(buf: np.ndarray, start_row: int, seed: int, bound: float) -> None:
    """Init rows [start_row, start_row+len(buf)) of a float32 table slab with
    the canonical generator (device-reproducible, see ops/synth_rows.py)."""
    _f32_c(buf, "buf")
    n, dim = buf.shape
    load_lib().fill_rows_canonical(
        buf.ctypes.data, start_row, n, dim,
        ctypes.c_uint32(seed & 0xFFFFFFFF), ctypes.c_float(bound),
    )


def sort_plan(ids: np.ndarray, num_rows: int, block_rows: int):
    """Plan of the embedding update kernels: (perm, ids_grouped, bin_starts)
    with the id stream stably sorted by id (so every row's contributors are
    contiguous and in stream order), by a native LSD radix sort whose cost
    follows the ids, not ``num_rows``. ``bin_starts`` gives bin b the range of ids in
    [b * block_rows, (b + 1) * block_rows), as in the JAX package's
    bin-grouping plan."""
    ids = np.ascontiguousarray(ids.reshape(-1), dtype=np.int32)
    n = ids.shape[0]
    if n and (int(ids.min()) < 0 or int(ids.max()) >= num_rows):
        raise ValueError(f"ids out of range [0, {num_rows})")
    nb = -(-num_rows // block_rows)
    perm = np.empty((n,), np.int32)
    grouped = np.empty((n,), np.int32)
    bin_starts = np.empty((nb + 1,), np.int32)
    load_lib().sort_plan_i32(
        ids.ctypes.data, n, num_rows, block_rows,
        perm.ctypes.data, grouped.ctypes.data, bin_starts.ctypes.data,
    )
    return perm, grouped, bin_starts


def bincount(ids: np.ndarray, num_rows: int, out: np.ndarray | None = None) -> np.ndarray:
    """Accumulating int64 bincount: ``out[id] += 1`` for every id in
    ``[0, num_rows)``; ids outside the range are skipped."""
    if out is None:
        out = np.zeros((num_rows,), dtype=np.int64)
    if out.dtype != np.int64 or not out.flags.c_contiguous or out.shape != (num_rows,):
        raise ValueError(f"out must be a C-contiguous ({num_rows},) int64 array")
    ids = np.ascontiguousarray(ids.reshape(-1), dtype=np.int64)
    load_lib().bincount_i64(ids.ctypes.data, out.ctypes.data, ids.shape[0], num_rows)
    return out
