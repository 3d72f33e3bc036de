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
import torch

from cachedembedding_tpu_torch import _build

_SOURCES = [Path(__file__).with_name("hostops.cpp"), Path(__file__).with_name("directory.cpp")]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

# (name, argtypes, restype) of every C entry the port calls
_PROTOTYPES = [
    ("gather_rows", [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int32], None),
    ("scatter_rows_f32", [_P, _P, _P, _I64, _I64, _I64], None),
    ("concat_minmax_i32", [_P, _P, _I64, _P, _P], None),
    ("sort_plan_i32", [_P, _I64, _I64, _I64, _P, _P, _P], None),
    ("bincount_i64", [_P, _P, _I64, _I64], None),
    ("fill_rows_canonical", [_P, _I64, _I64, _I64, ctypes.c_uint32, ctypes.c_float, _I64], None),
    ("overlay_create", [_I64, _I64, ctypes.c_uint64, _I64], _P),
    ("overlay_free", [_P], None),
    ("overlay_used", [_P], _I64),
    ("overlay_keys", [_P, _P], None),
    ("overlay_gather_rows", [_P, _P, _I64, _P, _P, _I64, _P, ctypes.c_int32], None),
    ("overlay_gather_or_fill", [_P, _P, _I64, ctypes.c_float, _P], None),
    ("overlay_contains", [_P, _P, _P, _I64], None),
    ("overlay_scatter_f32", [_P, _P, _P, _I64], None),
    ("dir_create", [_I64, _I64, ctypes.c_int], _P),
    ("dir_free", [_P], None),
    ("dir_set_dataset_freq", [_P, _P], None),
    ("dir_warmup", [_P, _P, _P, _I64], None),
    ("dir_plan", [_P, _P, _I64, _P, _P, _P, _P, _P], _I64),
    ("dir_resident", [_P, _P, _P], _I64),
    ("dir_num_free", [_P], _I64),
    ("pack_ids_u8", [_P, _I64, _I64, _P], None),
    ("escape_pack_window_i32", [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _I64], _I64),
    ("rt_state_create", [_I64, _I64, _P, _P, _P, _P, _P], _P),
    ("rt_state_free", [_P], None),
    ("rt_encode_window", [_P, _P, _I64, _I64, ctypes.c_int32, _P, _P, _P, _P, _P, _I64, _P], _I64),
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


def rows_out(out, n: int, dim: int):
    """Validate the destination of a row gather: a C-contiguous (n, dim)
    float32 array, or a C-contiguous (n, dim) float32 or bfloat16 CPU
    tensor (a new float32 array where ``out`` is None). Returns (out, its
    address, 1 where it takes bf16 rows)."""
    if out is None:
        out = np.empty((n, dim), np.float32)
    t = torch.from_numpy(out) if isinstance(out, np.ndarray) else out
    if (not isinstance(t, torch.Tensor) or t.device.type != "cpu" or t.dtype not in (torch.float32, torch.bfloat16)
            or tuple(t.shape) != (n, dim) or not t.is_contiguous()):
        raise ValueError(f"out must be a C-contiguous ({n}, {dim}) float32 array or float32/bfloat16 CPU tensor")
    return out, t.data_ptr(), int(t.dtype == torch.bfloat16)


def gather_rows(table: np.ndarray, idx: np.ndarray, out=None):
    """out[i] = table[idx[i]] for a 2-D float32 C-contiguous ``table``, by
    several workers; ``out`` as ``rows_out`` takes it, bf16 rows rounded to
    nearest even as ``Tensor.to(torch.bfloat16)`` rounds them."""
    _f32_c(table, "table")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out, ptr, bf16 = rows_out(out, idx.shape[0], table.shape[1])
    load_lib().gather_rows(table.ctypes.data, idx.ctypes.data, ptr, idx.shape[0], table.shape[1], table.shape[0],
                           bf16)
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


def concat_minmax_i32(parts, out: np.ndarray):
    """``out[:n]`` = the 1-D C-contiguous int32 arrays ``parts`` back to
    back (n ids in all), copied in one multithreaded pass that also takes
    their min and max: returns (min, max), (2**31 - 1, -2**31) for no ids."""
    for p in parts:
        if p.dtype != np.int32 or p.ndim != 1 or not p.flags.c_contiguous:
            raise ValueError("parts must be 1-D C-contiguous int32 arrays")
    lens = np.array([p.shape[0] for p in parts], np.int64)
    if out.dtype != np.int32 or out.ndim != 1 or not out.flags.c_contiguous or out.shape[0] < lens.sum():
        raise ValueError(f"out must be a 1-D C-contiguous int32 array of at least {int(lens.sum())} ids")
    ptrs = np.array([p.ctypes.data for p in parts], np.uintp)
    minmax = np.empty((2,), np.int32)
    load_lib().concat_minmax_i32(ptrs.ctypes.data, lens.ctypes.data, len(parts), out.ctypes.data,
                                 minmax.ctypes.data)
    return int(minmax[0]), int(minmax[1])


def fill_rows_canonical(buf: np.ndarray, start_row: int, seed: int, bound: float, col_start: int = 0) -> None:
    """Init rows [start_row, start_row+len(buf)) of a float32 table slab with
    the canonical generator (device-reproducible, see ops/synth_rows.py):
    columns [col_start, col_start + buf.shape[1]) of each row, bit-equal to
    slicing the full row."""
    _f32_c(buf, "buf")
    n, dim = buf.shape
    load_lib().fill_rows_canonical(
        buf.ctypes.data, start_row, n, dim,
        ctypes.c_uint32(seed & 0xFFFFFFFF), ctypes.c_float(bound), int(col_start),
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


# -- the window id wire --------------------------------------------------------


def id_pack_width(max_id_exclusive: int, n: int) -> int:
    """Smallest fixed pack width (bits) for ids in [0, max_id_exclusive): 16,
    20, 24 or 32 (unpacked). 20 packs pairs, so it needs an even n."""
    if max_id_exclusive <= (1 << 16):
        return 16
    if max_id_exclusive <= (1 << 20) and n % 2 == 0:
        return 20
    if max_id_exclusive <= (1 << 24):
        return 24
    return 32


def pack_ids(ids: np.ndarray, width_bits: int) -> np.ndarray:
    """Bit-pack non-negative int32 ids into a u8 stream at 16, 20 or 24 bits
    (20: pairs in 5 bytes, little-endian)."""
    ids = np.ascontiguousarray(ids.reshape(-1), np.int32)
    n = ids.shape[0]
    out = np.empty(({16: 2 * n, 20: 5 * (n // 2), 24: 3 * n}[width_bits],), np.uint8)
    load_lib().pack_ids_u8(ids.ctypes.data, n, width_bits, out.ctypes.data)
    return out


def nibble_width(max_id_exclusive: int, n: int) -> int:
    """Smallest nibble-aligned width (bits) for ids in [0, max_id_exclusive)
    and n elements. Odd-nibble widths (4/12/20/28) pack pairs and need an
    even n; otherwise the next byte-aligned width is taken."""
    bits = max(int(max_id_exclusive - 1).bit_length(), 1)
    w = ((bits + 3) // 4) * 4
    if w % 8 and n % 2:
        w += 4
    return min(w, 32)


def pf_nbytes(n: int, width_bits: int) -> int:
    """Byte length of n ids packed at width_bits (nibble-aligned)."""
    if (n * width_bits) % 8:
        raise ValueError(f"{n} ids at {width_bits} bits do not fill whole bytes")
    return n * width_bits // 8


def pack_ids_any(ids: np.ndarray, width_bits: int) -> np.ndarray:
    """Bit-pack non-negative int32 ids at any nibble-aligned width 4..32;
    odd-nibble widths pack pairs little-endian (two ids in w/4 bytes)."""
    ids = np.ascontiguousarray(ids.reshape(-1), np.int32)
    n = ids.shape[0]
    if width_bits == 32:
        return ids.view(np.uint8)
    if width_bits in (16, 20, 24):
        return pack_ids(ids, width_bits)
    u = ids.astype(np.uint64)
    if width_bits == 8:
        return u.astype(np.uint8)
    if width_bits not in (4, 12, 28) or n % 2:
        raise ValueError(f"cannot pack {n} ids at {width_bits} bits")
    combined = u[0::2] | (u[1::2] << np.uint64(width_bits))
    out = np.empty((n // 2, width_bits // 4), np.uint8)
    for j in range(width_bits // 4):
        out[:, j] = ((combined >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(-1)


def escape_pack_window(slot3: np.ndarray, widths, plain_widths, deltas, max_overflow: int):
    """Escape-coded pack of a (P, F, Bf) int32 window in one native call:
    feature f's block at ``widths[f]`` bits after subtracting ``deltas[f]``,
    blocks feature-major; where ``widths[f] < plain_widths[f]`` the ids that
    do not fit become (u32 flat position, i32 raw id) escapes, ordered
    (feature, p, j). Returns (bytes, escape positions, escape values), or
    None when the escapes exceed ``max_overflow``."""
    P, F, Bf = slot3.shape
    slot3 = np.ascontiguousarray(slot3, np.int32)
    w = np.ascontiguousarray(widths, np.int32)
    pw = np.ascontiguousarray(plain_widths, np.int32)
    d = np.ascontiguousarray(deltas, np.int32)
    if w.shape != (F,) or pw.shape != (F,) or d.shape != (F,):
        raise ValueError(f"widths, plain widths and deltas need one entry for each of {F} features")
    if ((w < 4) | (w > 32) | (w % 4 != 0)).any() or ((w % 8 != 0) & ((P * Bf) % 2 == 1)).any():
        raise ValueError(f"pack widths {w.tolist()} are not nibble-aligned in 4..32 for {P * Bf} ids a feature")
    offs = np.concatenate([[0], np.cumsum((P * Bf * w.astype(np.int64)) // 8)]).astype(np.int64)
    out = np.empty((int(offs[-1]),), np.uint8)
    cap = max(int(max_overflow), 1)
    opos = np.empty((cap,), np.uint32)
    oval = np.empty((cap,), np.int32)
    cnt = load_lib().escape_pack_window_i32(
        slot3.ctypes.data, P, F, Bf, w.ctypes.data, pw.ctypes.data, d.ctypes.data,
        offs.ctypes.data, out.ctypes.data, opos.ctypes.data, oval.ctypes.data, int(max_overflow),
    )
    if cnt < 0:
        return None
    return out, opos[:cnt], oval[:cnt]


class RankTierEncoder:
    """Stateful native rank-tier window encoder (the JAX package's
    ``RankTierEncoder``, with the caps given per call). ``entries`` is the
    frozen spec: ("p", w, delta, plain_w) or ("t", (w0..w3), delta, shares,
    dict_k) per feature. Rank dictionaries persist across windows in the
    native state and are re-ranked only on ``encode(..., rebuild=True)``; a
    stale dictionary still decodes exactly, since it ships with the window.
    One state serves every window size."""

    def __init__(self, entries: tuple, max_val: int):
        F = len(entries)
        ent_type = np.zeros((F,), np.int32)
        widths = np.zeros((F, 4), np.int32)
        deltas = np.zeros((F,), np.int32)
        plain_w = np.zeros((F,), np.int32)
        dict_ks = np.zeros((F,), np.int32)
        for f, ent in enumerate(entries):
            if ent[0] == "p":
                _, widths[f, 0], deltas[f], plain_w[f] = ent
            else:
                _, widths[f], deltas[f], _shares, dict_ks[f] = ent
                ent_type[f] = 1
        self._widths, self._ent_type, self._dict_ks = widths, ent_type, dict_ks
        self._lib = load_lib()
        self._handle = self._lib.rt_state_create(
            F, int(max_val), ent_type.ctypes.data, widths.ctypes.data, deltas.ctypes.data,
            plain_w.ctypes.data, dict_ks.ctypes.data,
        )
        self._F = F
        self.max_val = int(max_val)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.rt_state_free(h)
            self._handle = None

    def block_sizes(self, n: int, caps: np.ndarray) -> np.ndarray:
        """Bytes of each feature's block for n = P*Bf ids a feature."""
        plain = (n * self._widths[:, 0].astype(np.int64)) // 8
        tier = (n // 4 + 4 * self._dict_ks.astype(np.int64)
                + ((caps.astype(np.int64) * self._widths) // 8).sum(axis=1))
        return np.where(self._ent_type == 1, tier, plain)

    def encode(self, slot3: np.ndarray, caps, max_overflow: int, rebuild: bool):
        """Encode one (P, F, Bf) window with per-feature tier caps (F, 4).
        Returns (feature block bytes, escape positions u32, escape values
        i32); ("overflow", f, counts, caps) on a tier-cap overflow; or
        "esc_overflow" when the escapes exceed ``max_overflow``. The first
        call must rebuild (the dictionaries start empty). Raises on a
        dictionary feature's id outside [0, max_val)."""
        P, F, Bf = slot3.shape
        if F != self._F:
            raise ValueError(f"window has {F} features, the encoder {self._F}")
        slot3 = np.ascontiguousarray(slot3, np.int32)
        caps = np.ascontiguousarray(caps, np.int32).reshape(F, 4)
        offs = np.concatenate([[0], np.cumsum(self.block_sizes(P * Bf, caps))]).astype(np.int64)
        out = np.empty((int(offs[-1]),), np.uint8)
        cap_esc = max(int(max_overflow), 1)
        opos = np.empty((cap_esc,), np.uint32)
        oval = np.empty((cap_esc,), np.int32)
        info = np.zeros((9,), np.int32)
        cnt = self._lib.rt_encode_window(
            self._handle, slot3.ctypes.data, P, Bf, 1 if rebuild else 0, caps.ctypes.data,
            offs.ctypes.data, out.ctypes.data, opos.ctypes.data, oval.ctypes.data,
            int(max_overflow), info.ctypes.data,
        )
        if cnt == -3:
            raise ValueError(f"slot ids out of range [0, {self.max_val}) in a dictionary feature")
        if cnt == -1:
            return ("overflow", int(info[0]), [int(x) for x in info[1:5]], tuple(int(x) for x in info[5:9]))
        if cnt == -2:
            return "esc_overflow"
        return out, opos[:cnt], oval[:cnt]
