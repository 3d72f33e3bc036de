"""Lazy device-side materialization of never-trained embedding rows
(counterpart of ``cachedembedding_tpu/ops/synth_rows.py``).

Embedding init is a pure function of (global row id, column, seed): per-table
U(-1/sqrt(n), 1/sqrt(n)) from a 32-bit hash. The host master table and the
GPU therefore agree on the init value of any row that has never been trained,
so admitting such a row needs no host->device transfer: the GPU synthesizes it
from the row id.

Bit-exact with ``gen_row_canonical`` in ``_native/hostops.cpp`` and with the
JAX package's ``synth_rows``. torch has weak uint32 arithmetic, so the hash
runs in int64 with ``& 0xFFFFFFFF`` after every multiply: the low 32 bits of a
product survive int64 wraparound.

The last step, ``(h >> 8) * scale - bound``, is one fused multiply-add with a
single rounding: that is what the JAX package's generators compute (g++ with
``-march=native`` and XLA on the CPU both contract it to an FMA; its numpy
fallback, which rounds twice, differs from them in about half the values).
The port's C++ calls ``std::fma`` and this module computes the exact value in
float64 — ``(h >> 8) * scale`` is exact there, and so is the subtraction —
then rounds once to float32, which is the FMA's result.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The canonical 32-bit hash on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def synth_rows(
    rows: torch.Tensor,    # (n,) integer global row ids (>= 0)
    bounds: torch.Tensor,  # (n,) float32 per-row init bound (1/sqrt(table_size))
    seed: int,
    dim: int,
) -> torch.Tensor:
    """(n, dim) float32 == the canonical host generator's rows."""
    dev = rows.device
    r = rows.to(torch.int64) & _M32
    h0 = _mix32((r * 0x9E3779B1 + (seed & _M32)) & _M32)
    j = (torch.arange(dim, dtype=torch.int64, device=dev) * 0x85EBCA77 + 1) & _M32
    h = _mix32(h0[:, None] ^ j[None, :])
    b = bounds.to(torch.float32)
    scale = (2.0 * b) * (1.0 / 16777216.0)  # exact: powers of two
    v = (h >> 8).to(torch.float64) * scale.double()[:, None] - b.double()[:, None]
    return v.to(torch.float32)  # one rounding: fma(h >> 8, scale, -bound)


def scatter_synth_admits(
    cache_weight: torch.Tensor,
    slots: torch.Tensor,   # (n,) destination slots
    rows: torch.Tensor,    # (n,) global row ids
    bounds: torch.Tensor,  # (n,) float32
    seed: int,
    chunk: int = 1 << 17,
) -> None:
    """Admit never-trained rows: generate on the device, land them in their
    cache slots in place. Chunked to bound the (n, D) int64 hash transients."""
    D = cache_weight.shape[1]
    for s in range(0, rows.shape[0], chunk):
        e = min(s + chunk, rows.shape[0])
        vals = synth_rows(rows[s:e], bounds[s:e], seed, D)
        cache_weight.index_copy_(0, slots[s:e], vals.to(cache_weight.dtype))
