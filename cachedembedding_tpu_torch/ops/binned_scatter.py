"""Embedding backward over the host's row-sorted plan: the fused SGD update
(Kernel 2 of the port) and the binned scatter-add (Kernel 3).

Counterpart of ``cachedembedding_tpu/ops/binned_scatter.py`` (TPU kernels
``_kernel_sgd``, wrapper ``binned_sgd_update``, and ``_kernel``, wrapper
``binned_scatter_add``). The CUDA kernels are ``csrc/binned_sgd.cu`` and
``csrc/binned_scatter_add.cu``, which share the run reduction of
``csrc/row_runs.cuh`` (runs of one row, cut into chunks of ``ROW_CHUNK``
contributors, one warp per chunk); their notes say what bounds them on the
H100 and how the design answers that.

    binned_sgd_update(cw, g, perm, v_grouped, bin_starts, slr)
        == cw.at[ids].add(-slr * g)   with ids[perm] == v_grouped
    binned_scatter_add(g, perm, v_grouped, bin_starts, num_rows)
        == zeros((num_rows, D), f32).at[ids].add(g)

In the update, contributions to a row are summed in f32 and rounded to the
storage dtype once; rows nobody touched stay bit-exact. **The update is in
place**: ``cw`` is modified and returned (the JAX wrapper donates ``cw`` to
the same effect). The scatter-add returns a new f32 array, every row of it
written (untouched rows as zeros). Neither uses atomics: two launches give
the same bits.

Layout contract (host side, ``sort_plan_np``): ``perm`` (L,) int32 sorts the
id stream stably by id; ``v_grouped = ids[perm]``, ascending, so every row's
contributors are contiguous and in stream order; ``bin_starts`` (NB+1,) gives
bin b the element range ``[bin_starts[b], bin_starts[b+1])`` and the rows
``[R*b, R*(b+1))``. The bin height R is ``BLOCK_ROWS = 64``. The plan is the
JAX package's bin grouping with each bin sorted by row, so ``bin_starts`` is
equal and the JAX kernels and the plain versions take either plan. The CUDA
kernels need the sorted one (a row whose contributors were split into
several runs would be written once per run), and check it: on a plan not
sorted by id they stop with a device-side assert, which the next
synchronizing call raises as a ``RuntimeError``.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.ops import _cuda

BLOCK_ROWS = 64
ROW_CHUNK = 64  # contributors per warp in the CUDA kernels: kChunk of csrc/row_runs.cuh

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _partials(L: int, D: int, device) -> torch.Tensor:
    """Scratch of the run reduction: a head and a tail slot per chunk."""
    return torch.empty((2 * -(-L // ROW_CHUNK), D), dtype=torch.float32, device=device)


def binned_sgd_update_plain(
    cw: torch.Tensor, g: torch.Tensor, perm: torch.Tensor, v_grouped: torch.Tensor,
    bin_starts: torch.Tensor, slr: float,
) -> torch.Tensor:
    """Plain PyTorch version (in place): f32 sums over the grouped stream, one
    rounding per touched row. ``bin_starts`` is implied by ``v_grouped``."""
    del bin_starts
    ids = v_grouped.long()
    acc = torch.zeros(cw.shape, dtype=torch.float32, device=cw.device)
    acc.index_add_(0, ids, g.index_select(0, perm.long()).float())
    touched = torch.unique(ids)
    new = cw.index_select(0, touched).float() - slr * acc.index_select(0, touched)
    cw.index_copy_(0, touched, new.to(cw.dtype))
    return cw


def binned_sgd_update(
    cw: torch.Tensor,          # (C, D) cache rows, updated in place
    g: torch.Tensor,           # (L, D) row grads in stream order, cw's dtype
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    bin_starts: torch.Tensor,  # (NB+1,) int32 over ceil(C / BLOCK_ROWS) bins
    slr: float,                # sparse learning rate
) -> torch.Tensor:
    """cw[ids] -= slr * g, duplicates summed in f32, one rounding per row."""
    C, D = cw.shape
    L = g.shape[0]
    nb = -(-C // BLOCK_ROWS)
    if g.shape != (L, D) or perm.shape != (L,) or v_grouped.shape != (L,):
        raise ValueError("binned_sgd_update: g (L, D), perm (L,) and v_grouped (L,) must agree")
    if bin_starts.shape != (nb + 1,):
        raise ValueError(f"bin_starts has shape {tuple(bin_starts.shape)}, expected ({nb + 1},)")
    if g.dtype != cw.dtype:
        raise ValueError(f"g is {g.dtype}, cw is {cw.dtype}: cast the grads to the cache dtype")
    tensors = (cw, g, perm, v_grouped, bin_starts)
    if all(t.device.type == "cpu" for t in tensors):
        return binned_sgd_update_plain(cw, g, perm, v_grouped, bin_starts, float(slr))
    if any(t.device != cw.device for t in tensors) or cw.device.type != "cuda":
        raise ValueError("binned_sgd_update: all tensors must be on the same CUDA device")
    if cw.dtype not in _DTYPE_CODES:
        raise ValueError(f"binned_sgd_update supports float32 and bfloat16 rows, not {cw.dtype}")
    if any(t.dtype != torch.int32 for t in (perm, v_grouped, bin_starts)):
        raise ValueError("perm, v_grouped and bin_starts must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binned_sgd_update needs contiguous tensors")
    rc = _cuda.kernel_entry("binned_sgd")(
        cw.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(),
        _partials(L, D, cw.device).data_ptr(), L, D, float(slr),
        _DTYPE_CODES[cw.dtype], _cuda.stream_of(cw),
    )
    _cuda.check_launch("binned_sgd", rc)
    binned_sgd_update.launches += 1
    return cw


binned_sgd_update.launches = 0


def binned_scatter_add_plain(
    g: torch.Tensor, perm: torch.Tensor, v_grouped: torch.Tensor, bin_starts: torch.Tensor,
    num_rows: int,
) -> torch.Tensor:
    """Plain PyTorch version: f32 sums over the grouped stream. ``bin_starts``
    is implied by ``v_grouped``."""
    del bin_starts
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, v_grouped.long(), g.index_select(0, perm.long()).float())


def binned_scatter_add(
    g: torch.Tensor,           # (L, D) row grads in stream order, f32 or bf16
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    bin_starts: torch.Tensor,  # (NB+1,) int32 over ceil(num_rows / BLOCK_ROWS) bins
    num_rows: int,
) -> torch.Tensor:
    """(num_rows, D) f32 grad: zeros.at[ids].add(g), duplicates summed in f32."""
    L, D = g.shape
    num_rows = int(num_rows)
    nb = -(-num_rows // BLOCK_ROWS)
    if perm.shape != (L,) or v_grouped.shape != (L,):
        raise ValueError("binned_scatter_add: g (L, D), perm (L,) and v_grouped (L,) must agree")
    if bin_starts.shape != (nb + 1,):
        raise ValueError(f"bin_starts has shape {tuple(bin_starts.shape)}, expected ({nb + 1},)")
    tensors = (g, perm, v_grouped, bin_starts)
    if all(t.device.type == "cpu" for t in tensors):
        return binned_scatter_add_plain(g, perm, v_grouped, bin_starts, num_rows)
    if any(t.device != g.device for t in tensors) or g.device.type != "cuda":
        raise ValueError("binned_scatter_add: all tensors must be on the same CUDA device")
    if g.dtype not in _DTYPE_CODES:
        raise ValueError(f"binned_scatter_add takes float32 and bfloat16 grads, not {g.dtype}")
    if any(t.dtype != torch.int32 for t in (perm, v_grouped, bin_starts)):
        raise ValueError("perm, v_grouped and bin_starts must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binned_scatter_add needs contiguous tensors")
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    rc = _cuda.kernel_entry("binned_scatter_add")(
        out.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(),
        _partials(L, D, g.device).data_ptr(), L, num_rows, D,
        _DTYPE_CODES[g.dtype], _cuda.stream_of(g),
    )
    _cuda.check_launch("binned_scatter_add", rc)
    binned_scatter_add.launches += 1
    return out


binned_scatter_add.launches = 0


def sort_plan_np(v: np.ndarray, num_rows: int):
    """Host-side plan for one step's id stream over ``num_rows`` device rows:
    (perm, ids_grouped, bin_starts), the stream stably sorted by id, with the
    bins of BLOCK_ROWS rows (``hostops.sort_plan``)."""
    return hostops.sort_plan(v, num_rows, BLOCK_ROWS)
