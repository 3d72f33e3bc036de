"""Fused embedding backward + SGD update — Kernel 2 of the port.

Counterpart of ``cachedembedding_tpu/ops/binned_scatter.py`` (TPU kernel
``_kernel_sgd``, wrapper ``binned_sgd_update``). The CUDA kernel is
``csrc/binned_sgd.cu``; its note says what bounds it on the H100 and how the
design answers that.

    binned_sgd_update(cw, g, perm, v_grouped, bin_starts, slr)
        == cw.at[ids].add(-slr * g)   with ids[perm] == v_grouped

Contributions to a row are summed in f32 and rounded to the storage dtype
once; rows nobody touched stay bit-exact. **The update is in place**: ``cw``
is modified and returned (the JAX wrapper donates ``cw`` to the same effect).

Layout contract (host side, ``sort_plan_np``): ``perm`` (L,) int32 groups the
id stream stably by ``id // BLOCK_ROWS``; ``v_grouped = ids[perm]``;
``bin_starts`` (NB+1,) gives bin b the element range
``[bin_starts[b], bin_starts[b+1])`` and the rows ``[R*b, R*(b+1))``. The bin
height R is ``BLOCK_ROWS = 64``, shared by the plan and the kernel (the JAX
package's 512-row f32 tile would not fit a Hopper block's shared memory).

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.ops import _cuda

BLOCK_ROWS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    perm: torch.Tensor,        # (L,) int32 grouping permutation
    v_grouped: torch.Tensor,   # (L,) int32 bin-grouped ids
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
    launch = _cuda.kernel_entry("binned_sgd")
    rc = launch(
        cw.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(),
        bin_starts.data_ptr(), nb, D, BLOCK_ROWS, float(slr), _DTYPE_CODES[cw.dtype],
        _cuda.stream_of(cw),
    )
    _cuda.check_launch("binned_sgd", rc)
    binned_sgd_update.launches += 1
    return cw


binned_sgd_update.launches = 0


def sort_plan_np(v: np.ndarray, num_rows: int):
    """Host-side plan for one step's id stream over ``num_rows`` device rows:
    (perm, ids_grouped, bin_starts), the stream stably grouped by
    (id // BLOCK_ROWS), by the native two-pass counting sort."""
    return hostops.sort_plan(v, num_rows, BLOCK_ROWS)
