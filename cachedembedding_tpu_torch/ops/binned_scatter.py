"""Embedding backward over the host's row-sorted plan: the fused SGD and
row-wise Adagrad updates (Kernel 2 of the port) and the binned scatter-add
(Kernel 3).

Counterpart of ``cachedembedding_tpu/ops/binned_scatter.py`` (TPU kernels
``_kernel_sgd``, wrapper ``binned_sgd_update``, and ``_kernel``, wrapper
``binned_scatter_add``), and of the row-wise Adagrad update that the JAX
trainer computes on the (C, D) f32 grad (``_scan_window``). The CUDA kernels
are ``csrc/binned_sgd.cu`` and ``csrc/binned_scatter_add.cu``, which share the
run reduction of ``csrc/row_runs.cuh`` (runs of one row, cut into chunks of
``ROW_CHUNK`` contributors, one warp per chunk); their notes say what bounds
them on the H100 and how the design answers that.

    binned_sgd_update(cw, g, perm, v_grouped, bin_starts, slr)
        == cw.at[ids].add(-slr * g)   with ids[perm] == v_grouped
    binned_adagrad_update(cw, accum, g, perm, v_grouped, bin_starts, slr, eps)
        == with s = zeros((C, D), f32).at[ids].add(g):
           accum += mean(s * s, axis=1); cw -= slr * s / (sqrt(accum) + eps)
    binned_scatter_add(g, perm, v_grouped, bin_starts, num_rows)
        == zeros((num_rows, D), f32).at[ids].add(g)

In the updates, contributions to a row are summed in f32 and rounded to the
storage dtype once, as ``jnp.astype`` rounds (``ops/rounding.astype_storage``);
rows nobody touched, and their accumulators, stay bit-exact. Rows are f32,
bf16, float8_e4m3fn or float8_e5m2; the grads have the rows' dtype or are
f32. **The updates are in place**: ``cw`` (and ``accum``) are modified and
``cw`` is returned (the JAX wrapper donates ``cw`` to the same effect). The
scatter-add returns a new f32 array, every row of it written (untouched rows
as zeros). None uses atomics: two launches give the same bits. The Adagrad
update takes each row's mean square in one warp, so on the card it needs D
<= 128 (D <= 32 where D is not a multiple of 4).

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

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.ops import _cuda
from cachedembedding_tpu_torch.ops.rounding import index_copy_storage_, index_select_f32

BLOCK_ROWS = 64
ROW_CHUNK = 64  # contributors per warp in the CUDA kernels: kChunk of csrc/row_runs.cuh

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}  # Kernel 3's grads


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
    new = index_select_f32(cw, touched) - slr * acc.index_select(0, touched)
    index_copy_storage_(cw, touched, new)
    return cw


def binned_adagrad_update_plain(
    cw: torch.Tensor, accum: torch.Tensor, g: torch.Tensor, perm: torch.Tensor,
    v_grouped: torch.Tensor, bin_starts: torch.Tensor, slr: float, eps: float,
) -> torch.Tensor:
    """Plain PyTorch version (in place on ``cw`` and ``accum``): the JAX
    trainer's formula over the whole (C, D) f32 grad. Untouched rows have a
    zero grad, so they and their accumulators come out unchanged."""
    g32 = binned_scatter_add_plain(g, perm, v_grouped, bin_starts, cw.shape[0])
    accum.add_(torch.mean(g32 * g32, dim=1))
    g32 = g32 / (torch.sqrt(accum) + eps)[:, None]
    index_copy_storage_(cw, torch.arange(cw.shape[0], device=cw.device), cw.float() - slr * g32)
    return cw


def _check_update_args(name, cw, g, perm, v_grouped, bin_starts):
    C, D = cw.shape
    L = g.shape[0]
    nb = -(-C // BLOCK_ROWS)
    if g.shape != (L, D) or perm.shape != (L,) or v_grouped.shape != (L,):
        raise ValueError(f"{name}: g (L, D), perm (L,) and v_grouped (L,) must agree")
    if bin_starts.shape != (nb + 1,):
        raise ValueError(f"bin_starts has shape {tuple(bin_starts.shape)}, expected ({nb + 1},)")
    if g.dtype not in (cw.dtype, torch.float32):
        raise ValueError(f"g is {g.dtype}, cw is {cw.dtype}: cast the grads to the rows' dtype or to float32")


def _launch_kernel2(name, cw, g, accum, perm, v_grouped, slr, eps) -> None:
    """One call of csrc/binned_sgd.cu (accum None: the SGD epilogue)."""
    tensors = [t for t in (cw, g, accum, perm, v_grouped) if t is not None]
    if any(t.device != cw.device for t in tensors) or cw.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on the same CUDA device")
    if cw.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} supports float32, bfloat16 and fp8 rows, not {cw.dtype}")
    if any(t.dtype != torch.int32 for t in (perm, v_grouped)):
        raise ValueError("perm, v_grouped and bin_starts must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    L, D = g.shape
    rc = _cuda.kernel_entry("binned_sgd")(
        cw.data_ptr(), g.data_ptr(), 0 if accum is None else accum.data_ptr(), perm.data_ptr(),
        v_grouped.data_ptr(), _partials(L, D, cw.device).data_ptr(), L, D, float(slr), float(eps),
        _DTYPE_CODES[cw.dtype], _DTYPE_CODES[g.dtype], _cuda.stream_of(cw),
    )
    _cuda.check_launch(name, rc)


def binned_sgd_update(
    cw: torch.Tensor,          # (C, D) cache rows, updated in place
    g: torch.Tensor,           # (L, D) row grads in stream order, cw's dtype or f32
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    bin_starts: torch.Tensor,  # (NB+1,) int32 over ceil(C / BLOCK_ROWS) bins
    slr: float,                # sparse learning rate
) -> torch.Tensor:
    """cw[ids] -= slr * g, duplicates summed in f32, one rounding per row."""
    _check_update_args("binned_sgd_update", cw, g, perm, v_grouped, bin_starts)
    if all(t.device.type == "cpu" for t in (cw, g, perm, v_grouped, bin_starts)):
        return binned_sgd_update_plain(cw, g, perm, v_grouped, bin_starts, float(slr))
    if bin_starts.dtype != torch.int32 or bin_starts.device != cw.device:
        raise ValueError("bin_starts must be int32 on the rows' device")
    _launch_kernel2("binned_sgd_update", cw, g, None, perm, v_grouped, slr, 0.0)
    binned_sgd_update.launches += 1
    return cw


binned_sgd_update.launches = 0


def binned_adagrad_update(
    cw: torch.Tensor,          # (C, D) cache rows, updated in place
    accum: torch.Tensor,       # (C,) f32 row-wise Adagrad accumulators, updated in place
    g: torch.Tensor,           # (L, D) row grads in stream order, cw's dtype or f32
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    bin_starts: torch.Tensor,  # (NB+1,) int32 over ceil(C / BLOCK_ROWS) bins
    slr: float,                # sparse learning rate
    eps: float,                # Adagrad's epsilon
) -> torch.Tensor:
    """Row-wise Adagrad on the f32 duplicate sums s of each touched row:
    accum += mean(s * s); cw -= slr * s / (sqrt(accum) + eps), one rounding
    per row. Kernel 2 with its Adagrad epilogue."""
    _check_update_args("binned_adagrad_update", cw, g, perm, v_grouped, bin_starts)
    if accum.shape != (cw.shape[0],) or accum.dtype != torch.float32:
        raise ValueError(f"accum must be ({cw.shape[0]},) float32, not {tuple(accum.shape)} {accum.dtype}")
    if all(t.device.type == "cpu" for t in (cw, accum, g, perm, v_grouped, bin_starts)):
        return binned_adagrad_update_plain(cw, accum, g, perm, v_grouped, bin_starts, float(slr), float(eps))
    if bin_starts.dtype != torch.int32 or bin_starts.device != cw.device:
        raise ValueError("bin_starts must be int32 on the rows' device")
    D = cw.shape[1]
    if D > 128 or (D % 4 and D > 32):
        raise ValueError(f"binned_adagrad_update takes each row in one warp: D <= 128 (D <= 32 where D is "
                         f"not a multiple of 4), not {D}")
    _launch_kernel2("binned_adagrad_update", cw, g, accum, perm, v_grouped, slr, eps)
    binned_adagrad_update.launches += 1
    return cw


binned_adagrad_update.launches = 0


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
    if g.dtype not in _GRAD_CODES:
        raise ValueError(f"binned_scatter_add takes float32 and bfloat16 grads, not {g.dtype}")
    if any(t.dtype != torch.int32 for t in (perm, v_grouped, bin_starts)):
        raise ValueError("perm, v_grouped and bin_starts must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("binned_scatter_add needs contiguous tensors")
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    rc = _cuda.kernel_entry("binned_scatter_add")(
        out.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(),
        _partials(L, D, g.device).data_ptr(), L, num_rows, D,
        _GRAD_CODES[g.dtype], _cuda.stream_of(g),
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
