"""The update of the JAX trainer's sparse-gradient branch: an ordered
scatter-add into rows of the storage dtype (Kernel 5 of the port).

Counterpart of ``cw.at[v].add((-slr * g.astype(f32)).astype(cw.dtype))`` in
``cachedembedding_tpu/train/trainer.py`` (``_scan_window``), which XLA lowers
to a scatter whose combiner adds in the rows' dtype: every addend is rounded
to that dtype, and so is the row after each add, in stream order. No Pallas
kernel is involved; the port has a CUDA kernel (``csrc/ordered_scatter_add.cu``)
because no PyTorch call computes the ordered function: ``index_add_`` adds
with atomics on CUDA, in an order that changes from launch to launch, and
has no fp8.

    ordered_scatter_add_(cw, g, perm, v_grouped, slr)
        for i in stream order:  cw[v_i] = round(cw[v_i] + round(-slr * g[i]))

with ``round`` the cast to ``cw.dtype`` as ``jnp.astype`` casts it
(``ops/rounding.astype_storage``) and ``g`` in ``cw``'s dtype (f32, bf16,
float8_e4m3fn or float8_e5m2). In bf16, 1000 addends of 1.0 into a zero row
give 256: past 256 a bf16 step is 2, and 256 + 1 rounds back to 256.

The plan is the update's ``sort_plan_np`` (``ops/binned_scatter.py``): the
stream sorted stably by row, so each row's contributors are one run in
stream order. The kernel walks each run with one warp, in order, in
registers, with no atomics: it gives the plain version's bits, and the same
bits on every launch. On a plan not sorted by id it stops with a
device-side assert.

On a CPU tensor the wrapper runs the plain PyTorch version, which applies the
k-th contributor of every row in one indexed write, for k = 0, 1, ...; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cachedembedding_tpu_torch.ops import _cuda
from cachedembedding_tpu_torch.ops.rounding import astype_storage, index_copy_storage_, index_select_f32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


def occurrence_rank(v_grouped: torch.Tensor) -> torch.Tensor:
    """Each element's rank among its row's contributors in a sorted stream."""
    L = v_grouped.shape[0]
    pos = torch.arange(L, device=v_grouped.device)
    start = torch.ones(L, dtype=torch.bool, device=v_grouped.device)
    start[1:] = v_grouped[1:] != v_grouped[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)), dim=0).values
    return pos - first


def ordered_scatter_add_plain(
    cw: torch.Tensor, g: torch.Tensor, perm: torch.Tensor, v_grouped: torch.Tensor, slr: float,
) -> torch.Tensor:
    """Plain PyTorch version (in place): the addends rounded to cw's dtype,
    then applied rank by rank, each add rounded."""
    ids = v_grouped.long()
    a = astype_storage(g.index_select(0, perm.long()).float() * -slr, cw.dtype).float()
    rank = occurrence_rank(v_grouped)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = torch.nonzero(rank == k)[:, 0]
        rows = ids.index_select(0, sel)
        index_copy_storage_(cw, rows, index_select_f32(cw, rows) + a.index_select(0, sel))
    return cw


def ordered_scatter_add_(
    cw: torch.Tensor,          # (C, D) rows, updated in place
    g: torch.Tensor,           # (L, D) row grads in stream order, cw's dtype
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream stably by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    slr: float,                # sparse learning rate
) -> torch.Tensor:
    """cw[v_i] = round(cw[v_i] + round(-slr * g[i])) in stream order; returns cw."""
    C, D = cw.shape
    L = g.shape[0]
    if g.shape != (L, D) or perm.shape != (L,) or v_grouped.shape != (L,):
        raise ValueError("ordered_scatter_add_: g (L, D), perm (L,) and v_grouped (L,) must agree")
    if g.dtype != cw.dtype:
        raise ValueError(f"g is {g.dtype}, cw is {cw.dtype}: the sparse branch takes grads in the rows' dtype")
    tensors = (cw, g, perm, v_grouped)
    if all(t.device.type == "cpu" for t in tensors):
        return ordered_scatter_add_plain(cw, g, perm, v_grouped, float(slr))
    if any(t.device != cw.device for t in tensors) or cw.device.type != "cuda":
        raise ValueError("ordered_scatter_add_: all tensors must be on the same CUDA device")
    if cw.dtype not in _DTYPE_CODES:
        raise ValueError(f"ordered_scatter_add_ supports float32, bfloat16 and fp8 rows, not {cw.dtype}")
    if any(t.dtype != torch.int32 for t in (perm, v_grouped)):
        raise ValueError("perm and v_grouped must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ordered_scatter_add_ needs contiguous tensors")
    rc = _cuda.kernel_entry("ordered_scatter_add")(
        cw.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(), L, D, -float(slr),
        _DTYPE_CODES[cw.dtype], _cuda.stream_of(cw),
    )
    _cuda.check_launch("ordered_scatter_add", rc)
    ordered_scatter_add_.launches += 1
    return cw


ordered_scatter_add_.launches = 0
