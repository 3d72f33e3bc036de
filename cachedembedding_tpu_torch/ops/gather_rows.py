"""Row gather into the (N, F, D) layout — Kernel 1 of the port.

Counterpart of ``cachedembedding_tpu/ops/pallas_bag.py`` (TPU kernel
``_gather_kernel``, wrapper ``gather_rows_pallas``). The CUDA kernel is
``csrc/gather_rows.cu``; its note says what bounds it on the H100 and how the
design answers that.

    gather_rows(weight, ids, F)[n, f] == weight[ids[f * N + n]]

with ``ids`` the feature-major (F, N) stream of one batch. F == 1 is the flat
gather ``weight[ids]`` of ``gather_rows_pallas``. On a CPU tensor the wrapper
runs the plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.

The gradient with respect to the gathered rows is taken by the trainer, which
feeds it to the fused update (ops/binned_scatter.py), so no backward is
defined here (the TPU wrapper's XLA scatter backward is not on this path).
"""

from __future__ import annotations

import torch

from cachedembedding_tpu_torch.ops import _cuda


def gather_rows_plain(weight: torch.Tensor, ids: torch.Tensor, num_features: int = 1) -> torch.Tensor:
    """Plain PyTorch version: (N, F, D) rows of ``weight`` for feature-major ids."""
    F = num_features
    N = ids.shape[0] // F
    ids_nf = ids.reshape(F, N).t().reshape(-1).long()
    return weight.index_select(0, ids_nf).reshape(N, F, weight.shape[1])


def gather_rows(weight: torch.Tensor, ids: torch.Tensor, num_features: int = 1) -> torch.Tensor:
    """(N, F, D) gather of feature-major ``ids`` (L = F*N,) from ``weight`` (C, D).
    The caller guarantees ids in [0, C) (the cache plans them)."""
    if weight.dim() != 2 or ids.dim() != 1:
        raise ValueError("gather_rows expects weight (C, D) and ids (L,)")
    F = int(num_features)
    if F < 1 or ids.shape[0] % F:
        raise ValueError(f"ids length {ids.shape[0]} is not a multiple of num_features={F}")
    if weight.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_plain(weight, ids, F)
    if weight.device.type != "cuda" or ids.device != weight.device:
        raise ValueError("weight and ids must be on the same CUDA device")
    if ids.dtype != torch.int32 or not ids.is_contiguous() or not weight.is_contiguous():
        raise ValueError("gather_rows needs contiguous weight and int32 ids")
    row_bytes = weight.shape[1] * weight.element_size()
    if row_bytes % 16 or weight.data_ptr() % 16:
        raise ValueError(f"gather_rows needs 16-byte aligned rows (row is {row_bytes} B)")
    N = ids.shape[0] // F
    out = torch.empty((N, F, weight.shape[1]), dtype=weight.dtype, device=weight.device)
    launch = _cuda.kernel_entry("gather_rows")
    rc = launch(
        weight.data_ptr(), ids.data_ptr(), out.data_ptr(), F, N, row_bytes,
        _cuda.stream_of(weight),
    )
    _cuda.check_launch("gather_rows", rc)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
