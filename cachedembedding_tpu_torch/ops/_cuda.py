"""Build and load the port's CUDA kernels (sources under ``csrc/``).

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``_build.nvcc_command``) and loaded with
ctypes. Nothing here runs at import: a kernel is built by its wrapper's first
launch on a CUDA tensor, or ahead of time by ``build_kernel``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cachedembedding_tpu_torch import _build

SOURCES = {
    "gather_rows": _build.PKG_DIR / "csrc" / "gather_rows.cu",
    "binned_sgd": _build.PKG_DIR / "csrc" / "binned_sgd.cu",
}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_PROTOTYPES = {
    "gather_rows": ("gather_rows_launch", [_P, _P, _P, _I64, _I64, _I64, _P]),
    "binned_sgd": (
        "binned_sgd_launch",
        [_P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_int, _P],
    ),
}


def build_kernel(name: str):
    """Compile one kernel library if needed; returns (path, seconds, nvcc output)."""
    return _build.build(f"lib{name}", [SOURCES[name]], _build.nvcc_command)


@functools.lru_cache(maxsize=None)
def kernel_entry(name: str):
    """The C launch function of kernel ``name``, built at first use."""
    path, _, _ = build_kernel(name)
    lib = ctypes.CDLL(str(path))
    sym, argtypes = _PROTOTYPES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if the launch was refused (the C entry returns cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
