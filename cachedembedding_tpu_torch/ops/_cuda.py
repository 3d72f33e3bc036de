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

_CSRC = _build.PKG_DIR / "csrc"
SOURCES = {
    "gather_rows": _CSRC / "gather_rows.cu",
    "binned_sgd": _CSRC / "binned_sgd.cu",
    "binned_scatter_add": _CSRC / "binned_scatter_add.cu",
    "stochastic_round": _CSRC / "stochastic_round.cu",
    "ordered_scatter_add": _CSRC / "ordered_scatter_add.cu",
}
HEADERS = [_CSRC / "row_runs.cuh"]  # part of every kernel's build hash

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# entry name -> (library, C symbol, argument types)
_PROTOTYPES = {
    "gather_rows": ("gather_rows", "gather_rows_launch", [_P, _P, _P, _I64, _I64, _I64, _P]),
    "binned_sgd": (
        "binned_sgd", "binned_sgd_launch",
        [_P, _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    ),
    "binned_scatter_add": (
        "binned_scatter_add", "binned_scatter_add_launch",
        [_P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    ),
    "stochastic_round": (
        "stochastic_round", "stochastic_round_launch",
        [_P, _P, _I64, ctypes.c_uint32, ctypes.c_int, _P],
    ),
    "stochastic_sgd_round": (
        "stochastic_round", "stochastic_sgd_round_launch",
        [_P, _P, _I64, ctypes.c_float, ctypes.c_uint32, ctypes.c_int, _P],
    ),
    "ordered_scatter_add": (
        "ordered_scatter_add", "ordered_scatter_add_launch",
        [_P, _P, _P, _P, _I64, _I64, ctypes.c_float, ctypes.c_int, _P, _P],
    ),
    "bf16_add_sweep": ("ordered_scatter_add", "bf16_add_sweep_launch", [_P, _P]),
    "chain_latency": ("ordered_scatter_add", "chain_latency_launch", [_P, _P, _I64, ctypes.c_int, _P]),
    "ordered_grad_update": (
        "ordered_scatter_add", "ordered_grad_update_launch",
        [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P, _P],
    ),
}


def build_kernel(name: str):
    """Compile one kernel library if needed; returns (path, seconds, nvcc output)."""
    return _build.build(f"lib{name}", [SOURCES[name]], _build.nvcc_command, HEADERS)


@functools.lru_cache(maxsize=None)
def kernel_entry(name: str):
    """The C launch function ``name`` (a key of ``_PROTOTYPES``), its
    library built at first use."""
    path, _, _ = build_kernel(_PROTOTYPES[name][0])
    return bind(ctypes.CDLL(str(path)), name)


def bind(lib: ctypes.CDLL, name: str):
    """The C launch function ``name`` (a key of ``_PROTOTYPES``) in ``lib``,
    with its argument and return types."""
    _, sym, argtypes = _PROTOTYPES[name]
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
