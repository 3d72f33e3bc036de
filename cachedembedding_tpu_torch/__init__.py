"""PyTorch + CUDA port of ``cachedembedding_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here has the
same path and names as its counterpart there, with two exceptions: the port of
``ops/pallas_bag.py`` is ``ops/gather_rows.py``, and the window wire that the
JAX trainer keeps in ``train/trainer.py`` (dense and id encoders, the device
decoders, the packed admits) is ``train/wire.py``. This package imports torch,
numpy and the standard library only, never jax or ``cachedembedding_tpu``.

Importing the package builds nothing: the host C++ library and the CUDA
kernels are compiled at first use into ``cachedembedding_tpu_torch/build/``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. With no GPU and no explicit ``device="cpu"`` this raises instead of
    carrying on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
