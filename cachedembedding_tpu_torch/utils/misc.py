"""Memory telemetry and partition arithmetic (counterpart of
``cachedembedding_tpu/utils/misc.py``)."""

from __future__ import annotations

import resource
from typing import Tuple

import torch


def get_mem_info(prefix: str = "", device=None) -> str:
    """Device memory (allocated, peak allocated, used of total) on the CUDA
    ``device`` (default: the current one), or "cpu" without one, and the
    host's peak RSS."""
    gib = 1024 ** 3
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info(dev)
        parts = [
            f"{torch.cuda.get_device_name(dev)}: allocated {torch.cuda.memory_allocated(dev) / gib:.2f} GB, "
            f"peak {torch.cuda.max_memory_allocated(dev) / gib:.2f} GB, "
            f"used {(total - free) / gib:.2f}/{total / gib:.2f} GB"
        ]
    else:
        parts = ["cpu"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2  # KiB on Linux
    parts.append(f"host RSS: {rss:.2f} GB")
    return f"{prefix} " + ", ".join(parts)


def get_partition(embedding_dim: int, rank: int, world_size: int) -> Tuple[int, int, bool]:
    """Column-wise split arithmetic as ``torch.tensor_split`` splits: rank
    ``rank``'s columns [start, end) of ``embedding_dim`` over ``world_size``
    ranks, the first ``embedding_dim % world_size`` ranks one column wider.
    Returns (start, end, divisible)."""
    if world_size == 1:
        return 0, embedding_dim, True
    assert embedding_dim >= world_size
    chunk = embedding_dim // world_size
    rem = embedding_dim % world_size
    if rem == 0:
        return rank * chunk, (rank + 1) * chunk, True
    sizes = [chunk + 1 if i < rem else chunk for i in range(world_size)]
    off = sum(sizes[:rank])
    return off, off + sizes[rank], False
