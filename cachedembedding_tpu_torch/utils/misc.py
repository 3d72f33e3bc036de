"""Memory telemetry (counterpart of ``cachedembedding_tpu/utils/misc.py``)."""

from __future__ import annotations

import resource

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
