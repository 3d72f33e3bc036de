"""Fixed-size unique on torch tensors (counterpart of
``cachedembedding_tpu/ops/unique.py``): the deduplication of the device
planner (``cache/state.py::plan_ids``).

Both functions return a fixed capacity-``size`` unique set and the true
unique count, so that the caller sees an overflow instead of a silent
truncation, and both leave the device work asynchronous: no output shape
depends on the data, so no call waits for the device. In ``unique_fixed``
JAX's ``mode="drop"`` scatters become writes into a buffer one longer than
the output, whose last element takes every dropped lane and is cut off;
torch never sees an out-of-range index. Everything stays int32, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

_I32 = torch.int32


def _drop_buffer(size: int, fill: int, like: torch.Tensor) -> torch.Tensor:
    """A (size + 1,) int32 buffer: lane ``size`` takes the dropped writes."""
    return torch.full((size + 1,), fill, dtype=_I32, device=like.device)


def unique_fixed(ids: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate ``ids`` ((L,) int32, all >= 0) into at most ``size``
    uniques, by one sort of the stream.

    Returns uids ((size,) int32, ascending, -1 padded), counts ((size,)
    int32, 0 on padding) and n_unique (0-d int32, the true number of
    distinct ids, which may exceed ``size``)."""
    s = torch.sort(ids.to(_I32)).values
    is_first = torch.ones_like(s, dtype=torch.bool)
    is_first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(is_first, 0, dtype=_I32) - 1  # unique rank of each element
    n_unique = rank[-1] + 1 if s.numel() else torch.zeros((), dtype=_I32, device=s.device)
    target = torch.clamp(rank, max=size).long()  # ranks >= size drop
    uids = _drop_buffer(size, -1, s).scatter_(0, target, s)[:size]  # a rank's lanes all carry its id
    counts = _drop_buffer(size, 0, s).index_add_(0, target, torch.ones_like(s))[:size]
    return uids, counts, n_unique


def unique_mask(ids: torch.Tensor, size: int, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free unique over the bounded id domain [0, num_rows): an int32
    histogram over the domain (``index_add_`` into an (N,) int32 buffer, half
    the bytes of ``bincount``'s int64) and its int32 prefix count of nonzero
    rows. The k-th unique row is where that count first reaches k + 1, a
    binary search for each of the ``size`` lanes: no write of the N-row
    domain lands on a dropped lane. ``ids`` must lie in the domain (the
    caller checks). Same contract as ``unique_fixed``."""
    ids = ids.to(_I32)
    counts_full = torch.zeros((num_rows,), dtype=_I32, device=ids.device)
    counts_full.index_add_(0, ids, torch.ones_like(ids))
    csum = torch.cumsum(counts_full > 0, 0, dtype=_I32)  # distinct rows up to and including each row
    n_unique = csum[-1]
    lanes = torch.arange(1, size + 1, dtype=_I32, device=ids.device)
    pos = torch.searchsorted(csum, lanes, out_int32=True)  # num_rows past the last unique row
    valid = pos < num_rows
    uids = torch.where(valid, pos, -1)
    counts = torch.where(valid, counts_full.index_select(0, pos.clamp(max=num_rows - 1)), 0)
    return uids, counts, n_unique
