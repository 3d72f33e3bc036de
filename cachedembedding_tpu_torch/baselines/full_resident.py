"""Fully device-resident embedding bag, the comparison baseline (counterpart
of ``cachedembedding_tpu/baselines/full_resident.py``).

The whole (num_embeddings, dim) table lives in device memory: a
Criteo-Kaggle table (33,762,577 x 128) is 17.29 GB in f32, which fits an
80 GB H100. It speaks the trainer's staging protocol with identity
remapping (slot ids are the global ids) and no host traffic, so
``CachedDLRMTrainer(cfg, embed_override=FullyResidentEmbeddingBag(...))``
runs unchanged; with the same seeds it trains to the same values as the
cache (the cache is transparent).

The table is initialized on the device by ``ops/synth_rows.py``, bit-equal to
the canonical fill of the cached path's host table (``default_table_init``),
so no host copy of the table is made. With ``optimizer="rowwise_adagrad"`` its
accumulators are an (N,) f32 array on the device (``cache_accum``, 135 MB for
Criteo-Kaggle), as in the JAX package.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch import resolve_device
from cachedembedding_tpu_torch.cache.host_table import row_bounds_of, table_bounds
from cachedembedding_tpu_torch.cache.manager import CACHE_DTYPES, OPTIMIZERS, CacheStats, host_to_device
from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.embedding_bag import embedding_bag
from cachedembedding_tpu_torch.ops.rounding import astype_storage
from cachedembedding_tpu_torch.ops.synth_rows import synth_rows

_INIT_CHUNK = 1 << 18  # rows synthesized a launch: bounds the (n, D) int64 hash transients


class ResidentWindow(NamedTuple):
    """A planned window of the resident table: its ids are its addresses."""

    slot_ids: np.ndarray  # global ids, in the caller's out_shape


class FullyResidentEmbeddingBag:
    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        *,
        mode: str = "sum",
        dtype=torch.float32,
        table_sizes: Optional[Sequence[int]] = None,
        seed: int = 1024,
        weight_init: str = "uniform",
        device=None,
        optimizer: str = "sgd",
        adagrad_initial: float = 0.0,
    ):
        self.device = resolve_device(device)
        dtype = CACHE_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
        if dtype not in CACHE_DTYPES.values():
            raise ValueError(f"resident rows of {dtype}: {', '.join(CACHE_DTYPES)} only")
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if mode not in ("sum", "mean"):
            raise ValueError(f"unsupported mode {mode!r}")
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.mode = mode
        self.dtype = dtype
        self.capacity = self.num_embeddings
        self.table_sizes = list(table_sizes) if table_sizes else [self.num_embeddings]
        if sum(self.table_sizes) != self.num_embeddings:
            raise ValueError("table_sizes must sum to num_embeddings")
        self.stats = CacheStats()
        t0 = time.perf_counter()
        if weight_init == "uniform":
            self.cache_weight = torch.empty((self.num_embeddings, self.embedding_dim), dtype=dtype,
                                            device=self.device)
            offsets = np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(np.int64)
            bounds = table_bounds(self.table_sizes)
            for s in range(0, self.num_embeddings, _INIT_CHUNK):
                rows = np.arange(s, min(s + _INIT_CHUNK, self.num_embeddings), dtype=np.int64)
                vals = synth_rows(self.to_device(rows), self.to_device(row_bounds_of(offsets, bounds, rows)),
                                  seed, self.embedding_dim)
                self.cache_weight[s : s + rows.shape[0]] = astype_storage(vals, dtype)
        elif weight_init == "zeros":
            self.cache_weight = torch.zeros((self.num_embeddings, self.embedding_dim), dtype=dtype,
                                            device=self.device)
        else:
            raise ValueError(f"unknown weight_init {weight_init!r} for the resident table")
        self.optimizer = optimizer
        self.adagrad_initial = float(adagrad_initial)
        self.cache_accum = (torch.full((self.num_embeddings,), self.adagrad_initial, dtype=torch.float32,
                                       device=self.device)
                            if optimizer == "rowwise_adagrad" else None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.table_init_s = time.perf_counter() - t0  # the device fill

    # -- the trainer's staging protocol -------------------------------------
    @property
    def device_rows(self) -> int:
        return self.num_embeddings

    def to_device(self, arr) -> torch.Tensor:
        return host_to_device(arr, self.device)

    def begin_window_staging(self, ids, out_shape, uniform_fbp=None) -> ResidentWindow:
        ids_np = np.ascontiguousarray(np.asarray(ids), dtype=np.int32)
        if ids_np.size and (int(ids_np.min()) < 0 or int(ids_np.max()) >= self.num_embeddings):
            raise ValueError(f"embedding ids out of range [0, {self.num_embeddings})")
        return ResidentWindow(slot_ids=ids_np.reshape(out_shape))

    def enqueue_writebacks(self, ws: ResidentWindow, slots=None) -> None:
        pass  # nothing leaves the device

    def apply_admits(self, ws: ResidentWindow) -> None:
        pass  # every row is resident

    def flush(self) -> None:
        pass  # the device table is the master

    def close(self) -> None:
        pass

    def print_comm_stats(self) -> None:
        print("FullyResidentEmbeddingBag: no host<->HBM traffic")

    def set_accum(self, cache_accum: torch.Tensor) -> None:
        """Rebind the device accumulators (the JAX package's ``set_accum``)."""
        if self.cache_accum is None or cache_accum.shape != self.cache_accum.shape:
            raise ValueError("set_accum: the table keeps no accumulators of that shape")
        self.cache_accum = cache_accum.to(device=self.device, dtype=torch.float32)

    # -- bare-module API ------------------------------------------------------
    def prepare_ids(self, ids) -> torch.Tensor:
        ids_np = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
        return self.to_device(self.begin_window_staging(ids_np, ids_np.shape).slot_ids)

    def lookup(self, features: RaggedFeatures) -> torch.Tensor:
        """Pooled lookup of global ids, uniform or ragged: (B, F, D)."""
        return embedding_bag(self.cache_weight, features, mode=self.mode)

    def dense_weight(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """f32 host copy of ``rows`` of the table (every row when None)."""
        w = self.cache_weight
        if rows is not None:
            w = w.index_select(0, self.to_device(np.asarray(rows, np.int64)))
        return w.float().cpu().numpy()
