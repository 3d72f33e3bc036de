"""HybridParallelDLRM (counterpart of ``cachedembedding_tpu/models/hybrid.py``):
a model-parallel cached embedding and data-parallel DLRM towers over one
mesh, this rank's part of them.

  * sparse: ``parallel/column.ParallelCachedEmbeddingBag`` (column-wise, f32
    rows) or, with ``cfg.use_tablewise``,
    ``parallel/tablewise.ParallelCachedEmbeddingBagTablewise``;
  * dense: ``models/dlrm.DLRM`` on the mesh's device, initialized from
    ``cfg.seed`` as the JAX package's ``init_dlrm_dense`` initializes it, its
    grads summed over the ranks.

As in JAX, both layouts train DLRM towers with plain SGD on f32 rows, whatever
``cfg.model``, ``cfg.embedding_optimizer`` and ``cfg.cache.cache_dtype`` say,
and the table-wise layout ships its admits in f32 whatever
``cfg.cache.transfer_dtype`` says. Without ``dataset`` the table-wise layout
takes the Criteo-Kaggle hand-tuned placement (its first F entries).

Host inputs (dense features, labels) are global batches; each rank puts its
batch rows on its device (``parallel/multiproc.put_addressable``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cachedembedding_tpu_torch.cache.state import EvictionStrategy
from cachedembedding_tpu_torch.config import DLRMConfig
from cachedembedding_tpu_torch.models.dlrm import DLRM
from cachedembedding_tpu_torch.parallel.column import ParallelCachedEmbeddingBag
from cachedembedding_tpu_torch.parallel.hybrid import hybrid_train_step
from cachedembedding_tpu_torch.parallel.mesh import Mesh, make_mesh
from cachedembedding_tpu_torch.parallel.multiproc import put_addressable
from cachedembedding_tpu_torch.parallel.tablewise import (
    ParallelCachedEmbeddingBagTablewise,
    prepare_tablewise_config,
    tablewise_eval_step,
    tablewise_train_step,
    tablewise_window_step,
)


def _f32(x) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))


class HybridParallelDLRM:
    """This rank's part of the hybrid model over ``mesh`` (default: a mesh
    of the whole process group on the current CUDA device)."""

    def __init__(self, cfg: DLRMConfig, mesh: Optional[Mesh] = None, id_freq_map: Optional[np.ndarray] = None,
                 dataset: Optional[str] = None):
        if cfg.interaction_type != "dot":
            raise NotImplementedError(f"interaction_type {cfg.interaction_type!r}: the hybrid layouts train the "
                                      "pairwise dots only; the DCN model trains on one card through "
                                      "CachedDLRMTrainer")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.world = self.mesh.size
        cache = cfg.cache
        strategy = (EvictionStrategy.LFU if (cache.use_lfu_eviction or id_freq_map is None)
                    else EvictionStrategy.DATASET)
        self.use_tablewise = cfg.use_tablewise
        if cfg.use_tablewise:
            configs = prepare_tablewise_config(cfg.num_embeddings_per_feature, cache.cache_ratio, id_freq_map,
                                               dataset or "criteo_kaggle", self.world)
            self.embed = ParallelCachedEmbeddingBagTablewise(
                configs, cfg.embedding_dim, self.mesh, mode=cfg.reduction_mode,
                warmup_ratio=cache.warmup_ratio if cache.use_freq else 0.0, buffer_size=cache.buffer_size,
                evict_strategy=strategy, weight_init=cache.weight_init, seed=cfg.seed,
            )
        else:
            self.embed = ParallelCachedEmbeddingBag(
                cfg.total_num_embeddings, cfg.embedding_dim, mesh=self.mesh, mode=cfg.reduction_mode,
                cache_ratio=cache.cache_ratio, ids_freq_mapping=id_freq_map if cache.use_freq else None,
                warmup_ratio=cache.warmup_ratio, buffer_size=cache.buffer_size, evict_strategy=strategy,
                table_sizes=cfg.num_embeddings_per_feature, seed=cfg.seed, weight_init=cache.weight_init,
                transfer_dtype=cache.transfer_dtype,
            )
        self.model = DLRM(
            cfg.embedding_dim, cfg.num_sparse_features, cfg.dense_in_features, cfg.dense_arch_layer_sizes,
            cfg.over_arch_layer_sizes, compute_dtype=getattr(torch, cfg.compute_dtype), seed=cfg.seed,
            device=self.mesh.device,
        )
        self._steps: dict = {}

    # -- the reference's API ----------------------------------------------------
    @property
    def sparse_modules(self):
        return self.embed

    @property
    def cache_weight_mgr(self):
        return self.embed

    def model_stats(self, prefix: str = "") -> str:
        param_amount = self.cfg.total_num_embeddings * self.cfg.embedding_dim
        param_storage = 4 * param_amount
        dense_amount = sum(p.numel() for p in self.model.parameters())
        param_amount += dense_amount
        param_storage += dense_amount * 4
        return (f"{prefix}: Number of model parameters: {param_amount:,}, "
                f"storage overhead: {param_storage / 1024**3:.2f} GB.")

    # -- steps ------------------------------------------------------------------
    def train_step_fn(self, global_batch: int, pooling: int = 1):
        key = ("train", global_batch, pooling)
        if key not in self._steps:
            if self.use_tablewise:
                self._steps[key] = tablewise_train_step(
                    self.mesh, feature_perm=self.embed.feature_select_perm(), f_max=self.embed.F_max,
                    global_batch=global_batch, mode=self.cfg.reduction_mode)
            else:
                self._steps[key] = hybrid_train_step(
                    self.mesh, num_features=self.cfg.num_sparse_features, global_batch=global_batch,
                    pooling=pooling, mode=self.cfg.reduction_mode, fused_op=self.cfg.fused_op)
        return self._steps[key]

    def _window_step_fn(self, kind: str, global_batch: int):
        key = (kind, global_batch)
        if key not in self._steps:
            build = tablewise_window_step if kind == "train_window" else tablewise_eval_step
            self._steps[key] = build(self.mesh, feature_perm=self.embed.feature_select_perm(),
                                     f_max=self.embed.F_max, global_batch=global_batch,
                                     mode=self.cfg.reduction_mode)
        return self._steps[key]

    def shard_batch(self, dense, labels):
        """This rank's batch rows of a global batch, on its device."""
        return put_addressable(self.mesh, _f32(dense), 0), put_addressable(self.mesh, _f32(labels), 0)

    def train_window(self, dense_P, slot_ids, labels_P, sparse_lrs, dense_lrs) -> torch.Tensor:
        """Table-wise training of a prefetch window: P global batches' dense
        features and labels, their slot ids from ``begin_prepare_window``.
        Returns the (P,) losses on the device."""
        if not self.use_tablewise:
            raise ValueError("train_window is the table-wise layout's")
        step = self._window_step_fn("train_window", dense_P.shape[1])
        return step(self.model, self.embed.cache_weight, slot_ids, put_addressable(self.mesh, _f32(dense_P), 1),
                    put_addressable(self.mesh, _f32(labels_P), 1), sparse_lrs, dense_lrs)

    def eval_window(self, dense_P, slot_ids) -> torch.Tensor:
        """Table-wise scoring of a window -> (P, B_global) probabilities."""
        if not self.use_tablewise:
            raise ValueError("eval_window is the table-wise layout's")
        step = self._window_step_fn("eval_window", dense_P.shape[1])
        return step(self.model, self.embed.cache_weight, slot_ids, put_addressable(self.mesh, _f32(dense_P), 1))

    def train_step(self, dense, sparse_slot_values, labels, sparse_lr, dense_lr) -> torch.Tensor:
        """One step on a global batch. ``sparse_slot_values``: slot ids, the
        global (F * B * P,) ones column-wise, this rank's (F_max * B,) ones
        table-wise."""
        step = self.train_step_fn(dense.shape[0])
        dense_d, labels_d = self.shard_batch(dense, labels)
        return step(self.model, self.embed.cache_weight, dense_d, sparse_slot_values, labels_d, sparse_lr, dense_lr)
