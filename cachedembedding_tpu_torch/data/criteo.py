"""Criteo (Kaggle and 1TB) dataset entry points (counterpart of
``cachedembedding_tpu/data/criteo.py``): ``get_dataloader`` over the
``day_N_{dense,sparse,labels}.npy`` files and ``get_id_freq_map``. The final
day is split into val (first half) and test (second half); a directory whose
path contains "kaggle" has 7 days, any other 24."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cachedembedding_tpu_torch.config import (
    CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE,
    CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
)
from cachedembedding_tpu_torch.data.feature_counter import get_id_freq_map as _freq
from cachedembedding_tpu_torch.data.npy_dataset import InMemoryNpyDataset, stage_files

STAGES = ["train", "val", "test"]
DAYS = 24  # Criteo 1TB
KAGGLE_DAYS = 7


def table_sizes_for(dataset_dir: str) -> List[int]:
    return (
        CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE
        if "kaggle" in dataset_dir
        else CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE
    )


def get_dataloader(
    dataset_dir: str,
    stage: str,
    batch_size: int,
    rank: int = 0,
    world_size: int = 1,
    *,
    shuffle_batches: bool = False,
    hashes: Optional[Sequence[int]] = None,
    assigned_tables: Optional[Sequence[int]] = None,
    seed: int = 0,
) -> InMemoryNpyDataset:
    stage = stage.lower()
    if stage not in STAGES:
        raise ValueError(f"stage {stage} not in {STAGES}")
    final_day = (KAGGLE_DAYS if "kaggle" in dataset_dir else DAYS) - 1
    dense, sparse, labels, extra_rank, world_mult = stage_files(dataset_dir, stage, final_day)
    return InMemoryNpyDataset(
        dense, sparse, labels, batch_size,
        # val/test: the halves of the final day by rank offset and doubled world
        rank=rank + extra_rank * world_size,
        world_size=world_size * world_mult,
        shuffle_batches=shuffle_batches and stage == "train",
        hashes=hashes if hashes is not None else table_sizes_for(dataset_dir),
        assigned_tables=assigned_tables,
        seed=seed,
    )


def get_id_freq_map(
    dataset_dir: str,
    is_rank_zero: bool = True,
    table_sizes: Optional[Sequence[int]] = None,
) -> np.ndarray:
    return _freq(
        dataset_dir,
        list(table_sizes) if table_sizes is not None else table_sizes_for(dataset_dir),
        is_rank_zero=is_rank_zero,
    )
