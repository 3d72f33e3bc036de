"""Avazu CTR dataset entry points (counterpart of
``cachedembedding_tpu/data/avazu.py``).

Avazu has 13 categorical and 8 integer features and the same dense/sparse/
labels npy layout as Criteo, so the loader is shared. Files whose names hold
"train" are the training split (every file when none does); val and test are
the halves of the files named "val" or "test", or else of the training
files."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from cachedembedding_tpu_torch.config import AVAZU_NUM_EMBEDDINGS_PER_FEATURE
from cachedembedding_tpu_torch.data.feature_counter import get_id_freq_map as _freq
from cachedembedding_tpu_torch.data.npy_dataset import InMemoryNpyDataset

STAGES = ["train", "val", "test"]


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
    files = sorted(os.listdir(dataset_dir))

    def pick(kind: str, names) -> List[str]:
        return sorted(os.path.join(dataset_dir, f) for f in names if kind in f)

    train_files = [f for f in files if "train" in f] or files
    eval_files = [f for f in files if "val" in f or "test" in f]
    if stage == "train":
        names, eff_rank, eff_world = train_files, rank, world_size
    else:  # the halves of the eval files, or of the train files when there are none
        names = eval_files or train_files
        eff_rank = rank + (0 if stage == "val" else world_size)
        eff_world = world_size * 2
    return InMemoryNpyDataset(
        pick("dense", names), pick("sparse", names), pick("labels", names), batch_size,
        rank=eff_rank,
        world_size=eff_world,
        shuffle_batches=shuffle_batches and stage == "train",
        hashes=hashes if hashes is not None else AVAZU_NUM_EMBEDDINGS_PER_FEATURE,
        assigned_tables=assigned_tables,
        seed=seed,
    )


def get_id_freq_map(dataset_dir: str, is_rank_zero: bool = True, table_sizes=None) -> np.ndarray:
    return _freq(
        dataset_dir,
        list(table_sizes) if table_sizes is not None else AVAZU_NUM_EMBEDDINGS_PER_FEATURE,
        is_rank_zero=is_rank_zero,
    )
