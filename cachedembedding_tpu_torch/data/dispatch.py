"""One entry for every data source (counterpart of
``cachedembedding_tpu/data/dispatch.py``, the reference baseline's
get_dataloader switch): ``random`` (uniform ids), ``custom`` (procedural
long tail), ``synth`` (fbgemm trace replay from a directory), ``criteo``
(npy days), ``criteo_parquet`` (pyarrow row groups) and ``avazu`` (npy
files); with ``prefetch_depth`` > 0 the batches are built on a worker
thread (``data/prefetch.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

SOURCES = ("random", "custom", "synth", "criteo", "criteo_parquet", "avazu")


def get_dataloader(
    source: str,
    stage: str,
    batch_size: int,
    *,
    dataset_dir: Optional[str] = None,
    table_sizes: Optional[Sequence[int]] = None,
    num_batches: int = 10,
    dense_in_features: int = 13,
    rank: int = 0,
    world_size: int = 1,
    seed: int = 0,
    prefetch_depth: int = 0,
    **kw,
):
    """The batches of ``source`` for ``stage`` ("train", "val" or "test";
    the generated sources seed each stage apart). Extra keywords go to the
    source's own constructor or loader."""
    stage_seed = seed + {"train": 0, "val": 1, "test": 2}.get(stage, 0)
    if source == "random":
        from cachedembedding_tpu_torch.data.random_rec import RandomRecDataset

        data = RandomRecDataset(table_sizes, batch_size, num_batches, dense_in_features=dense_in_features,
                                seed=stage_seed, **kw)
    elif source == "custom":
        from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

        data = SyntheticLongTailDataset(table_sizes, batch_size, num_batches, dense_in_features=dense_in_features,
                                        seed=stage_seed, **kw)
    elif source == "synth":
        from cachedembedding_tpu_torch.data.synth import SynthTraceDataset

        data = SynthTraceDataset.from_dir(dataset_dir, batch_size, num_batches, seed=stage_seed, **kw)
    elif source == "criteo":
        from cachedembedding_tpu_torch.data import criteo

        data = criteo.get_dataloader(dataset_dir, stage, batch_size, rank=rank, world_size=world_size, seed=seed,
                                     **kw)
    elif source == "criteo_parquet":
        from cachedembedding_tpu_torch.data.parquet import ParquetDataReader

        data = ParquetDataReader(dataset_dir, batch_size, table_sizes, rank=rank, world_size=world_size, **kw)
    elif source == "avazu":
        from cachedembedding_tpu_torch.data import avazu

        data = avazu.get_dataloader(dataset_dir, stage, batch_size, rank=rank, world_size=world_size, seed=seed,
                                    **kw)
    else:
        raise ValueError(f"unknown data source {source!r}: one of {', '.join(SOURCES)}")
    if prefetch_depth > 0:
        from cachedembedding_tpu_torch.data.prefetch import PrefetchIterator

        return PrefetchIterator(data, depth=prefetch_depth)
    return data
