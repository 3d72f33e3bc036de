"""Structured configuration: a field-for-field copy of
``cachedembedding_tpu/config.py`` with the same defaults.

The port runs one slice of these options (see ``ROADMAP.md``); the trainer and
the cache raise ``NotImplementedError`` naming the ROADMAP item for the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class CacheConfig:
    """Software-cache knobs (the reference's ``--cache_ratio`` family)."""

    cache_ratio: float = 0.01          # --cache_ratio
    warmup_ratio: float = 0.7          # --warmup_ratio
    buffer_size: int = 50_000          # --buffer_size; 0 disables the bounded staging buffer
    use_lfu_eviction: bool = False     # --use_lfu: LFU vs DATASET eviction
    use_freq: bool = True              # --use_freq: seed cache with dataset id frequency
    prefetch_num: int = 8              # --prefetch_num: far-sighted prefetch depth
    use_overlap: bool = True           # --use_overlap (overlap is structural, always on)
    pin_weight: bool = True            # pin host weight
    planner: str = "auto"              # "host" (native C++ directory) | "device" | "auto"
    approx_evict: bool = False         # approximate victim selection (device planner)
    weight_init: str = "uniform"       # host table init: "uniform" | "zeros" | "virtual"
    transfer_dtype: str = "float32"    # host<->device admit payload dtype
    cache_dtype: str = "bfloat16"      # device cache-row storage dtype
    ship_sort_perm: bool = False       # host-planned bin grouping for the
    # embedding update (ops/binned_scatter.py); the port requires it
    stochastic_rounding: str = "auto"  # "auto" | "on" | "off" (fp8 cache rows)
    id_wire: str = "escape"            # id wire format: "plain" | "escape" | "ranktier"
    escape_pack: bool = True           # escape-coded id wire format
    use_pallas_lookup: bool = False    # row-gather kernel for the lookup
    onehot_max_rows: int = 2048        # small resident tables: one-hot backward
    resident_threshold: int = 0        # tables with <= this many rows stay fully
    # device-resident in a region after the cache slots; 0 disables


@dataclasses.dataclass
class DLRMConfig:
    """Model + training hyperparameters."""

    # model
    model: str = "dlrm"                # "dlrm" | "deepfm"
    deep_fm_dimension: int = 16
    num_embeddings_per_feature: Sequence[int] = ()
    embedding_dim: int = 128
    dense_in_features: int = 13
    dense_arch_layer_sizes: Tuple[int, ...] = (512, 256, 128)
    over_arch_layer_sizes: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    reduction_mode: str = "sum"

    # training
    batch_size: int = 16384
    learning_rate: float = 1.0         # sparse LR; dense LR is scaled by data-parallel size
    epochs: int = 1
    seed: int = 1024
    change_lr: bool = False            # --change_lr / --lr_change_point / --lr_after
    lr_change_point: float = 0.8
    lr_after: float = 0.2
    shuffle_batches: bool = False

    # evaluation
    validation_freq_within_epoch: Optional[int] = None

    # parallelism
    mesh_shape: Tuple[int, ...] = (1,)
    use_tablewise: bool = False
    fused_op: str = "all_to_all"

    # precision
    compute_dtype: str = "float32"     # dense tower matmul operand dtype
    interaction_impl: str = "bmm"      # "bmm" | "gather"
    dense_input_dtype: str = "bfloat16"  # host->device dtype of dense features
    use_sparse_embed_grad: bool = False

    # embedding optimizer
    embedding_optimizer: str = "sgd"   # "sgd" | "rowwise_adagrad"
    adagrad_eps: float = 1e-10
    adagrad_initial: float = 0.0

    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)

    @property
    def num_sparse_features(self) -> int:
        return len(self.num_embeddings_per_feature)

    @property
    def total_num_embeddings(self) -> int:
        return int(sum(self.num_embeddings_per_feature))


# Dataset constants (the reference's criteo.py / avazu.py table sizes).
CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE = [
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261, 1572176,
    345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457, 11316796, 40094537,
    452104, 12606, 104, 35,
]
CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
    3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
    142572,
]
AVAZU_NUM_EMBEDDINGS_PER_FEATURE = [
    7, 7, 4737, 7745, 26, 8552, 559, 36, 2686408, 6729486, 8251, 5, 4,
]

CRITEO_NUM_DENSE = 13
AVAZU_NUM_DENSE = 8
CRITEO_KAGGLE_TOTAL_TRAINING_SAMPLES = 39_291_954
AVAZU_TOTAL_TRAINING_SAMPLES = 36_386_071
