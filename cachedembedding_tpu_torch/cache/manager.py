"""CachedEmbeddingBag — host-DRAM embedding table with a GPU hot-row cache
(counterpart of ``cachedembedding_tpu/cache/manager.py``).

The full ``(num_embeddings, dim)`` table lives in host DRAM (a dense numpy
array or a virtual procedural table); ``int(cache_ratio * cached_rows)`` rows
are resident in the device tensor ``cache_weight``, optionally followed by a
region that holds small tables whole (``resident_tables``).

Split of responsibilities, with the host planner (``planner="host"``, or
"auto"):
  * host (this class): the C++ directory plans each window, rows to admit are
    split into never-trained rows (synthesized on the GPU from their id) and
    trained rows (gathered from the host table), evicted rows are read back
    and written to the host table by a drain thread;
  * device: admit scatters, writeback gathers, lookups, and the update.

With the device planner (``planner="device"``) the directory lives on the
device (``cache/state.py::CacheState``: the (N,) ``row_to_slot`` alone is
135 MB at Criteo-Kaggle's 33.8M rows, 712 MB at Criteo-1TB's 177.9M) and
``begin_prepare`` enqueues ``plan_ids`` and the id remap there, then copies
the plan's six scalars and its whole (3, U) index block into pinned host
memory behind a CUDA event, so that nothing waits for the device's earlier
work. ``finish_prepare`` waits on that event only, raises where the window
overflows its unique budget or the cache, and enqueues the writeback gathers
and the admits (every admit is fetched from the host table, in f32 or, with
``transfer_dtype="bfloat16"``, bf16; writebacks travel in bf16 in that mode
and in the rows' dtype otherwise, as in JAX's device branch). As in JAX, the
device planner takes no resident tables, no row-wise Adagrad and no device
init of never-trained rows.

Admitted host rows travel in ``transfer_dtype``: f32, bf16, or per-row
int8 / int4 payloads with an f32 scale each (``_quant_rows_host``,
``_quant_rows_host4``), dequantized to f32 on the device and cast to the
cache dtype. Warmup and the resident region ship f32 rows unless the mode is
bf16, and writebacks ship bf16 whenever the mode is not f32, as in JAX.

With ``optimizer="rowwise_adagrad"`` each device row has an f32 accumulator
(``cache_accum``, (capacity + resident_total,)) whose master lives in a host
store (``host_table.DenseAccumStore``, or ``OverlayAccumStore`` for a
virtual table). It moves with its row: synthesized admits start at
``adagrad_initial``, fetched admits carry the host value, and evictions,
flushes and checkpoints write it back in the same stream order as the rows.
As in the JAX package this needs the host planner.

Ordering on the device comes from stream order, never from thread timing:
a window's writeback gathers are enqueued after the previous window's steps
and before this window's admits, and copy into pinned host buffers behind a
CUDA event that the drain thread waits on. Host->device payloads leave from
pinned buffers so that no copy blocks the host on earlier device work.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch import resolve_device
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.host_directory import make_directory
from cachedembedding_tpu_torch.cache.host_table import (
    DenseAccumStore,
    DenseHostTable,
    OverlayAccumStore,
    VirtualHostTable,
)
from cachedembedding_tpu_torch.cache.state import (
    CacheState,
    EvictionStrategy,
    Plan,
    gather_slots,
    init_cache_state,
    plan_ids,
    remap_ids,
    scatter_admits,
    scatter_admits_q4,
    scatter_admits_q8,
)
from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.embedding_bag import embedding_bag
from cachedembedding_tpu_torch.ops.synth_rows import scatter_synth_admits
from cachedembedding_tpu_torch.utils.spans import CHECK_RANGE, Spans

CACHE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
OPTIMIZERS = ("sgd", "rowwise_adagrad")
PLANNERS = ("auto", "host", "device")
TRANSFER_DTYPES = ("float32", "bfloat16", "int8", "int4")


def _quant_rows_host(rows: np.ndarray, absmax: Optional[np.ndarray] = None):
    """Per-row symmetric int8 quantization of host rows for the wire:
    (q (n, D) int8, scales (n,) f32). ``absmax``: each row's largest |x|
    where ``rows`` holds only some of its columns."""
    rows = np.asarray(rows, np.float32)
    absmax = np.abs(rows).max(axis=1, initial=0.0) if absmax is None else absmax
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(rows / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _quant_rows_host4(rows: np.ndarray, absmax: Optional[np.ndarray] = None):
    """Per-row symmetric 4-bit quantization, nibble-packed in element pairs
    (element 2k in the low nibble), biased by 8: (packed (n, D/2) uint8,
    scales (n,) f32). ``absmax`` as for ``_quant_rows_host``."""
    rows = np.asarray(rows, np.float32)
    absmax = np.abs(rows).max(axis=1, initial=0.0) if absmax is None else absmax
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = (np.clip(np.round(rows / scale[:, None]), -7, 7) + 8).astype(np.uint8)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8), scale


@dataclass
class CacheStats:
    """Swap/hit statistics (the reference's ``print_comm_stats``)."""

    num_hits_history: List[int] = field(default_factory=list)
    num_miss_history: List[int] = field(default_factory=list)
    num_write_back_history: List[int] = field(default_factory=list)
    swap_in_bytes: int = 0
    swap_out_bytes: int = 0
    swap_in_time: float = 0.0
    swap_out_time: float = 0.0
    prepare_calls: int = 0
    synth_rows: int = 0  # admits materialized on the device (no link bytes)
    # bytes over the host link as copied: ``to_device`` (the trainer's window
    # inputs too), the device plan's readback, the writeback gathers' copies
    h2d_bytes: int = 0
    d2h_bytes: int = 0

    def hit_rate(self, window: int = 0) -> float:
        """Hits over lookups of unique ids, over the last ``window`` planned
        windows (every window when 0)."""
        hits = self.num_hits_history[-window:] if window else self.num_hits_history
        miss = self.num_miss_history[-window:] if window else self.num_miss_history
        tot = sum(hits) + sum(miss)
        return sum(hits) / tot if tot else 0.0

    def summary(self) -> str:
        gib = 1024 ** 3
        in_bw = self.swap_in_bytes / self.swap_in_time / gib if self.swap_in_time else 0.0
        out_bw = self.swap_out_bytes / self.swap_out_time / gib if self.swap_out_time else 0.0
        return (
            f"CacheStats: prepare_calls={self.prepare_calls} "
            f"hit_rate={self.hit_rate():.4f} "
            f"swap_in={self.swap_in_bytes / gib:.3f}GiB @ {in_bw:.2f}GiB/s "
            f"swap_out={self.swap_out_bytes / gib:.3f}GiB @ {out_bw:.2f}GiB/s "
            f"synth_rows={self.synth_rows}"
        )


class WindowStaging(NamedTuple):
    """Everything needed to make one window's rows resident, prepared on the
    host by ``begin_window_staging``: never-trained admits (synthesized on the
    device) and fetched admits (host-table rows, in the transfer mode)."""

    slot_ids: np.ndarray       # remapped ids, in the caller's out_shape
    synth_slots: np.ndarray    # (ns,) int32
    synth_rows: np.ndarray     # (ns,) int64 global rows
    synth_bounds: np.ndarray   # (ns,) float32
    fetch_slots: np.ndarray    # (nf,) int32
    fetch_rows: np.ndarray     # (nf,) int64 global rows of the fetched admits
    fetch_payload: torch.Tensor  # (nf, D) f32 / bf16 / int8, or (nf, D/2) uint8 nibble pairs (int4)
    fetch_scales: np.ndarray   # (nf,) f32 per-row scales of int8/int4 payloads, else (0,)
    fetch_accum: np.ndarray    # (nf,) f32 Adagrad accumulators of the fetched rows, or (0,)
    admit_slots: np.ndarray    # (n_miss,) full plan arrays for the writebacks
    evict_rows: np.ndarray     # (n_miss,)


class PreparedWindow(NamedTuple):
    """A window planned on the device by ``begin_prepare`` whose rows have not
    moved yet (``finish_prepare`` moves them)."""

    slot_ids: torch.Tensor      # the ids remapped to slots, on the device
    plan: Plan                  # on the device
    budget: int                 # the unique budget the plan was made with
    host_scalars: torch.Tensor  # (6,) int32 copy of plan.scalars (pinned on CUDA)
    host_indices: torch.Tensor  # (3, U) int32 copy of plan.indices (pinned on CUDA)
    events: Optional[tuple]     # CUDA: events before the plan, after the remap, after the copies

    @property
    def readback_bytes(self) -> int:
        return self.host_scalars.nbytes + self.host_indices.nbytes


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """Asynchronous host->device copy of a numpy array or CPU tensor. On
    CUDA the source is staged in pinned memory, so the copy never waits for
    earlier device work; the caching host allocator keeps the pinned block
    alive until the copy has run. On the CPU it is a copy."""
    src = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
    if device.type != "cuda":
        return src.clone()
    if not src.is_pinned():
        src = torch.empty(src.shape, dtype=src.dtype, pin_memory=True).copy_(src)
    return src.to(device, non_blocking=True)


def default_table_init(table_sizes: Sequence[int], seed: int, col_start: int = 0):
    """Per-table U(-1/sqrt(n), 1/sqrt(n)) init by the canonical per-(row, col,
    seed) hash, so dense tables, virtual tables and the device agree; a slab
    narrower than the rows holds their columns from ``col_start``."""

    def init(host_weight: np.ndarray) -> None:
        off = 0
        for n in table_sizes:
            hostops.fill_rows_canonical(host_weight[off : off + n], off, seed, float(n) ** -0.5, col_start)
            off += n

    return init


class CachedEmbeddingBag:
    """Frequency-aware software-cached EmbeddingBag (single device).

    Cache rows are stored in ``dtype`` (f32, bf16, float8_e4m3fn or
    float8_e5m2) over the f32 host master; admits round into it as
    ``jnp.astype`` does; writebacks travel at f32 where ``transfer_dtype``
    is f32 and at bf16 otherwise, flushes in the rows' dtype. ``optimizer``
    is "sgd" or "rowwise_adagrad" (per-row accumulators that tier with the
    cache, starting at ``adagrad_initial``). The bare module's knobs are the
    reference's: ``cuda_row_num`` (the slot count, in place of
    ``cache_ratio``), ``device_init`` ("auto", "on" or "off": never-trained
    admits synthesized on the device), ``include_last_offset`` and
    ``set_cache_op`` for ``forward``. ``planner``: "host" (or "auto") plans
    on the host, "device" on the device (see the module's notes), with
    ``unique_budget`` (the plan's unique lanes, default a window's id count;
    at most the capacity) and ``approx_evict`` (JAX's approximate victim
    selection; the port selects exactly). ``columns`` = (start, end): the
    columns of every row that this bag stores, on the device and in its host
    table (a column-sharded bag's, ``parallel/column.py``; default all).
    ``initial_weight``: the host table's rows, in place of ``weight_init``
    (a row shard's, ``parallel/row_cached.py``; never synthesized on the
    device). Runs on ``device`` (default: the current CUDA device; with no GPU and no
    explicit ``device="cpu"`` this raises)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        *,
        mode: str = "sum",
        include_last_offset: bool = True,
        cache_ratio: float = 0.01,
        cuda_row_num: Optional[int] = None,
        ids_freq_mapping: Optional[np.ndarray] = None,
        warmup_ratio: float = 0.7,
        buffer_size: int = 50_000,
        evict_strategy: EvictionStrategy = EvictionStrategy.LFU,
        dtype=torch.float32,
        table_sizes: Optional[Sequence[int]] = None,
        seed: int = 1024,
        weight_init: str = "uniform",
        transfer_dtype: str = "float32",
        device=None,
        resident_tables: Optional[Sequence[int]] = None,
        optimizer: str = "sgd",
        adagrad_initial: float = 0.0,
        device_init: str = "auto",
        planner: str = "auto",
        unique_budget: Optional[int] = None,
        approx_evict: bool = False,
        columns: Optional[Tuple[int, int]] = None,
        initial_weight: Optional[np.ndarray] = None,
    ):
        self.device = resolve_device(device)
        self.stats = CacheStats()
        self.spans = Spans()  # the cache's spans and its trainer's
        self.col_start, col_end = columns if columns is not None else (0, int(embedding_dim))
        if not 0 <= self.col_start < col_end <= embedding_dim:
            raise ValueError(f"columns {columns} outside [0, {embedding_dim})")
        self.dim_stored = col_end - self.col_start  # the columns this bag stores
        if planner not in PLANNERS:
            raise ValueError(f"unknown planner {planner!r}")
        self.planner = "host" if planner == "auto" else planner
        self.unique_budget = unique_budget
        self.approx_evict = bool(approx_evict)
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        if transfer_dtype == "int4" and self.dim_stored % 2:
            raise ValueError("int4 transfers require an even embedding_dim (and an even count of stored columns)")
        if device_init not in ("auto", "on", "off"):
            raise ValueError(f"unknown device_init {device_init!r}")
        dtype = CACHE_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
        if dtype not in CACHE_DTYPES.values():
            raise ValueError(f"cache dtype {dtype}: the cache stores {', '.join(CACHE_DTYPES)} rows")
        if mode not in ("sum", "mean"):
            raise ValueError(f"unsupported mode {mode!r}")
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.mode = mode
        self.include_last_offset = include_last_offset
        self.dtype = dtype

        # --- mixed-kernel resident region ---------------------------------
        sizes = list(table_sizes) if table_sizes is not None else [self.num_embeddings]
        if sum(sizes) != self.num_embeddings:
            raise ValueError("table_sizes must sum to num_embeddings")
        self.table_sizes = sizes
        self.resident_tables = sorted(set(int(t) for t in (resident_tables or [])))
        if not all(0 <= t < len(sizes) for t in self.resident_tables):
            raise ValueError(f"resident_tables out of range: {self.resident_tables}")
        if self.resident_tables and self.planner != "host":
            raise ValueError("resident_tables (mixed-kernel) requires the host planner")
        goff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._goff = goff
        self.resident_total = int(sum(sizes[t] for t in self.resident_tables))
        num_cached_rows = self.num_embeddings - self.resident_total
        capacity = cuda_row_num if cuda_row_num is not None else int(cache_ratio * num_cached_rows)
        self.capacity = max(1, min(int(capacity), max(num_cached_rows, 1)))
        self.buffer_size = int(buffer_size)
        self.evict_strategy = evict_strategy

        # Resident feature's fused global id g maps to device address
        # g + delta[t]; cached ids pass through to the directory unchanged.
        self._res_delta = np.zeros(len(sizes), np.int64)
        self._is_res_table = np.zeros(len(sizes), bool)
        base = self.capacity
        res_rows = []
        for t in self.resident_tables:
            self._is_res_table[t] = True
            self._res_delta[t] = base - goff[t]
            res_rows.append(np.arange(goff[t], goff[t + 1], dtype=np.int64))
            base += sizes[t]
        self._res_rows = np.concatenate(res_rows) if res_rows else np.zeros((0,), np.int64)

        # --- host-DRAM master weight ---
        t0 = time.perf_counter()
        if initial_weight is not None:
            if initial_weight.shape != (self.num_embeddings, self.dim_stored):
                raise ValueError(f"initial_weight is {initial_weight.shape}, the table "
                                 f"({self.num_embeddings}, {self.dim_stored})")
            self.host_table = DenseHostTable(np.ascontiguousarray(initial_weight, dtype=np.float32))
        elif weight_init == "virtual":
            self.host_table = VirtualHostTable(
                self.table_sizes, self.dim_stored, seed=seed,
                capacity_hint=max(4 * self.capacity, 1 << 16), col_start=self.col_start,
            )
        elif weight_init == "uniform":
            arr = np.empty((self.num_embeddings, self.dim_stored), np.float32)
            default_table_init(self.table_sizes, seed, self.col_start)(arr)
            self.host_table = DenseHostTable(arr, procedural_seed=seed, table_sizes=self.table_sizes)
        elif weight_init == "zeros":
            self.host_table = DenseHostTable(
                np.zeros((self.num_embeddings, self.dim_stored), np.float32)
            )
        else:
            raise ValueError(f"unknown weight_init {weight_init!r}")
        self.table_init_s = time.perf_counter() - t0  # the host table's fill

        # the directory: in host memory, or (device planner) on the device
        self._dir, self.state = None, None
        if self.planner == "host":
            self._dir = make_directory(self.num_embeddings, self.capacity, evict_strategy)
        else:
            self.state = init_cache_state(self.num_embeddings, self.capacity, self.device)
        self.dataset_freq: Optional[torch.Tensor] = None
        self.cache_weight = torch.zeros(
            (self.capacity + self.resident_total, self.dim_stored), dtype=dtype, device=self.device
        )
        # --- row-wise Adagrad state: tiers with the cache ---
        if optimizer == "rowwise_adagrad" and self._dir is None:
            raise ValueError("rowwise_adagrad on a cached bag requires the host planner (the accumulator tiers "
                             "with the cache through the staged admit/evict paths)")
        self.optimizer = optimizer
        self.adagrad_initial = float(adagrad_initial)
        if optimizer == "rowwise_adagrad":
            self.cache_accum = torch.full((self.device_rows,), self.adagrad_initial, dtype=torch.float32,
                                          device=self.device)
            self.host_accum = (OverlayAccumStore(self.adagrad_initial)
                               if isinstance(self.host_table, VirtualHostTable)
                               else DenseAccumStore(self.num_embeddings, self.adagrad_initial))
        else:
            self.cache_accum = None
            self.host_accum = None

        if ids_freq_mapping is not None:
            freq = np.ascontiguousarray(ids_freq_mapping, dtype=np.int64)
            if freq.shape != (self.num_embeddings,):
                raise ValueError("ids_freq_mapping must have one entry per row")
            self._host_freq = freq
            if evict_strategy == EvictionStrategy.DATASET and self._dir is not None:
                self._dir.set_dataset_freq(freq)
            elif evict_strategy == EvictionStrategy.DATASET:  # int32 on the device, clipped as JAX's
                self.dataset_freq = self.to_device(np.minimum(freq, 2**31 - 1).astype(np.int32))
        else:
            self._host_freq = None
            if evict_strategy == EvictionStrategy.DATASET:
                raise ValueError("DATASET eviction requires ids_freq_mapping")

        # never-trained rows materialize on the device ("auto": wherever the
        # host table is procedural and the planner is the host one)
        self.device_init = (device_init != "off" and getattr(self.host_table, "supports_device_init", False)
                            and self._dir is not None)
        if device_init == "on" and not self.device_init:
            raise ValueError("device_init requires a procedural host table (uniform/virtual init) "
                             "and the host planner")
        self._seed = int(getattr(self.host_table, "seed", 0) or 0)

        # Warmup never spends cache slots on resident rows.
        if self.resident_tables and self._host_freq is not None:
            wf = self._host_freq.copy()
            for t in self.resident_tables:
                wf[goff[t] : goff[t + 1]] = 0
            self._warm_freq = wf
        else:
            self._warm_freq = self._host_freq

        self.cache_op = True
        self.transfer_mode = transfer_dtype
        # warmup and the resident region ship f32 rows unless the mode is bf16;
        # writebacks land in the f32 host master at >= bf16 (bf16 unless f32)
        self._row_dtype = torch.bfloat16 if transfer_dtype == "bfloat16" else torch.float32
        self.writeback_dtype = torch.float32 if transfer_dtype == "float32" else torch.bfloat16
        # Writeback drain: evicted rows land in the host table on a worker
        # thread. The host table is guarded by a lock; a re-admission of a row
        # whose writeback is still in flight is prevented by _ensure_clean.
        self._host_lock = threading.Lock()
        self._wb_exec = ThreadPoolExecutor(max_workers=1)
        self._wb_futures: list = []  # (future, evicted row ids)
        self._pending_wb: list = []  # (evicted rows, host values, event) not yet submitted

        if self.resident_total:
            self._init_resident_region()
        self.warmup_ratio = float(warmup_ratio)
        if self._host_freq is not None and warmup_ratio > 0:
            self._warmup(warmup_ratio)

    # -- host <-> device helpers ------------------------------------------------
    @property
    def _on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _pinned(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._on_cuda)

    def to_device(self, arr) -> torch.Tensor:
        """Asynchronous host->device copy (``host_to_device``)."""
        self.stats.h2d_bytes += arr.nbytes
        return host_to_device(arr, self.device)

    @property
    def device_rows(self) -> int:
        """Total rows of the device array: cache slots + resident region."""
        return self.capacity + self.resident_total

    @property
    def cache_weight_mgr(self) -> "CachedEmbeddingBag":
        """The reference's ``embed.cache_weight_mgr``: bag and manager are one."""
        return self

    def set_cache_op(self, cache_op: bool) -> None:
        """With ``cache_op`` off, ``forward`` takes slot ids from an earlier
        ``prepare_ids`` and runs no cache maintenance."""
        self.cache_op = bool(cache_op)

    def pf_pack_spec(self, n_per_feature: int):
        """Per-feature (pack width, device delta) of the window id wire: each
        feature's block at its own width, resident features as raw local ids
        with a static address delta added on the device, cached features at
        the cache capacity's width. None without a resident split."""
        if not self.resident_tables:
            return None
        spec = []
        for t, size in enumerate(self.table_sizes):
            if self._is_res_table[t]:
                spec.append((hostops.nibble_width(size, n_per_feature), int(self._goff[t] + self._res_delta[t])))
            else:
                spec.append((hostops.nibble_width(self.capacity, n_per_feature), 0))
        return tuple(spec)

    # -- warmup ---------------------------------------------------------------
    def _warmup(self, warmup_ratio: float) -> None:
        """Preload the hottest ``warmup_ratio * capacity`` rows by dataset frequency."""
        freq = self._warm_freq
        k = min(
            int(warmup_ratio * self.capacity),
            self.num_embeddings - self.resident_total,
            int((freq > 0).sum()),  # resident rows have frequency 0 here
        )
        if k <= 0:
            return
        top = np.argpartition(freq, -k)[-k:].astype(np.int64)
        warm_freq = np.minimum(freq[top], 2**31 - 1)
        if self._dir is not None:
            self._dir.warmup(top, warm_freq)
        else:  # the state built on the host, then shipped once
            s2r = np.full((self.capacity,), -1, np.int32)
            r2s = np.full((self.num_embeddings,), -1, np.int32)
            s2r[:k] = top
            r2s[top] = np.arange(k, dtype=np.int32)
            sfreq = np.zeros((self.capacity,), np.int32)
            sfreq[:k] = warm_freq
            self.state = CacheState(*(self.to_device(a) for a in (s2r, r2s, sfreq)))
        t0 = time.perf_counter()
        slots = np.arange(k, dtype=np.int32)
        written = self.host_table.written_mask(top) if self.device_init else np.ones((k,), np.bool_)
        n_fresh = int(k - written.sum())
        if n_fresh:
            fresh = ~written
            scatter_synth_admits(
                self.cache_weight,
                self.to_device(slots[fresh].astype(np.int64)),
                self.to_device(top[fresh]),
                self.to_device(self.host_table.row_bounds(top[fresh]).astype(np.float32)),
                self._seed, col_start=self.col_start,
            )
            self.stats.synth_rows += n_fresh
        if n_fresh < k:
            rows = self.host_table.gather(top[written])
            slots_dev = self.to_device(slots[written].astype(np.int64))
            scatter_admits(self.cache_weight, slots_dev, self.to_device(torch.from_numpy(rows).to(self._row_dtype)))
            # trained warm rows resume with their accumulators (a restored checkpoint)
            self._land_accum(slots_dev, top[written])
            self.stats.swap_in_bytes += rows.nbytes
        self.stats.swap_in_time += time.perf_counter() - t0

    # -- mixed-kernel resident region -----------------------------------------
    def _init_resident_region(self) -> None:
        """Land the resident tables' rows at [capacity, capacity+R): device
        synthesis for never-trained rows, host fetch for trained ones."""
        R = self.resident_total
        rows = self._res_rows
        addrs = np.arange(self.capacity, self.capacity + R, dtype=np.int64)
        written = self.host_table.written_mask(rows) if self.device_init else np.ones((R,), np.bool_)
        fresh = ~written
        if fresh.any():
            scatter_synth_admits(
                self.cache_weight,
                self.to_device(addrs[fresh]),
                self.to_device(rows[fresh]),
                self.to_device(self.host_table.row_bounds(rows[fresh]).astype(np.float32)),
                self._seed, col_start=self.col_start,
            )
        if written.any():
            vals = self.host_table.gather(rows[written])
            addrs_dev = self.to_device(addrs[written])
            scatter_admits(self.cache_weight, addrs_dev, self.to_device(torch.from_numpy(vals).to(self._row_dtype)))
            self._land_accum(addrs_dev, rows[written])
            self.stats.swap_in_bytes += vals.nbytes

    def _land_accum(self, addrs_dev: torch.Tensor, rows: np.ndarray) -> None:
        """Adagrad: the host accumulators of ``rows`` into device ``addrs_dev``."""
        if self.cache_accum is not None:
            self.cache_accum.index_copy_(0, addrs_dev, self.to_device(self.host_accum.gather(rows)))

    def _check_range(self, ids_np: np.ndarray, device_planner: bool = False) -> None:
        """ValueError on an id outside [0, num_embeddings), in the JAX
        package's words for each planner."""
        if ids_np.size:
            with self.spans(CHECK_RANGE):
                lo, hi = int(ids_np.min()), int(ids_np.max())
            if lo < 0 or hi >= self.num_embeddings:
                if device_planner:
                    raise ValueError(
                        f"id out of range: {lo if lo < 0 else hi} not in [0, {self.num_embeddings}) \u2014 "
                        "check table-size/hash configuration")
                raise ValueError(
                    f"embedding ids out of range [0, {self.num_embeddings}): min={lo} max={hi}"
                )

    def _translate_ids(self, ids_np: np.ndarray):
        """Split a fused-global-id stream: resident ids become final device
        addresses at once; cached ids pass through to the directory. Returns
        (int32 addresses with the resident ones placed, cached-position mask,
        cached ids)."""
        self._check_range(ids_np)
        t = np.searchsorted(self._goff[1:], ids_np, side="right")
        is_res = self._is_res_table[t]
        out = np.empty(ids_np.shape, np.int32)
        out[is_res] = (ids_np[is_res] + self._res_delta[t[is_res]]).astype(np.int32)
        return out, ~is_res, np.ascontiguousarray(ids_np[~is_res], np.int32)

    def _plan_window(self, ids_np: np.ndarray):
        """Directory plan with mixed-kernel translation of a flat id stream.
        Returns (HostPlan over the cached sub-stream, full-stream addresses)."""
        if not self.resident_tables:
            self._check_range(ids_np)
            hp = self._dir.plan(ids_np)
            return hp, hp.slot_ids
        out, cached, cids = self._translate_ids(ids_np)
        hp = self._dir.plan(cids)
        out[cached] = hp.slot_ids
        return hp, out

    def _plan_window_uniform(self, ids_np: np.ndarray, P: int, Bp: int):
        """_plan_window for P stacked (F, Bp) feature-major blocks: each
        element's table is known from its position, so no per-id search."""
        self._check_range(ids_np)
        F = len(self.table_sizes)
        v = ids_np.reshape(P, F, Bp)
        res_t = np.nonzero(self._is_res_table)[0]
        cac_t = np.nonzero(~self._is_res_table)[0]
        out = np.empty((P, F, Bp), np.int32)
        if res_t.size:
            out[:, res_t, :] = v[:, res_t, :] + self._res_delta[res_t].astype(np.int32)[None, :, None]
        hp = self._dir.plan(np.ascontiguousarray(v[:, cac_t, :].reshape(-1)))
        out[:, cac_t, :] = hp.slot_ids.reshape(P, cac_t.size, Bp)
        return hp, out.reshape(-1)

    # -- the staged window API ------------------------------------------------
    def begin_window_staging(self, ids, out_shape, uniform_fbp=None) -> WindowStaging:
        """Plan a window and prepare its admits on the host. The caller then
        calls ``enqueue_writebacks`` (after the previous window's device work
        was enqueued) and ``apply_admits`` (before this window's steps).
        ``ids`` is the window's flat id stream: ``uniform_fbp`` (P, F, Bp)
        says it is P stacked (F, Bp) feature-major blocks, which spares the
        resident split a per-id table search; a ragged window's stream
        (``out_shape`` (-1,)) takes the search."""
        if self._dir is None:
            raise ValueError("staged windows require the host planner (the device planner's windows go through "
                             "begin_prepare and finish_prepare)")
        ids_np = np.ascontiguousarray(np.asarray(ids), dtype=np.int32)
        if uniform_fbp is not None and self.resident_tables:
            Pw, Fw, Bp = uniform_fbp
            if Fw != len(self.table_sizes) or Pw * Fw * Bp != ids_np.size:
                raise ValueError("uniform_fbp does not match the id stream")
            hp, slot_full = self._plan_window_uniform(ids_np, Pw, Bp)
        else:
            hp, slot_full = self._plan_window(ids_np)
        self.stats.prepare_calls += 1
        self.stats.num_hits_history.append(hp.n_hit_unique)
        n_miss = int(hp.admit_rows.shape[0])
        self.stats.num_miss_history.append(n_miss)
        D = self.dim_stored
        empty_i = np.zeros((0,), np.int32)
        empty_f = np.zeros((0,), np.float32)
        if n_miss == 0:
            return WindowStaging(
                slot_ids=slot_full.reshape(out_shape),
                synth_slots=empty_i, synth_rows=np.zeros((0,), np.int64),
                synth_bounds=empty_f, fetch_slots=empty_i, fetch_rows=np.zeros((0,), np.int64),
                fetch_payload=self._payload(np.zeros((0, D), np.float32))[0], fetch_scales=empty_f,
                fetch_accum=empty_f,
                admit_slots=hp.admit_slots, evict_rows=hp.evict_rows,
            )
        # Every in-flight writeback must land before the written-mask check:
        # a trained row's value must reach the host table before it can be
        # re-admitted, else its init value would be re-synthesized. They were
        # enqueued before the previous window's steps, so this rarely waits.
        self._ensure_clean(None, block=True)
        if self.device_init:
            with self._host_lock:
                written = self.host_table.written_mask(hp.admit_rows)
        else:
            written = np.ones((n_miss,), np.bool_)
        fresh = ~written
        synth_rows = hp.admit_rows[fresh]
        self.stats.synth_rows += int(synth_rows.shape[0])
        w_rows = hp.admit_rows[written]
        fetch_accum = empty_f
        t0 = time.perf_counter()
        if w_rows.shape[0]:
            with self._host_lock:
                vals = self.host_table.gather(w_rows)
                if self.host_accum is not None:
                    fetch_accum = self.host_accum.gather(w_rows)
        else:
            vals = np.zeros((0, D), np.float32)
        payload, scales = self._payload(vals)
        if w_rows.shape[0]:
            self.stats.swap_in_bytes += w_rows.shape[0] * self.embedding_dim * 4
            self.stats.swap_in_time += time.perf_counter() - t0
        return WindowStaging(
            slot_ids=slot_full.reshape(out_shape),
            synth_slots=hp.admit_slots[fresh], synth_rows=synth_rows,
            synth_bounds=self.host_table.row_bounds(synth_rows).astype(np.float32) if synth_rows.size else empty_f,
            fetch_slots=hp.admit_slots[written], fetch_rows=w_rows, fetch_payload=payload, fetch_scales=scales,
            fetch_accum=fetch_accum,
            admit_slots=hp.admit_slots, evict_rows=hp.evict_rows,
        )

    def _row_absmax(self, vals: np.ndarray) -> Optional[np.ndarray]:
        """Each fetched row's largest |x| over all its columns, where this bag
        stores only some of them (``parallel/column.py``); None otherwise."""
        return None

    def _payload(self, vals: np.ndarray):
        """Fetched f32 host rows in the transfer mode: (payload tensor, f32
        per-row scales, empty unless int8/int4)."""
        if self.transfer_mode == "int8":
            q, scales = _quant_rows_host(vals, self._row_absmax(vals))
            return torch.from_numpy(q), scales
        if self.transfer_mode == "int4":
            q, scales = _quant_rows_host4(vals, self._row_absmax(vals))
            return torch.from_numpy(q), scales
        t = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
        return (t.to(torch.bfloat16) if self.transfer_mode == "bfloat16" else t), np.zeros((0,), np.float32)

    def apply_admits(self, ws: WindowStaging) -> None:
        """Copy a staged window's admits to the device and land them
        (``land_admits``); the trainer ships them in its window buffer
        instead (``train/wire.py``)."""
        to_dev = self.to_device
        synth = fetch = None
        if ws.synth_slots.shape[0]:
            synth = (to_dev(ws.synth_slots.astype(np.int64)), to_dev(ws.synth_rows), to_dev(ws.synth_bounds))
        if ws.fetch_slots.shape[0]:
            quantized = self.transfer_mode in ("int8", "int4")
            fetch = (to_dev(ws.fetch_slots.astype(np.int64)), to_dev(ws.fetch_payload),
                     to_dev(ws.fetch_scales) if quantized else None,
                     to_dev(ws.fetch_accum) if self.cache_accum is not None else None)
        self.land_admits(synth, fetch)

    def land_admits(self, synth=None, fetch=None) -> None:
        """Land admits that are on the device, in place: synthesized rows
        first, then fetched rows (the order of the JAX window program).
        ``synth`` = (int64 slots, global rows, f32 bounds), their
        accumulators at ``adagrad_initial``; ``fetch`` = (int64 slots,
        payload in the transfer mode, the f32 per-row scales of int8/int4
        payloads, the f32 accumulators under Adagrad)."""
        if synth is not None:
            slots, rows, bounds = synth
            scatter_synth_admits(self.cache_weight, slots, rows, bounds, self._seed, col_start=self.col_start)
            if self.cache_accum is not None:
                self.cache_accum.index_fill_(0, slots, self.adagrad_initial)
        if fetch is not None:
            slots, payload, scales, accum = fetch
            if self.transfer_mode == "int8":
                scatter_admits_q8(self.cache_weight, slots, payload, scales)
            elif self.transfer_mode == "int4":
                scatter_admits_q4(self.cache_weight, slots, payload, scales)
            else:
                scatter_admits(self.cache_weight, slots, payload)
            if self.cache_accum is not None:
                self.cache_accum.index_copy_(0, slots, accum)

    def enqueue_writebacks(self, ws: WindowStaging, slots: Optional[torch.Tensor] = None) -> None:
        """Enqueue the device gathers of this window's evicted occupants and
        their copies to pinned host memory. MUST run after the previous
        window's steps are enqueued (so the values read are their outputs) and
        before this window's admits (which overwrite the slots). ``slots``:
        the evicted rows' slots already on the device (the trainer ships them
        in the window's buffer), else copied here."""
        mask = ws.evict_rows >= 0
        n_wb = int(mask.sum())
        self.stats.num_write_back_history.append(n_wb)
        if n_wb == 0:
            self._ensure_clean(None, block=False)
            return
        # writebacks land in the f32 host master at >= bf16, never int8/int4
        # (a fresh quantization each evict/re-admit cycle would compound)
        self._enqueue_gather(ws.evict_rows[mask], ws.admit_slots[mask], self.writeback_dtype, slots)
        self._submit_writebacks()

    def _enqueue_gather(self, rows: np.ndarray, slots_np: np.ndarray, out_dtype, slots=None) -> None:
        """Enqueue the gather of the evicted ``rows`` from their slots (on the
        device as ``slots``, else copied from ``slots_np``), in ``out_dtype``,
        and its copy to pinned memory behind an event; the drain thread
        writes them to the host table."""
        if slots is None:
            slots = self.to_device(slots_np.astype(np.int64))
        vals_dev = gather_slots(self.cache_weight, slots, out_dtype=out_dtype)
        host = self._pinned(vals_dev.shape, vals_dev.dtype)
        host.copy_(vals_dev, non_blocking=self._on_cuda)
        self.stats.d2h_bytes += host.nbytes
        host_acc = None
        if self.cache_accum is not None:  # the accumulators ride behind the same event
            acc_dev = self.cache_accum.index_select(0, slots)
            host_acc = self._pinned(acc_dev.shape, torch.float32)
            host_acc.copy_(acc_dev, non_blocking=self._on_cuda)
            self.stats.d2h_bytes += host_acc.nbytes
        event = None
        if self._on_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._pending_wb.append((rows, host, host_acc, event))

    def _submit_writebacks(self) -> None:
        items, self._pending_wb = self._pending_wb, []
        if not items:
            return
        rows = np.concatenate([item[0] for item in items])
        self._wb_futures.append((self._wb_exec.submit(self._do_drain, items), rows))

    def _do_drain(self, items) -> None:
        t0 = time.perf_counter()
        for ev_rows, host, host_acc, event in items:
            if event is not None:
                event.synchronize()  # the device gathers and copies have run
            vals = host.float().numpy()
            with self._host_lock:
                self.host_table.scatter(ev_rows, vals)
                if host_acc is not None:
                    self.host_accum.scatter(ev_rows, host_acc.numpy())
            self.stats.swap_out_bytes += ev_rows.shape[0] * self.embedding_dim * 4
        self.stats.swap_out_time += time.perf_counter() - t0

    def _ensure_clean(self, admit_rows: Optional[np.ndarray], block: bool) -> None:
        """Wait for in-flight writebacks that intersect ``admit_rows`` (or all
        of them when ``block``); re-raise any drain failure."""
        still = []
        for fut, rows in self._wb_futures:
            if fut.done() or block or (admit_rows is not None and np.isin(admit_rows, rows).any()):
                fut.result()
            else:
                still.append((fut, rows))
        self._wb_futures = still

    def _drain_writebacks(self) -> None:
        """Synchronous full drain: all in-flight and pending writebacks land."""
        self._ensure_clean(None, block=True)
        items, self._pending_wb = self._pending_wb, []
        if items:
            self._do_drain(items)

    # -- the device planner's windows -------------------------------------------
    def begin_prepare(self, ids, out_shape=None) -> PreparedWindow:
        """Plan a window on the device without moving rows (device planner):
        check the ids' range on the host (ValueError), enqueue ``plan_ids``
        and the remap, then the copies of the plan's scalars and index block
        into host memory and an event after them. Waits for no device work
        when ``ids`` are on the host. The caller then calls
        ``finish_prepare``, after the device work that reads the slots the
        plan evicts has been enqueued."""
        if self._dir is not None:
            raise ValueError("begin_prepare plans on the device: the host planner stages windows with "
                             "begin_window_staging")
        if isinstance(ids, torch.Tensor) and ids.device.type != "cpu":
            ids_dev = ids.reshape(-1).to(device=self.device, dtype=torch.int32)
            if ids_dev.numel():
                self._check_range(np.asarray([int(x) for x in torch.aminmax(ids_dev)]), device_planner=True)
        else:
            ids_np = np.asarray(ids).reshape(-1)
            self._check_range(ids_np, device_planner=True)
            ids_dev = self.to_device(ids_np.astype(np.int32))
        budget = self.unique_budget or ids_dev.shape[0]
        events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(3)) if self._on_cuda else None
        if events:
            events[0].record()
        self.state, plan = plan_ids(self.state, ids_dev, self.dataset_freq, unique_budget=budget,
                                    strategy=self.evict_strategy, approx_evict=self.approx_evict)
        slot_ids = remap_ids(self.state, ids_dev)
        if events:
            events[1].record()
        host_scalars = self._pinned(plan.scalars.shape, torch.int32)
        host_indices = self._pinned(plan.indices.shape, torch.int32)
        host_scalars.copy_(plan.scalars, non_blocking=self._on_cuda)
        host_indices.copy_(plan.indices, non_blocking=self._on_cuda)
        self.stats.d2h_bytes += host_scalars.nbytes + host_indices.nbytes
        if events:
            events[2].record()
        return PreparedWindow(slot_ids=slot_ids.reshape(out_shape) if out_shape is not None else slot_ids,
                              plan=plan, budget=int(budget), host_scalars=host_scalars, host_indices=host_indices,
                              events=events)

    def finish_prepare(self, pw: PreparedWindow) -> None:
        """Move a planned window's rows: wait for its readback (the event
        ``begin_prepare`` recorded, nothing later), raise RuntimeError where
        the window's distinct ids overflow its unique budget or the cache,
        then enqueue, in chunks of ``buffer_size``, the gathers of the evicted
        rows (copied to pinned memory for the drain thread) and the scatters
        of the admitted rows fetched from the host table."""
        if pw.events:
            pw.events[2].synchronize()
        scal = pw.host_scalars.numpy()
        n_miss, n_unique, cap_ok = int(scal[0]), int(scal[1]), bool(scal[2])
        U = min(pw.budget, self.capacity)
        if n_unique > U:
            raise RuntimeError(
                f"prepare_ids overflow: {n_unique} unique ids > unique budget {U} (capacity {self.capacity}). "
                "Reduce prefetch_num/batch or raise cache_ratio/unique_budget.")
        if not cap_ok:
            raise RuntimeError(f"cache capacity exhausted: working set of this prepare_ids call needs more than "
                               f"{self.capacity} slots.")
        self.stats.prepare_calls += 1
        self.stats.num_hits_history.append(int(scal[3]))
        self.stats.num_miss_history.append(n_miss)
        if n_miss == 0:
            self.stats.num_write_back_history.append(0)
            self._ensure_clean(None, block=False)
            return
        idx = pw.host_indices.numpy()
        admit_rows = idx[0, :n_miss].astype(np.int64)
        admit_slots, evict_rows = idx[1, :n_miss], idx[2, :n_miss]
        # a row evicted by an earlier window may come back now: its writeback lands first
        self._ensure_clean(admit_rows, block=False)
        wb_dtype = torch.bfloat16 if self.transfer_mode == "bfloat16" else None
        chunk = self.buffer_size if self.buffer_size > 0 else n_miss
        n_wb = 0
        for s in range(0, n_miss, chunk):
            e = min(s + chunk, n_miss)
            mask = evict_rows[s:e] >= 0
            if mask.any():
                self._enqueue_gather(evict_rows[s:e][mask], admit_slots[s:e][mask], wb_dtype)
                n_wb += int(mask.sum())
            t0 = time.perf_counter()
            with self._host_lock:
                vals = self.host_table.gather(admit_rows[s:e])
            scatter_admits(self.cache_weight, pw.plan.indices[1, s:e].long(),
                           self.to_device(torch.from_numpy(vals).to(self._row_dtype)))
            self.stats.swap_in_bytes += (e - s) * self.embedding_dim * 4
            self.stats.swap_in_time += time.perf_counter() - t0
        self.stats.num_write_back_history.append(n_wb)
        self._submit_writebacks()

    # -- bare-module API --------------------------------------------------------
    def prepare_ids(self, ids) -> torch.Tensor:
        """Make every id resident and return the ids remapped to device
        addresses (the reference's ``cache_weight_mgr.prepare_ids``)."""
        if self._dir is None:
            pw = self.begin_prepare(ids, tuple(ids.shape) if isinstance(ids, torch.Tensor) else np.shape(ids))
            self.finish_prepare(pw)
            return pw.slot_ids
        ids_np = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
        ws = self.begin_window_staging(ids_np, ids_np.shape)
        self.enqueue_writebacks(ws)
        self.apply_admits(ws)
        return self.to_device(ws.slot_ids)

    def lookup(self, features: RaggedFeatures) -> torch.Tensor:
        """Pooled lookup of device-address features, uniform or ragged: (B, F, D)."""
        return embedding_bag(self.cache_weight, features, mode=self.mode)

    def forward(self, values, offsets=None, per_sample_weights=None, shape_hook: Optional[Callable] = None, *,
                num_features: int = 1, batch_size: Optional[int] = None) -> torch.Tensor:
        """EmbeddingBag-style forward of the bare module: (B, F, D) bags of
        ``values`` split by ``offsets`` (``include_last_offset`` semantics;
        without offsets one id a bag). With ``cache_op`` on the values are
        global ids and the cache is maintained first (``prepare_ids``);
        otherwise they are slot ids already. ``shape_hook`` maps the output."""
        values = torch.as_tensor(np.asarray(values.cpu() if isinstance(values, torch.Tensor) else values),
                                 dtype=torch.int32)
        values = self.prepare_ids(values) if self.cache_op else self.to_device(values)
        if offsets is not None:
            offsets = torch.as_tensor(np.asarray(offsets.cpu() if isinstance(offsets, torch.Tensor) else offsets),
                                      dtype=torch.int32)
            if not self.include_last_offset:  # the trailing boundary torch's EmbeddingBag leaves out
                offsets = torch.cat([offsets, torch.tensor([values.shape[0]], dtype=torch.int32)])
            offsets = self.to_device(offsets)
        if batch_size is None:
            nb = offsets.shape[0] - 1 if offsets is not None else values.shape[0]
            batch_size = nb // num_features
        feats = RaggedFeatures(values=values, offsets=offsets, num_features=num_features, batch_size=batch_size,
                               pooling=1 if offsets is None else None)
        psw = None if per_sample_weights is None else self.to_device(
            torch.as_tensor(np.asarray(per_sample_weights, np.float32)))
        out = embedding_bag(self.cache_weight, feats, mode=self.mode, per_sample_weights=psw)
        return shape_hook(out) if shape_hook is not None else out

    __call__ = forward

    # -- flush ----------------------------------------------------------------
    def _flush_resident(self) -> None:
        """Write the resident region back to the host table."""
        if not self.resident_total:
            return
        R = self.resident_total
        chunk = self.buffer_size if self.buffer_size > 0 else (1 << 17)
        for s in range(0, R, chunk):
            e = min(s + chunk, R)
            vals = self.cache_weight[self.capacity + s : self.capacity + e].float().cpu().numpy()
            self.host_table.scatter(self._res_rows[s:e], vals)
            if self.cache_accum is not None:
                self.host_accum.scatter(self._res_rows[s:e], self.cache_accum[self.capacity + s : self.capacity + e].cpu().numpy())
        self.stats.swap_out_bytes += R * self.embedding_dim * 4

    def flush(self) -> None:
        """Write every cached and resident row back to the host table."""
        self._drain_writebacks()
        self._flush_resident()
        slots, rows = self.resident()
        if slots.size == 0:
            return
        t0 = time.perf_counter()
        slots_dev = self.to_device(slots.astype(np.int64))
        vals = gather_slots(self.cache_weight, slots_dev)
        self.host_table.scatter(rows, vals.float().cpu().numpy())
        if self.cache_accum is not None:
            self.host_accum.scatter(rows, self.cache_accum.index_select(0, slots_dev).cpu().numpy())
        self.stats.swap_out_bytes += slots.size * self.embedding_dim * 4
        self.stats.swap_out_time += time.perf_counter() - t0

    def resident(self):
        """(slots, rows) of every cached row, as host arrays, from either
        planner's directory."""
        if self._dir is not None:
            return self._dir.resident()
        s2r = self.state.slot_to_row.cpu().numpy()
        slots = np.flatnonzero(s2r >= 0).astype(np.int32)
        return slots, s2r[slots].astype(np.int64)

    def dense_weight(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Logically consistent host rows (flushes first): ``rows`` of the
        table, or the whole table."""
        self.flush()
        if rows is None:
            if isinstance(self.host_table, DenseHostTable):
                return self.host_table.array
            rows = np.arange(self.num_embeddings, dtype=np.int64)
        return self.host_table.gather(np.asarray(rows, np.int64))

    def print_comm_stats(self) -> None:
        print(self.stats.summary())

    def set_accum(self, cache_accum: torch.Tensor) -> None:
        """Rebind the device accumulators (the JAX package's ``set_accum``)."""
        if self.cache_accum is None or cache_accum.shape != self.cache_accum.shape:
            raise ValueError("set_accum: the bag keeps no accumulators of that shape")
        self.cache_accum = cache_accum.to(device=self.device, dtype=torch.float32)

    def reset_cache(self) -> None:
        """Drop the cache's contents and directory and warm it again from the
        id-frequency map (cache contents are derived state: used after a
        checkpoint load has replaced the host table)."""
        self._drain_writebacks()
        if self._dir is None:
            self.state = init_cache_state(self.num_embeddings, self.capacity, self.device)
        else:
            self._dir = make_directory(self.num_embeddings, self.capacity, self.evict_strategy)
            if self._host_freq is not None and self.evict_strategy == EvictionStrategy.DATASET:
                self._dir.set_dataset_freq(self._host_freq)
        self.cache_weight.zero_()
        if self.cache_accum is not None:
            self.cache_accum.fill_(self.adagrad_initial)
        if self.resident_total:
            self._init_resident_region()
        if self._host_freq is not None and self.warmup_ratio > 0:
            self._warmup(self.warmup_ratio)

    def close(self) -> None:
        """Land outstanding writebacks and stop the drain thread."""
        self._drain_writebacks()
        self._wb_exec.shutdown(wait=True)
