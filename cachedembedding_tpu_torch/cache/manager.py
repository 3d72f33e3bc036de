"""CachedEmbeddingBag — host-DRAM embedding table with a GPU hot-row cache
(counterpart of ``cachedembedding_tpu/cache/manager.py``, host-planner slice).

The full ``(num_embeddings, dim)`` table lives in host DRAM (a dense numpy
array or a virtual procedural table); ``int(cache_ratio * cached_rows)`` rows
are resident in the device tensor ``cache_weight``, optionally followed by a
region that holds small tables whole (``resident_tables``).

Split of responsibilities:
  * host (this class): the C++ directory plans each window, rows to admit are
    split into never-trained rows (synthesized on the GPU from their id) and
    trained rows (gathered from the host table), evicted rows are read back
    and written to the host table by a drain thread;
  * device: admit scatters, writeback gathers, lookups, and the update.

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
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cachedembedding_tpu_torch import resolve_device
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.host_directory import make_directory
from cachedembedding_tpu_torch.cache.host_table import DenseHostTable, VirtualHostTable
from cachedembedding_tpu_torch.cache.state import EvictionStrategy, gather_slots, scatter_admits
from cachedembedding_tpu_torch.jagged import RaggedFeatures
from cachedembedding_tpu_torch.ops.embedding_bag import embedding_bag
from cachedembedding_tpu_torch.ops.synth_rows import scatter_synth_admits

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    def hit_rate(self) -> float:
        tot = sum(self.num_hits_history) + sum(self.num_miss_history)
        return sum(self.num_hits_history) / tot if tot else 0.0


class WindowStaging(NamedTuple):
    """Everything needed to make one window's rows resident, prepared on the
    host by ``begin_window_staging``: never-trained admits (synthesized on the
    device) and fetched admits (host-table rows, in the transfer dtype)."""

    slot_ids: np.ndarray       # remapped ids, in the caller's out_shape
    synth_slots: np.ndarray    # (ns,) int32
    synth_rows: np.ndarray     # (ns,) int64 global rows
    synth_bounds: np.ndarray   # (ns,) float32
    fetch_slots: np.ndarray    # (nf,) int32
    fetch_payload: torch.Tensor  # (nf, D) transfer dtype, pinned on CUDA
    admit_slots: np.ndarray    # (n_miss,) full plan arrays for the writebacks
    evict_rows: np.ndarray     # (n_miss,)


def default_table_init(table_sizes: Sequence[int], seed: int):
    """Per-table U(-1/sqrt(n), 1/sqrt(n)) init by the canonical per-(row, col,
    seed) hash, so dense tables, virtual tables and the device agree."""

    def init(host_weight: np.ndarray) -> None:
        off = 0
        for n in table_sizes:
            hostops.fill_rows_canonical(host_weight[off : off + n], off, seed, float(n) ** -0.5)
            off += n

    return init


class CachedEmbeddingBag:
    """Frequency-aware software-cached EmbeddingBag (single device, host planner).

    Runs on ``device`` (default: the current CUDA device; with no GPU and no
    explicit ``device="cpu"`` this raises)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        *,
        mode: str = "sum",
        cache_ratio: float = 0.01,
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
    ):
        self.device = resolve_device(device)
        if transfer_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"transfer_dtype={transfer_dtype!r}: int8/int4 admit payloads are "
                "ROADMAP Queue 1 item 4"
            )
        if isinstance(dtype, str):
            if dtype not in _CACHE_DTYPES:
                raise NotImplementedError(
                    f"cache dtype {dtype!r}: fp8 cache rows are ROADMAP Queue 1 item 7"
                )
            dtype = _CACHE_DTYPES[dtype]
        if dtype not in _CACHE_DTYPES.values():
            raise NotImplementedError(f"cache dtype {dtype}: fp8 cache rows are ROADMAP Queue 1 item 7")
        if mode not in ("sum", "mean"):
            raise ValueError(f"unsupported mode {mode!r}")
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.mode = mode
        self.dtype = dtype

        # --- mixed-kernel resident region ---------------------------------
        sizes = list(table_sizes) if table_sizes is not None else [self.num_embeddings]
        if sum(sizes) != self.num_embeddings:
            raise ValueError("table_sizes must sum to num_embeddings")
        self.table_sizes = sizes
        self.resident_tables = sorted(set(int(t) for t in (resident_tables or [])))
        if not all(0 <= t < len(sizes) for t in self.resident_tables):
            raise ValueError(f"resident_tables out of range: {self.resident_tables}")
        goff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._goff = goff
        self.resident_total = int(sum(sizes[t] for t in self.resident_tables))
        num_cached_rows = self.num_embeddings - self.resident_total
        self.capacity = max(1, min(int(cache_ratio * num_cached_rows), max(num_cached_rows, 1)))
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
        if weight_init == "virtual":
            self.host_table = VirtualHostTable(
                self.table_sizes, self.embedding_dim, seed=seed,
                capacity_hint=max(4 * self.capacity, 1 << 16),
            )
        elif weight_init == "uniform":
            arr = np.empty((self.num_embeddings, self.embedding_dim), np.float32)
            default_table_init(self.table_sizes, seed)(arr)
            self.host_table = DenseHostTable(arr, procedural_seed=seed, table_sizes=self.table_sizes)
        elif weight_init == "zeros":
            self.host_table = DenseHostTable(
                np.zeros((self.num_embeddings, self.embedding_dim), np.float32)
            )
        else:
            raise ValueError(f"unknown weight_init {weight_init!r}")

        self._dir = make_directory(self.num_embeddings, self.capacity, evict_strategy)
        self.cache_weight = torch.zeros(
            (self.capacity + self.resident_total, self.embedding_dim), dtype=dtype, device=self.device
        )

        if ids_freq_mapping is not None:
            freq = np.ascontiguousarray(ids_freq_mapping, dtype=np.int64)
            if freq.shape != (self.num_embeddings,):
                raise ValueError("ids_freq_mapping must have one entry per row")
            self._host_freq = freq
            if evict_strategy == EvictionStrategy.DATASET:
                self._dir.set_dataset_freq(freq)
        else:
            self._host_freq = None
            if evict_strategy == EvictionStrategy.DATASET:
                raise ValueError("DATASET eviction requires ids_freq_mapping")

        self.device_init = getattr(self.host_table, "supports_device_init", False)
        self._seed = int(getattr(self.host_table, "seed", 0) or 0)

        # Warmup never spends cache slots on resident rows.
        if self.resident_tables and self._host_freq is not None:
            wf = self._host_freq.copy()
            for t in self.resident_tables:
                wf[goff[t] : goff[t + 1]] = 0
            self._warm_freq = wf
        else:
            self._warm_freq = self._host_freq

        self.stats = CacheStats()
        self.transfer_dtype = _CACHE_DTYPES[transfer_dtype]
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
        """Asynchronous host->device copy of a numpy array or CPU tensor. On
        CUDA the source is staged in pinned memory, so the copy never waits for
        earlier device work; the caching host allocator keeps the pinned block
        alive until the copy has run."""
        src = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
        if not self._on_cuda:
            return src.clone()
        if not src.is_pinned():
            pinned = self._pinned(src.shape, src.dtype)
            pinned.copy_(src)
            src = pinned
        return src.to(self.device, non_blocking=True)

    @property
    def device_rows(self) -> int:
        """Total rows of the device array: cache slots + resident region."""
        return self.capacity + self.resident_total

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
        self._dir.warmup(top, warm_freq)
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
                self._seed,
            )
            self.stats.synth_rows += n_fresh
        if n_fresh < k:
            rows = self.host_table.gather(top[written])
            scatter_admits(
                self.cache_weight,
                self.to_device(slots[written].astype(np.int64)),
                self.to_device(torch.from_numpy(rows).to(self.transfer_dtype)),
            )
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
                self._seed,
            )
        if written.any():
            vals = self.host_table.gather(rows[written])
            scatter_admits(
                self.cache_weight,
                self.to_device(addrs[written]),
                self.to_device(torch.from_numpy(vals).to(self.transfer_dtype)),
            )
            self.stats.swap_in_bytes += vals.nbytes

    def _check_range(self, ids_np: np.ndarray) -> None:
        if ids_np.size:
            lo, hi = int(ids_np.min()), int(ids_np.max())
            if lo < 0 or hi >= self.num_embeddings:
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
        was enqueued) and ``apply_admits`` (before this window's steps)."""
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
        D = self.embedding_dim
        empty_i = np.zeros((0,), np.int32)
        if n_miss == 0:
            return WindowStaging(
                slot_ids=slot_full.reshape(out_shape),
                synth_slots=empty_i, synth_rows=np.zeros((0,), np.int64),
                synth_bounds=np.zeros((0,), np.float32), fetch_slots=empty_i,
                fetch_payload=torch.zeros((0, D), dtype=self.transfer_dtype),
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
        payload = self._pinned((w_rows.shape[0], D), self.transfer_dtype)
        if w_rows.shape[0]:
            t0 = time.perf_counter()
            with self._host_lock:
                vals = self.host_table.gather(w_rows)
            payload.copy_(torch.from_numpy(vals))
            self.stats.swap_in_bytes += w_rows.shape[0] * D * 4
            self.stats.swap_in_time += time.perf_counter() - t0
        return WindowStaging(
            slot_ids=slot_full.reshape(out_shape),
            synth_slots=hp.admit_slots[fresh], synth_rows=synth_rows,
            synth_bounds=self.host_table.row_bounds(synth_rows).astype(np.float32),
            fetch_slots=hp.admit_slots[written], fetch_payload=payload,
            admit_slots=hp.admit_slots, evict_rows=hp.evict_rows,
        )

    def apply_admits(self, ws: WindowStaging) -> None:
        """Land a staged window's admits on the device: synthesized rows
        first, then fetched rows (the order of the JAX window program)."""
        if ws.synth_slots.shape[0]:
            scatter_synth_admits(
                self.cache_weight,
                self.to_device(ws.synth_slots.astype(np.int64)),
                self.to_device(ws.synth_rows),
                self.to_device(ws.synth_bounds),
                self._seed,
            )
        if ws.fetch_slots.shape[0]:
            scatter_admits(
                self.cache_weight,
                self.to_device(ws.fetch_slots.astype(np.int64)),
                self.to_device(ws.fetch_payload),
            )

    def enqueue_writebacks(self, ws: WindowStaging) -> None:
        """Enqueue the device gathers of this window's evicted occupants and
        their copies to pinned host memory. MUST run after the previous
        window's steps are enqueued (so the values read are their outputs) and
        before this window's admits (which overwrite the slots)."""
        mask = ws.evict_rows >= 0
        n_wb = int(mask.sum())
        self.stats.num_write_back_history.append(n_wb)
        if n_wb == 0:
            self._ensure_clean(None, block=False)
            return
        # writebacks land in the f32 host master at >= bf16
        slots = self.to_device(ws.admit_slots[mask].astype(np.int64))
        vals_dev = gather_slots(self.cache_weight, slots, out_dtype=self.transfer_dtype)
        host = self._pinned(vals_dev.shape, vals_dev.dtype)
        host.copy_(vals_dev, non_blocking=self._on_cuda)
        event = None
        if self._on_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._pending_wb.append((ws.evict_rows[mask], host, event))
        self._submit_writebacks()

    def _submit_writebacks(self) -> None:
        items, self._pending_wb = self._pending_wb, []
        if not items:
            return
        rows = np.concatenate([item[0] for item in items])
        self._wb_futures.append((self._wb_exec.submit(self._do_drain, items), rows))

    def _do_drain(self, items) -> None:
        t0 = time.perf_counter()
        for ev_rows, host, event in items:
            if event is not None:
                event.synchronize()  # the device gather and copy have run
            vals = host.float().numpy()
            with self._host_lock:
                self.host_table.scatter(ev_rows, vals)
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

    # -- bare-module API --------------------------------------------------------
    def prepare_ids(self, ids) -> torch.Tensor:
        """Make every id resident and return the ids remapped to device
        addresses (the reference's ``cache_weight_mgr.prepare_ids``)."""
        ids_np = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
        ws = self.begin_window_staging(ids_np, ids_np.shape)
        self.enqueue_writebacks(ws)
        self.apply_admits(ws)
        return self.to_device(ws.slot_ids)

    def lookup(self, features: RaggedFeatures) -> torch.Tensor:
        """Pooled lookup of device-address features: (B, F, D)."""
        return embedding_bag(self.cache_weight, features, mode=self.mode)

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
        self.stats.swap_out_bytes += R * self.embedding_dim * 4

    def flush(self) -> None:
        """Write every cached and resident row back to the host table."""
        self._drain_writebacks()
        self._flush_resident()
        slots, rows = self._dir.resident()
        if slots.size == 0:
            return
        t0 = time.perf_counter()
        vals = gather_slots(self.cache_weight, self.to_device(slots.astype(np.int64)))
        self.host_table.scatter(rows, vals.float().cpu().numpy())
        self.stats.swap_out_bytes += slots.size * self.embedding_dim * 4
        self.stats.swap_out_time += time.perf_counter() - t0

    def dense_weight(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Logically consistent host rows (flushes first): ``rows`` of the
        table, or the whole table."""
        self.flush()
        if rows is None:
            if isinstance(self.host_table, DenseHostTable):
                return self.host_table.array
            rows = np.arange(self.num_embeddings, dtype=np.int64)
        return self.host_table.gather(np.asarray(rows, np.int64))

    def close(self) -> None:
        """Land outstanding writebacks and stop the drain thread."""
        self._drain_writebacks()
        self._wb_exec.shutdown(wait=True)
