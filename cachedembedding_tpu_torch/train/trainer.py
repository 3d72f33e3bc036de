"""Single-device trainer: cached embedding + DLRM dense towers (counterpart of
``cachedembedding_tpu/train/trainer.py``, uniform-window slice).

Far-sighted prefetch: every ``prefetch_num`` batches form a window whose ids
are planned once by the host directory. Per window, in order:

  1. the host plans and stages window k+1 while the GPU runs window k (the
     staging, its host->device copies and the writeback gathers of window
     k+1's evictions are enqueued right after window k's steps);
  2. the admits land: synthesized rows first, then fetched rows;
  3. each step gathers its rows with Kernel 1 (``ops/gather_rows.py``) into
     the (B, F, D) layout, in the cache's storage dtype;
  4. the dense forward and backward run, with the gradient taken with respect
     to the gathered rows;
  5. the row gradients are cast to the cache dtype;
  6. Kernel 2 (``ops/binned_scatter.py``) applies the update in place, from a
     bin-grouping plan the host computed for the step;
  7. dense SGD follows.

The JAX package fuses a window into one ``lax.scan``; here a window is a
Python loop of asynchronous launches on one CUDA stream, and losses are read
back once, at the end. ``evaluate`` runs the same window machinery with the
grouping plans suspended and scores with Kernel 1 lookups.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch import resolve_device
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag, WindowStaging
from cachedembedding_tpu_torch.cache.state import EvictionStrategy
from cachedembedding_tpu_torch.config import DLRMConfig
from cachedembedding_tpu_torch.jagged import Batch, concat_uniform_values
from cachedembedding_tpu_torch.models.dlrm import DLRM, bce_with_logits
from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update, sort_plan_np
from cachedembedding_tpu_torch.ops.embedding_bag import pool_uniform
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics

_EVAL_READBACK_STEPS = 32  # eval scores stay on the device this many steps
_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _refuse_outside_slice(cfg: DLRMConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every option
    the port does not run yet."""
    c = cfg.cache
    refusals = [
        (cfg.model != "dlrm", f"model={cfg.model!r}: DeepFM is ROADMAP Queue 1 item 3"),
        (cfg.interaction_impl != "bmm", "interaction_impl='gather' is ROADMAP Queue 1 item 3"),
        (tuple(cfg.mesh_shape) != (1,) or cfg.use_tablewise,
         "the mesh (data/model parallel) is ROADMAP Queue 1 item 9"),
        (cfg.embedding_optimizer != "sgd", "rowwise_adagrad is ROADMAP Queue 1 item 7"),
        (cfg.use_sparse_embed_grad, "use_sparse_embed_grad is ROADMAP Queue 1 item 7"),
        (cfg.compute_dtype not in _FLOAT_DTYPES, f"compute_dtype={cfg.compute_dtype!r} is not supported"),
        (cfg.dense_input_dtype not in _FLOAT_DTYPES,
         f"dense_input_dtype={cfg.dense_input_dtype!r}: int8/int4 dense inputs are ROADMAP Queue 1 item 8"),
        (c.transfer_dtype not in _FLOAT_DTYPES,
         f"transfer_dtype={c.transfer_dtype!r}: int8/int4 transfers are ROADMAP Queue 1 item 4"),
        (c.cache_dtype not in _FLOAT_DTYPES,
         f"cache_dtype={c.cache_dtype!r}: fp8 cache rows are ROADMAP Queue 1 item 7"),
        (c.stochastic_rounding == "on", "stochastic rounding is ROADMAP Queue 1 item 7"),
        (not c.ship_sort_perm,
         "ship_sort_perm=False: the port's update is the binned kernel; the scatter "
         "update path is ROADMAP Queue 1 item 5"),
        (c.planner == "device", "the device planner is ROADMAP Queue 1 item 11"),
    ]
    for bad, msg in refusals:
        if bad:
            raise NotImplementedError(msg)


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    it_per_s: float
    examples_per_s: float
    hit_rate: float
    window_host_s: List[float]    # host seconds per window: data, plan, staging
    window_device_s: List[float]  # device seconds per window (CUDA events); empty on the CPU


class _Window(NamedTuple):
    """One staged window, its inputs already enqueued to the device."""

    staging: WindowStaging
    slot_ids: torch.Tensor  # (P, L) int32 feature-major device addresses
    dense: torch.Tensor     # (P, B, Din) float32
    labels: torch.Tensor    # (P, B) float32
    plan: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # perm, grouped, bins


class CachedDLRMTrainer:
    """Cached DLRM training and evaluation on one device (default: the
    current CUDA device; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, cfg: DLRMConfig, id_freq_map: Optional[np.ndarray] = None, device=None):
        _refuse_outside_slice(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        c = cfg.cache
        resident = (
            [i for i, n in enumerate(cfg.num_embeddings_per_feature) if n <= c.resident_threshold]
            if c.resident_threshold > 0 else None
        )
        use_dataset = not c.use_lfu_eviction and c.use_freq and id_freq_map is not None
        self.embed = CachedEmbeddingBag(
            cfg.total_num_embeddings,
            cfg.embedding_dim,
            mode=cfg.reduction_mode,
            cache_ratio=c.cache_ratio,
            ids_freq_mapping=id_freq_map if c.use_freq else None,
            warmup_ratio=c.warmup_ratio,
            buffer_size=c.buffer_size,
            evict_strategy=EvictionStrategy.DATASET if use_dataset else EvictionStrategy.LFU,
            table_sizes=cfg.num_embeddings_per_feature,
            seed=cfg.seed,
            dtype=_FLOAT_DTYPES[c.cache_dtype],
            weight_init=c.weight_init,
            transfer_dtype=c.transfer_dtype,
            device=self.device,
            resident_tables=resident,
        )
        self.model = DLRM(
            cfg.embedding_dim,
            cfg.num_sparse_features,
            cfg.dense_in_features,
            cfg.dense_arch_layer_sizes,
            cfg.over_arch_layer_sizes,
            compute_dtype=_FLOAT_DTYPES[cfg.compute_dtype],
            interaction_impl=cfg.interaction_impl,
            seed=cfg.seed,
            device=self.device,
        )
        self.data_parallel_size = int(np.prod(cfg.mesh_shape))
        self._dense_dtype = _FLOAT_DTYPES[cfg.dense_input_dtype]

    # ------------------------------------------------------------------
    def _lrs(self, progress: float) -> Tuple[float, float]:
        """(sparse LR, dense LR): the dense LR scales with the data-parallel size."""
        cfg = self.cfg
        lr = cfg.learning_rate
        if cfg.change_lr and progress >= cfg.lr_change_point:
            lr = cfg.lr_after
        return lr, lr * self.data_parallel_size

    def _device_rows(self) -> int:
        """Row count of the device embedding array (cache slots + resident region)."""
        return self.embed.device_rows

    def _begin_window(self, batches: List[Batch], with_plan: bool = True) -> _Window:
        """Plan and stage a uniform window, then enqueue its inputs to the
        device: remapped ids, dense features (in ``dense_input_dtype``),
        labels, and (``with_plan``) per-step grouping plans for the update."""
        f0 = batches[0].sparse_features
        F, B, Pool = f0.num_features, f0.batch_size, f0.pooling
        if Pool is None or any(
            b.sparse_features.pooling != Pool or b.sparse_features.offsets is not None
            or b.sparse_features.num_features != F or b.sparse_features.batch_size != B
            for b in batches
        ):
            raise NotImplementedError("ragged windows are ROADMAP Queue 1 item 7")
        P = len(batches)
        all_ids = concat_uniform_values(batches)
        L = all_ids.shape[0] // P
        N = L // F
        ws = self.embed.begin_window_staging(all_ids, (P, L), uniform_fbp=(P, F, N))
        to_dev = self.embed.to_device
        dense = torch.stack([b.dense_features for b in batches]).to(self._dense_dtype)
        labels = torch.stack([b.labels for b in batches]).to(torch.uint8)
        plan = None
        if with_plan:
            NR = self._device_rows()
            # the update's stream is the gathered rows' order: (N, F)
            steps = [sort_plan_np(ws.slot_ids[p].reshape(F, N).T, NR) for p in range(P)]
            plan = tuple(to_dev(np.stack(a)) for a in zip(*steps))
        return _Window(
            staging=ws,
            slot_ids=to_dev(ws.slot_ids),
            dense=to_dev(dense).float(),
            labels=to_dev(labels).float(),
            plan=plan,
        )

    def _finish_window(self, win: _Window) -> None:
        """Enqueue the window's eviction writebacks (after the previous
        window's steps, before this window's admits)."""
        self.embed.enqueue_writebacks(win.staging)

    def _gathered_rows(self, win: _Window, p: int) -> torch.Tensor:
        """Kernel 1 lookup of step p: (B*P, F, D) rows in the storage dtype."""
        return gather_rows(self.embed.cache_weight, win.slot_ids[p], self.cfg.num_sparse_features)

    def _dispatch_window(self, win: _Window, progresses: List[float]) -> torch.Tensor:
        """Land the admits and enqueue every step of the window. Returns the
        (P,) per-step losses (device tensor, not yet read back)."""
        self.embed.apply_admits(win.staging)
        cw = self.embed.cache_weight
        perms, groupeds, bins = win.plan
        B = win.labels.shape[1]
        params = list(self.model.parameters())
        losses = []
        for p, progress in enumerate(progresses):
            slr, dlr = self._lrs(progress)
            rows = self._gathered_rows(win, p).requires_grad_(True)
            sparse = pool_uniform(rows, B, self.cfg.reduction_mode)
            loss = bce_with_logits(self.model(win.dense[p], sparse), win.labels[p])
            loss.backward()
            g_rows = rows.grad.reshape(-1, cw.shape[1]).to(cw.dtype)
            binned_sgd_update(cw, g_rows, perms[p], groupeds[p], bins[p], slr)
            with torch.no_grad():
                for prm in params:
                    prm.sub_(prm.grad * dlr)
                    prm.grad = None
            losses.append(loss.detach())
        return torch.stack(losses)

    def train(self, data: Iterable[Batch], num_iters: Optional[int] = None) -> TrainReport:
        """Pipelined far-sighted training over uniform windows."""
        pn = max(1, self.cfg.cache.prefetch_num)
        it = iter(data)
        total = num_iters
        fetched = done = examples = 0
        loss_chunks: List[torch.Tensor] = []
        host_s: List[float] = []
        events = []

        def fetch_window() -> List[Batch]:
            nonlocal fetched
            want = pn if total is None else min(pn, total - fetched)
            window = []
            for _ in range(want):
                try:
                    window.append(next(it))
                except StopIteration:
                    break
            fetched += len(window)
            return window

        def stage(batches):
            th = time.perf_counter()
            win = self._begin_window(batches)
            self._finish_window(win)
            return win, th

        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        th = time.perf_counter()
        cur = fetch_window()
        win_cur = None
        if cur:
            win_cur, _ = stage(cur)
            host_s.append(time.perf_counter() - th)
        while cur:
            progresses = [0.0 if total is None else (done + i) / max(total, 1) for i in range(len(cur))]
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            loss_chunks.append(self._dispatch_window(win_cur, progresses))
            if cuda:
                ev[1].record()
                events.append(ev)
            examples += sum(b.batch_size for b in cur)
            done += len(cur)
            # plan + stage the NEXT window while the device executes this one
            th = time.perf_counter()
            nxt = fetch_window()
            win_nxt = None
            if nxt:
                win_nxt, _ = stage(nxt)
                host_s.append(time.perf_counter() - th)
            cur, win_cur = nxt, win_nxt
        if cuda:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        losses = torch.cat(loss_chunks).cpu().tolist() if loss_chunks else []
        return TrainReport(
            losses=losses,
            it_per_s=done / dt if dt > 0 else 0.0,
            examples_per_s=examples / dt if dt > 0 else 0.0,
            hit_rate=self.embed.stats.hit_rate(),
            window_host_s=host_s,
            window_device_s=[a.elapsed_time(b) / 1e3 for a, b in events],
        )

    @torch.no_grad()
    def evaluate(self, data: Iterable[Batch]) -> dict:
        """AUROC/Accuracy evaluation through the same window machinery as
        training (cache maintenance via staged admits), forward only. Scores
        stay on the device and are read back in blocks."""
        metrics = StreamingMetrics()
        pending: List[torch.Tensor] = []
        pending_labels: List[np.ndarray] = []

        def drain():
            if pending:
                metrics.update(torch.cat(pending).cpu().numpy(), np.concatenate(pending_labels))
                pending.clear()
                pending_labels.clear()

        pn = max(1, self.cfg.cache.prefetch_num)
        it = iter(data)
        while True:
            window: List[Batch] = []
            for _ in range(pn):
                try:
                    window.append(next(it))
                except StopIteration:
                    break
            if not window:
                break
            # forward-only windows never need the update's grouping plans
            win = self._begin_window(window, with_plan=False)
            self._finish_window(win)
            self.embed.apply_admits(win.staging)
            B = win.labels.shape[1]
            for p in range(len(window)):
                sparse = pool_uniform(self._gathered_rows(win, p), B, self.cfg.reduction_mode)
                pending.append(torch.sigmoid(self.model(win.dense[p], sparse)))
            pending_labels.append(np.concatenate([b.labels.numpy() for b in window]))
            if len(pending) >= _EVAL_READBACK_STEPS:
                drain()
        drain()
        return metrics.compute()

    def close(self) -> None:
        """Land outstanding writebacks and stop the cache's drain thread."""
        self.embed.close()
