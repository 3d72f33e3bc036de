"""Single-device trainer: cached embedding + DLRM or DeepFM dense towers
(counterpart of ``cachedembedding_tpu/train/trainer.py``, single-device
slice: uniform and ragged windows, with the host or the device planner).

Far-sighted prefetch: every ``prefetch_num`` batches form a window whose ids
are planned once by the host directory. Per window, in order:

  1. the host plans and stages window k+1 while the GPU runs window k: it
     packs the window's ids, dense features, labels, admits and update plans
     into one uint8 buffer and copies it to the device in one transfer
     (``train/wire.py``); the copy, the decode and the writeback gathers of
     window k+1's evictions are enqueued right after window k's steps;
  2. the admits land from the buffer: synthesized rows first, then fetched
     rows;
  3. each step gathers its rows with Kernel 1 (``ops/gather_rows.py``) into
     the (B, F, D) layout, in the cache's storage dtype;
  4. the dense forward and backward run, with the gradient taken with respect
     to the gathered rows;
  5. the update runs in place on the cache rows, from a row-sorted plan the
     host computed for the step (``ops/binned_scatter.sort_plan_np``);
  6. dense SGD follows.

The update follows the branch that the JAX trainer's ``_scan_window`` takes
for the window (``update_branch``, JAX's dispatch rule):

  * **plan** (``ship_sort_perm``): the grads w.r.t. the rows in their storage
    dtype, cast to it; SGD sums them in f32 and rounds each row once
    (Kernel 2, ``binned_sgd_update``);
  * **sparse** (no Adagrad, no stochastic rounding, and
    ``use_sparse_embed_grad`` or more device rows than 4x the step's ids):
    JAX computes ``cw.at[v].add((-slr * g).astype(cw.dtype))``, which adds
    **in the storage dtype**, one rounding per addend, in stream order, with
    the grads w.r.t. the storage-dtype rows. For bf16 and fp8 rows the port
    runs that function, bit for bit (Kernel 5, ``ops/ordered_scatter.py``);
    for f32 rows, where it equals Kernel 2's up to the order of the f32 sums,
    Kernel 2 (so the fully resident table, f32 rows and 4x its step's ids
    many times over, keeps Kernel 2). Criteo-1TB at ``--cache_ratio 0.01``
    takes this branch on bf16 rows;
  * **dense** (otherwise): the grads in f32 where JAX upcasts the rows before
    differentiating (fp8 rows, pooling > 1), else in the storage dtype,
    summed in f32, one rounding per row (Kernel 2).

Row-wise Adagrad (``embedding_optimizer="rowwise_adagrad"``, never the
sparse branch) runs Kernel 2's Adagrad epilogue (``binned_adagrad_update``):
each touched row's accumulator grows by the mean square of its f32 sum, and
the row moves by ``slr * s / (sqrt(acc) + eps)``, one rounding; the (C, D)
grad that JAX builds is never made. The accumulators tier with the cache
(``cache/manager.py``).

With stochastic rounding on (fp8 rows by default, ``CacheConfig.
rounds_stochastically``) and rows narrower than f32, the update is the JAX
package's rounding branch: the rows are upcast to f32 before the gradient is
taken, Kernel 3 builds the (C, D) f32 grad from the same plan (from bf16
grads for fp8 rows on the plan branch, as JAX casts them, else f32),
Adagrad (if on) scales it in place, and Kernel 4's fused entry
(``ops/rounding.stochastic_sgd_round_``) forms ``cw - slr * g`` in f32
registers and rounds it stochastically back into the cache with a per-step
seed. For f32 rows that branch reduces to ``cw - slr * g`` (rounding to f32
is the identity), which Kernel 2 computes without the (C, D) f32 grad: f32
rows take Kernel 2 whether rounding is on or not.

**Ragged windows** (variable pooling, the fbgemm-trace workload of
``data/synth.py``; any window with a batch that carries offsets) follow the
JAX trainer's ``_begin_window_ragged`` and ``_scan_window(ragged=True)``:
each step's flat feature-major slot-id stream is gathered by Kernel 1, upcast
to f32 and summed into its bags (``ops/embedding_bag.pool_ragged``); the
grads w.r.t. the gathered rows are cast to the rows' dtype, and the step's
plan sorts the flat stream by row. JAX pads each step to ``Vp =
_bucket(max step count, lo=2048)``; the port needs no padding but computes
``Vp``, because the branch rule reads it: the **sparse** branch (Kernel 5's
ordered scatter; Kernel 2 on f32 rows) when ``accum is None and
(use_sparse_embed_grad or device_rows > 4 * Vp)``, else the **dense**
branch, where JAX differentiates w.r.t. the whole ``cw`` in its storage
dtype: the grads add **in that dtype**, in stream order, into zero rows, and
the f32 SGD or Adagrad update rounds each row once (Kernel 5's
``ordered_grad_update_``). No plan branch, and no stochastic rounding: fp8
rows with rounding on are cast plainly on ragged windows, as in JAX. A
fully resident table (``embed_override``) trains ragged batches with JAX's
per-step function (``_dispatch_train``): always dense, its dense features in
f32; JAX runs that function with SGD whatever the optimizer, so row-wise
Adagrad there is refused.

**The device planner** (``CacheConfig.planner="device"``) follows the JAX
trainer's unstaged windows: ``begin_prepare`` of window k+1 (``plan_ids``,
the remap and the plan's readback into pinned memory, on the card) is
enqueued before window k's steps, and ``finish_prepare`` of k+1 (the wait on
that readback, then the writebacks and admits) after them. The slot ids stay
on the card; dense features and labels ship as the batches hold them, with no
window wire. Each step's update plan is made on the card
(``ops/binned_scatter.sort_plan``, equal to ``sort_plan_np``), and the branch
is JAX's for that path: sparse or dense, never plan (JAX ships no plan
there). Ragged windows take the dense ragged branch, as JAX's per-step
function does, and ``evaluate`` plans and scores batch by batch, as JAX does
on this path.

**The column-wise mesh** (``mesh=``, a ``parallel/mesh.py`` process group):
the cache is a ``parallel/column.py::ParallelCachedEmbeddingBag`` whose rank
stores D/w columns of every row; every rank plans the global batch's windows
alike, keeps its batch rows of the dense features and labels (int4 dense
inputs floor at int8 there, as in JAX), and runs each window's steps through
``train/mesh_window.py``. The dense LR is not scaled by the world size. As
in JAX, ragged windows on a mesh raise ``NotImplementedError``.

The JAX package fuses a window into one ``lax.scan``; here a window is a
Python loop of asynchronous launches on one CUDA stream, and losses are read
back once, at the end. ``evaluate`` runs the same window machinery with the
grouping plans suspended and scores with Kernel 1 lookups.

``train`` records each window's host work and dispatch as named spans
(``utils/spans.py``: fetch, staging, the cache's host plan, the readback
wait, the admits, the dispatch and its steps' parts) into
``TrainReport.window_spans``, on the profiler's clock too while a
``torch.profiler`` records.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch import resolve_device
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.cache.manager import (
    CACHE_DTYPES,
    OPTIMIZERS,
    CachedEmbeddingBag,
    PreparedWindow,
    WindowStaging,
)
from cachedembedding_tpu_torch.cache.state import EvictionStrategy
from cachedembedding_tpu_torch.config import DLRMConfig
from cachedembedding_tpu_torch.jagged import Batch, concat_uniform_values
from cachedembedding_tpu_torch.models.deepfm import DeepFM, bce_probs
from cachedembedding_tpu_torch.models.dlrm import DLRM, bce_with_logits
from cachedembedding_tpu_torch.ops.binned_scatter import (
    binned_adagrad_update,
    binned_scatter_add,
    binned_sgd_update,
    sort_plan,
    sort_plan_np,
)
from cachedembedding_tpu_torch.ops.embedding_bag import pool_ragged, pool_uniform
from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_grad_update_, ordered_scatter_add_
from cachedembedding_tpu_torch.ops.rounding import astype_storage, stochastic_sgd_round_
from cachedembedding_tpu_torch.parallel.multiproc import put_addressable, shard_bounds
from cachedembedding_tpu_torch.train import mesh_window, wire
from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics
from cachedembedding_tpu_torch.utils.spans import (
    ADMIT,
    DENSE_UPDATE,
    DISPATCH,
    EMBEDDING_UPDATE,
    ENCODE,
    FETCH,
    FORWARD_BACKWARD,
    PACK,
    PLAN_HOST,
    READBACK_WAIT,
    SHIP,
    SORT_PLANS,
    STAGE,
    Spans,
)

_EVAL_READBACK_STEPS = 32  # eval scores stay on the device this many steps
_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DENSE_INPUT_DTYPES = ("float32", "bfloat16", "int8", "int4")
_M32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9  # per-step rounding seeds: uint32(step) * this + p, as in JAX


def _refuse_outside_slice(cfg: DLRMConfig, cached: bool = True) -> None:
    """Raise ValueError for an unknown option (the cache's storage options
    only where the cache is used), and NotImplementedError for the
    table-wise layout, which ``models/hybrid.HybridParallelDLRM`` trains."""
    c = cfg.cache
    if cfg.model not in ("dlrm", "deepfm"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.embedding_optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown embedding_optimizer {cfg.embedding_optimizer!r}")
    if cached and c.cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype={c.cache_dtype!r}: the cache stores {', '.join(CACHE_DTYPES)} rows")
    if cfg.interaction_impl not in ("bmm", "gather"):
        raise ValueError(f"unknown interaction_impl {cfg.interaction_impl!r}")
    refusals = [
        # JAX's trainer ignores use_tablewise (its CLI routes the flag to run_hybrid first)
        (cfg.use_tablewise, "the table-wise layout (use_tablewise) trains through "
                            "models/hybrid.HybridParallelDLRM, not CachedDLRMTrainer"),
    ]
    if cfg.fused_op not in mesh_window.FUSED_OPS:
        raise ValueError(f"unknown fused_op {cfg.fused_op!r}")
    if cfg.compute_dtype not in _FLOAT_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r} is not supported")
    if cfg.dense_input_dtype not in DENSE_INPUT_DTYPES:
        raise ValueError(f"unknown dense_input_dtype {cfg.dense_input_dtype!r}")
    if c.id_wire not in ("plain", "escape", "ranktier"):
        raise ValueError(f"unknown id_wire {c.id_wire!r}")
    for bad, msg in refusals:
        if bad:
            raise NotImplementedError(msg)


def bucket(n: int, lo: int = 2048) -> int:
    """The JAX cache's ``_bucket``: n rounded up to a power of two, at least lo."""
    b = lo
    while b < n:
        b <<= 1
    return b


def update_branch(cfg: DLRMConfig, adagrad: bool, device_rows: int, ids_per_step: int,
                  ragged: bool = False, plans_shipped: bool = True) -> str:
    """The JAX trainer's update branch for a window ("plan", "sparse" or
    "dense", its ``_dispatch_window``). Uniform windows: the plan branch where
    the host ships sort plans (``ship_sort_perm``, on the host planner's
    windows: ``plans_shipped``), else the sparse-gradient branch where
    ``accum is None and (use_sparse_embed_grad or device_rows > 4 * L) and
    not sr``, else the dense branch. Ragged windows (``ids_per_step`` is then
    ``Vp``): the sparse branch where ``accum is None and
    (use_sparse_embed_grad or device_rows > 4 * Vp)``, else the dense branch;
    JAX reads neither the plan option nor stochastic rounding there."""
    if ragged:
        sparse = not adagrad and (cfg.use_sparse_embed_grad or device_rows > 4 * ids_per_step)
        return "sparse" if sparse else "dense"
    if cfg.cache.ship_sort_perm and plans_shipped:
        return "plan"
    if (not adagrad and (cfg.use_sparse_embed_grad or device_rows > 4 * ids_per_step)
            and not cfg.cache.rounds_stochastically):
        return "sparse"
    return "dense"


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    it_per_s: float
    examples_per_s: float
    hit_rate: float
    window_host_s: List[float] = dataclasses.field(default_factory=list)  # host s per window: data, plan, staging
    window_device_s: List[float] = dataclasses.field(default_factory=list)  # device s per window (CUDA events)
    window_plan_s: List[float] = dataclasses.field(default_factory=list)  # host s per window in the update plans
    # per window: the id format shipped ("fixed", "plain", "esc" or "rt"),
    # bytes by block (ids, dense, labels, admits, and the tail: plans and
    # writeback slots), host s in the id encoder and in the rest of the
    # packing (dense features, labels, admits, the buffer's assembly and copy)
    window_wire: List[dict] = dataclasses.field(default_factory=list)
    # the device planner, per window: device s of plan_ids and the remap (CUDA
    # only), and the readback of its plan: bytes, the copies' device s (CUDA
    # only) and the host's wait for them
    window_plan_device_s: List[float] = dataclasses.field(default_factory=list)
    window_readback: List[dict] = dataclasses.field(default_factory=list)
    # per window, host s by span name (``utils/spans.py``), entry i the work of
    # window i: its preparation (the parts of ``window_host_s[i]``) and its dispatch
    window_spans: List[dict] = dataclasses.field(default_factory=list)


class _Window(NamedTuple):
    """One staged window: its buffer copied to the device and decoded there
    (views of the buffer where the bytes allow). A ragged window's ids are
    (P, Vp), step p's first ``bounds[p + 1] - bounds[p]`` of its row; its
    plan's perm and grouped ids are flat, step p's at ``bounds[p]:bounds[p +
    1]``."""

    staging: object         # WindowStaging (host planner) or PreparedWindow (device planner)
    slot_ids: torch.Tensor  # (P, L) int32 feature-major device addresses; ragged: (P, Vp)
    dense: torch.Tensor     # (P, B, Din) float32
    labels: torch.Tensor    # (P, B) float32
    plan: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # perm, grouped, bins; None: made per step
    plan_s: float  # host seconds spent in the update plans
    buf: torch.Tensor = None                 # the window's device buffer
    admits: Optional[wire.AdmitLayout] = None
    wire: Optional[dict] = None              # format, id spec, bytes by block, encode s
    wb_slots: Optional[torch.Tensor] = None  # int32 slots of the evicted rows to write back
    bounds: Optional[List[int]] = None       # ragged: (P + 1,) step boundaries
    lengths: Optional[torch.Tensor] = None   # ragged: (P, F*B) int32 ids per bag
    in_bags: Optional[List[int]] = None      # ragged: (P,) ids a step inside its bags
    vp: int = 0                              # ragged: JAX's padded ids a step

    def step_ids(self, p: int) -> torch.Tensor:
        if self.bounds is None:
            return self.slot_ids[p]
        return self.slot_ids[p, : self.bounds[p + 1] - self.bounds[p]]

    def step_plan(self, p: int):
        perm, grouped, bins = self.plan
        if self.bounds is None:
            return perm[p], grouped[p], bins[p]
        a, b = self.bounds[p], self.bounds[p + 1]
        return perm[a:b], grouped[a:b], bins[p]


def _model_loss(model: str, out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """DLRM trains on logits, DeepFM on its Sigmoid outputs."""
    return bce_with_logits(out, labels) if model == "dlrm" else bce_probs(out, labels)


def _model_probs(model: str, out: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(out) if model == "dlrm" else out


class CachedDLRMTrainer:
    """Cached DLRM or DeepFM training and evaluation on one device (default:
    the current CUDA device, or ``embed_override``'s; pass ``device="cpu"``
    to run on the CPU), or, with ``mesh``, this rank's part of a
    column-wise mesh on the mesh's device. ``cfg.mesh_shape`` builds no
    mesh: without one it scales the dense LR, as in JAX."""

    def __init__(self, cfg: DLRMConfig, id_freq_map: Optional[np.ndarray] = None, device=None,
                 embed_override=None, mesh=None):
        _refuse_outside_slice(cfg, cached=embed_override is None)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"the mesh's rank runs on {mesh.device}, not {device}")
            device = mesh.device
        if device is None and embed_override is not None:
            device = embed_override.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        c = cfg.cache
        resident = (
            [i for i, n in enumerate(cfg.num_embeddings_per_feature) if n <= c.resident_threshold]
            if c.resident_threshold > 0 else None
        )
        use_dataset = not c.use_lfu_eviction and c.use_freq and id_freq_map is not None
        bag_cls, bag_kw = CachedEmbeddingBag, {}
        if mesh is not None:
            from cachedembedding_tpu_torch.parallel.column import ParallelCachedEmbeddingBag

            if embed_override is not None and not (isinstance(embed_override, ParallelCachedEmbeddingBag)
                                                   and embed_override.mesh is mesh):
                raise ValueError("on a mesh the embedding is a ParallelCachedEmbeddingBag over that mesh")
            if cfg.batch_size % mesh.size:
                raise ValueError(f"batch {cfg.batch_size} does not split evenly over {mesh.size} ranks")
            bag_cls, bag_kw = ParallelCachedEmbeddingBag, {"mesh": mesh}
        self.embed = embed_override if embed_override is not None else bag_cls(
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
            dtype=CACHE_DTYPES[c.cache_dtype],
            weight_init=c.weight_init,
            transfer_dtype=c.transfer_dtype,
            device=self.device,
            resident_tables=resident,
            optimizer=cfg.embedding_optimizer,
            adagrad_initial=cfg.adagrad_initial,
            planner=c.planner,
            approx_evict=c.approx_evict,
            **bag_kw,
        )
        if self.embed.device != self.device:
            raise ValueError(f"embed_override lives on {self.embed.device}, the trainer on {self.device}")
        if self.embed.optimizer != cfg.embedding_optimizer:
            raise ValueError(f"the embedding trains with {self.embed.optimizer!r}, the config "
                             f"asks for {cfg.embedding_optimizer!r}")
        compute_dtype = _FLOAT_DTYPES[cfg.compute_dtype]
        if cfg.model == "deepfm":
            self.model = DeepFM(
                cfg.embedding_dim,
                cfg.num_sparse_features,
                cfg.dense_in_features,
                hidden_layer_size=cfg.dense_arch_layer_sizes[0],
                deep_fm_dimension=cfg.deep_fm_dimension,
                compute_dtype=compute_dtype,
                seed=cfg.seed,
                device=self.device,
            )
        else:
            self.model = DLRM(
                cfg.embedding_dim,
                cfg.num_sparse_features,
                cfg.dense_in_features,
                cfg.dense_arch_layer_sizes,
                cfg.over_arch_layer_sizes,
                compute_dtype=compute_dtype,
                interaction_impl=cfg.interaction_impl,
                seed=cfg.seed,
                device=self.device,
            )
        # the mesh sums its ranks' losses of the global mean: no LR scaling there
        self.data_parallel_size = 1 if mesh is not None else int(np.prod(cfg.mesh_shape))
        # the stateful id wire of uniform windows (train/wire.py)
        self.wire = wire.WindowWire(c.id_wire, c.escape_pack, self._rt_dict_features(), self._device_rows())
        # f32 rows: the rounding branch is cw - slr * g, Kernel 2's function
        self._sr = c.rounds_stochastically and self.embed.cache_weight.dtype != torch.float32
        self._step_idx = 0  # training steps dispatched before the current window
        # one recorder for the trainer's spans and its cache's
        self.spans = self.embed.spans if isinstance(self.embed, CachedEmbeddingBag) else Spans()

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

    def _rt_dict_features(self) -> list:
        """The rank-tier wire's dictionary features: the cached ones (their
        slot ids are arbitrary); resident local ids are already rank-like."""
        if not isinstance(self.embed, CachedEmbeddingBag):
            return [False] * self.cfg.num_sparse_features
        return [not bool(r) for r in self.embed._is_res_table]

    def _encode_ids(self, slot: np.ndarray, P: int, L: int, F: int):
        """The id block of a uniform window (JAX's ``_begin_window``): per-
        feature blocks through the stateful wire where the bag has a
        per-feature spec (a resident split) or is a cache with the escape
        wire on, else one fixed width. Returns (bytes, id_spec, format)."""
        Bf = L // F
        spec = self.embed.pf_pack_spec(P * Bf) if hasattr(self.embed, "pf_pack_spec") else None
        if spec is None and self.wire._escape_pack and isinstance(self.embed, CachedEmbeddingBag):
            w = hostops.nibble_width(self._device_rows(), P * Bf)
            spec = tuple((w, 0) for _ in range(F))
        if spec is not None:
            return self.wire.encode(slot.reshape(P, F, Bf), spec, P, L, Bf)
        width = hostops.id_pack_width(self._device_rows(), L)
        packed = slot.reshape(-1).view(np.uint8) if width == 32 else hostops.pack_ids(slot, width)
        return packed, width, "fixed"

    def _dense_mode(self, dense_mode: Optional[str], ragged: bool) -> str:
        """The dense wire of a window: ``dense_input_dtype``, but f32 for a
        fully resident table's ragged windows, which JAX trains by its
        per-step function on the f32 features, and int8 for int4 on a mesh
        (JAX's floor there: int4's per-feature ranges would not survive the
        batch split of its wire)."""
        if dense_mode is None and ragged and not isinstance(self.embed, CachedEmbeddingBag):
            return "float32"
        mode = dense_mode or self.cfg.dense_input_dtype
        return "int8" if mode == "int4" and self.mesh is not None else mode

    def _local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (all of them off a mesh)."""
        return slice(0, n) if self.mesh is None else slice(*shard_bounds(n, self.mesh))

    def _dense_parts(self, batches: List[Batch], dmode: str) -> list:
        """The dense block of a window's wire: this rank's batch rows, int8
        quantized with the range of the global window's features, as JAX's
        mesh quantizes before it splits the batch."""
        dense = self._dense_np(batches)
        rows = self._local_rows(dense.shape[1])
        if dmode == "int8" and self.mesh is not None:
            q, meta = wire.quant_dense_window(dense)
            return [meta.view(np.uint8), np.ascontiguousarray(q[:, rows]).reshape(-1)]
        return wire.dense_wire(dense[:, rows], dmode)

    def _ship(self, parts: dict, tail: list):
        """Assemble a window's blocks, then ``tail`` at an aligned offset, into
        one host buffer and copy it to the device in one transfer. Returns
        (device buffer, tail offset)."""
        host, tail_at = wire.assemble([p for blk in parts.values() for p in blk], tail,
                                      pin=self.device.type == "cuda")
        return self.embed.to_device(host), tail_at

    @staticmethod
    def _writeback_slots(ws) -> list:
        """The slots whose evicted rows the window writes back, shipped in its
        buffer (none for a fully resident table)."""
        if not isinstance(ws, WindowStaging):
            return []
        return [np.ascontiguousarray(ws.admit_slots[ws.evict_rows >= 0], np.int32)]

    def _admit_parts(self, ws) -> Tuple[list, tuple]:
        """The admit block of a staged window and its (sb, fb, fmode, accum)."""
        if not isinstance(ws, WindowStaging):
            return [], (0, 0, "float32", False)
        fmode = self.embed.transfer_mode
        accum = self.embed.cache_accum is not None
        return wire.admit_wire(ws, fmode, accum), (ws.synth_slots.shape[0], ws.fetch_slots.shape[0], fmode, accum)

    @staticmethod
    def _tail_views(buf: torch.Tensor, at: int, shapes) -> tuple:
        """int32 views of the plan arrays and writeback slots at the buffer's
        aligned tail."""
        out = []
        for shape in shapes:
            n = int(np.prod(shape))
            out.append(wire.field(buf, at, n, torch.int32).reshape(shape))
            at += 4 * n
        return tuple(out)

    @property
    def device_planner(self) -> bool:
        """Whether the cache plans on the device (``planner="device"``)."""
        return isinstance(self.embed, CachedEmbeddingBag) and self.embed.planner == "device"

    def _begin_window(self, batches: List[Batch], with_plan: bool = True,
                      dense_mode: Optional[str] = None) -> _Window:
        """Plan and stage a window and ship it: the remapped ids, dense
        features (in ``dense_input_dtype``, or ``dense_mode``), labels, the
        admits and (``with_plan``) per-step grouping plans for the update,
        in one buffer and one host-to-device copy. A window whose batches all
        share one pooling factor and carry no offsets is uniform; any other
        is ragged. The device planner's windows: ``_begin_window_device``."""
        f0 = batches[0].sparse_features
        F, B, Pool = f0.num_features, f0.batch_size, f0.pooling
        if any(b.sparse_features.num_features != F or b.sparse_features.batch_size != B for b in batches):
            raise NotImplementedError("a window's batches must share their feature count and batch size")
        ragged = Pool is None or any(b.sparse_features.pooling != Pool or b.sparse_features.offsets is not None
                                     for b in batches)
        if ragged and self.mesh is not None:
            raise NotImplementedError("mesh-windowed training requires uniform pooling (Criteo/Avazu shapes); "
                                      "ragged batches run via the per-batch hybrid path")
        if self.device_planner:
            return self._begin_window_device(batches, ragged)
        if ragged:
            return self._begin_window_ragged(batches, with_plan, dense_mode)
        P = len(batches)
        with self.spans(STAGE):
            all_ids = concat_uniform_values(batches)
        L = all_ids.shape[0] // P
        N = L // F
        with self.spans(PLAN_HOST):
            ws = self.embed.begin_window_staging(all_ids, (P, L), uniform_fbp=(P, F, N))
        with self.spans(ENCODE) as encode:
            ids_bytes, id_spec, fmt = self._encode_ids(ws.slot_ids, P, L, F)
        dmode = self._dense_mode(dense_mode, False)
        with self.spans(PACK) as pack:
            rows = self._local_rows(B)
            labels, lbits = wire.label_wire(torch.stack([b.labels for b in batches]).numpy()[:, rows], True)
            admit_parts, (sb, fb, fmode, accum) = self._admit_parts(ws)
            parts = {"ids": [ids_bytes], "dense": self._dense_parts(batches, dmode),
                     "labels": [labels], "admits": admit_parts}
        plan_parts, plan_s = [], 0.0
        if with_plan:
            NR = self._device_rows()
            with self.spans(SORT_PLANS) as plans:
                # the update's stream is the gathered rows' order: (N, F)
                steps = [sort_plan_np(ws.slot_ids[p].reshape(F, N).T, NR) for p in range(P)]
            plan_s = plans.s
            plan_parts = [np.stack(a) for a in zip(*steps)]
        wb = self._writeback_slots(ws)
        with self.spans(SHIP) as ship:
            buf, tail_at = self._ship(parts, plan_parts + wb)
        slot_ids, a = wire.decode_window_ids(buf, P, L, id_spec)
        b_local = rows.stop - rows.start
        dense, b = wire.unpack_dense(buf, a, P, b_local, self.cfg.dense_in_features, dmode)
        labels_dev, c = wire.unpack_labels(buf, b, P, b_local, lbits)
        tail = self._tail_views(buf, tail_at, [p.shape for p in plan_parts + wb])
        return _Window(staging=ws, slot_ids=slot_ids, dense=dense, labels=labels_dev,
                       plan=tail[:3] if with_plan else None, plan_s=plan_s,
                       buf=buf, admits=wire.AdmitLayout(c, sb, fb, fmode, accum),
                       wire=self._wire_report(fmt, id_spec, parts, plan_parts + wb, encode.s, pack.s + ship.s,
                                              dmode, lbits),
                       wb_slots=tail[-1] if wb else None)

    @staticmethod
    def _dense_np(batches: List[Batch]) -> np.ndarray:
        return torch.stack([b.dense_features for b in batches]).float().numpy()

    @staticmethod
    def _wire_report(fmt, id_spec, parts: dict, tail: list, encode_s: float, pack_s: float, dmode: str,
                     lbits: bool) -> dict:
        nbytes = {k: int(sum(p.nbytes for p in v)) for k, v in parts.items()}
        nbytes["tail"] = int(sum(p.nbytes for p in tail))  # plans and writeback slots
        return {"format": fmt, "id_spec": id_spec, "bytes": nbytes, "encode_s": encode_s, "pack_s": pack_s,
                "dense": dmode, "label_bits": lbits}

    def _begin_window_ragged(self, batches: List[Batch], with_plan: bool, dense_mode: Optional[str]) -> _Window:
        """A ragged window (the JAX trainer's ``_begin_window_ragged``): the
        steps' flat feature-major id streams planned as one, shipped as a
        (P, Vp) zero-padded block at ``id_pack_width`` over ``Vp = bucket(max
        step ids)``, the per-bag lengths as u8 or u16, dense features, u8
        labels and the admits; per step a plan that sorts the step's flat
        stream (the order of its gathered rows) by row."""
        P = len(batches)
        f0 = batches[0].sparse_features
        F, B = f0.num_features, f0.batch_size
        with self.spans(STAGE):
            vals = [b.sparse_features.values.numpy() for b in batches]
            ids = np.concatenate(vals)
        counts = [v.shape[0] for v in vals]
        bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        with self.spans(PLAN_HOST):
            ws = self.embed.begin_window_staging(ids, (-1,))
        vp = bucket(max(counts))
        slot_pad = np.zeros((P, vp), np.int32)
        for p in range(P):
            slot_pad[p, : counts[p]] = ws.slot_ids[bounds[p] : bounds[p + 1]]
        lengths = np.stack([b.sparse_features.lengths().numpy() for b in batches]).astype(np.int64)
        if lengths.max(initial=0) >= 65536:
            raise ValueError("a bag of 65536 ids or more does not fit the u16 lengths wire")
        len16 = bool(lengths.max(initial=0) >= 256)
        lens_bytes = lengths.astype("<u2").reshape(-1).view(np.uint8) if len16 else lengths.astype(np.uint8).reshape(-1)
        with self.spans(ENCODE) as encode:
            width = hostops.id_pack_width(self._device_rows(), vp)
            ids_bytes = slot_pad.reshape(-1).view(np.uint8) if width == 32 else hostops.pack_ids(slot_pad, width)
        dmode = self._dense_mode(dense_mode, True)
        with self.spans(PACK) as pack:
            labels, _ = wire.label_wire(torch.stack([b.labels for b in batches]).numpy(), False)
            admit_parts, (sb, fb, fmode, accum) = self._admit_parts(ws)
            parts = {"ids": [ids_bytes, lens_bytes], "dense": wire.dense_wire(self._dense_np(batches), dmode),
                     "labels": [labels], "admits": admit_parts}
        plan_parts, plan_s = [], 0.0
        if with_plan:
            NR = self._device_rows()
            with self.spans(SORT_PLANS) as plans:
                steps = [sort_plan_np(ws.slot_ids[bounds[p]:bounds[p + 1]], NR) for p in range(P)]
            plan_s = plans.s
            perm, grouped, bins = zip(*steps)
            plan_parts = [np.concatenate(perm), np.concatenate(grouped), np.stack(bins)]
        wb = self._writeback_slots(ws)
        with self.spans(SHIP) as ship:
            buf, tail_at = self._ship(parts, plan_parts + wb)
        a = (P * vp * width) // 8
        slot_ids = wire.unpack_flat(buf[:a], P * vp, width).reshape(P, vp)
        lengths_dev, b0 = wire.unpack_lengths(buf, a, P, F * B, len16)
        dense, b1 = wire.unpack_dense(buf, b0, P, B, self.cfg.dense_in_features, dmode)
        labels_dev, c = wire.unpack_labels(buf, b1, P, B, False)
        tail = self._tail_views(buf, tail_at, [p.shape for p in plan_parts + wb])
        return _Window(
            staging=ws, slot_ids=slot_ids, dense=dense, labels=labels_dev,
            plan=tail[:3] if with_plan else None, plan_s=plan_s,
            buf=buf, admits=wire.AdmitLayout(c, sb, fb, fmode, accum),
            wire=self._wire_report("fixed", width, parts, plan_parts + wb, encode.s, pack.s + ship.s, dmode, False),
            wb_slots=tail[-1] if wb else None,
            bounds=[int(x) for x in bounds], lengths=lengths_dev,
            in_bags=[int(x) for x in lengths.sum(axis=1)], vp=vp,
        )

    def _begin_window_device(self, batches: List[Batch], ragged: bool) -> _Window:
        """A window of the device planner (JAX's unstaged windows): the flat id
        stream planned and remapped on the device (``begin_prepare``, which
        also enqueues the plan's readback), the dense features and labels
        copied as the batches hold them. A ragged window's slot ids are
        padded on the device to (P, Vp), as on the host planner's ragged
        windows. The update plans are made per step (``_step_plan``)."""
        P = len(batches)
        f0 = batches[0].sparse_features
        F, B = f0.num_features, f0.batch_size
        with self.spans(STAGE):
            vals = [b.sparse_features.values.numpy() for b in batches]
            ids = np.concatenate(vals)
            dense = torch.stack([b.dense_features for b in batches]).float()
            labels = torch.stack([b.labels for b in batches]).float()
            if self.mesh is None:
                dense, labels = self.embed.to_device(dense), self.embed.to_device(labels)
            else:  # this rank's batch rows
                dense, labels = put_addressable(self.mesh, dense, 1), put_addressable(self.mesh, labels, 1)
        with self.spans(PLAN_HOST):
            pw = self.embed.begin_prepare(ids, None if ragged else (P, vals[0].shape[0]))
        if not ragged:
            return _Window(staging=pw, slot_ids=pw.slot_ids, dense=dense, labels=labels, plan=None, plan_s=0.0)
        counts = [v.shape[0] for v in vals]
        bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        vp = bucket(max(counts))
        slot_ids = torch.zeros((P, vp), dtype=torch.int32, device=self.device)
        for p in range(P):
            slot_ids[p, : counts[p]] = pw.slot_ids[bounds[p] : bounds[p + 1]]
        lengths = torch.stack([b.sparse_features.lengths() for b in batches]).to(torch.int32)
        return _Window(staging=pw, slot_ids=slot_ids, dense=dense, labels=labels, plan=None, plan_s=0.0,
                       bounds=[int(x) for x in bounds], lengths=self.embed.to_device(lengths),
                       in_bags=[int(x) for x in lengths.sum(dim=1)], vp=vp)

    def _step_plan(self, win: _Window, p: int):
        """Step p's update plan: the window's shipped plan, or (the device
        planner's windows) one made here, on the ids' device, from the
        step's stream in the order of its gathered rows ((N, F) on a uniform
        window, the flat stream on a ragged one)."""
        if win.plan is not None:
            return win.step_plan(p)
        ids = win.step_ids(p)
        if win.bounds is None:
            ids = ids.view(self.cfg.num_sparse_features, -1).t().reshape(-1)
        return sort_plan(ids, self._device_rows())

    def _land_admits(self, win: _Window) -> None:
        """Land the window's admits from its device buffer (after the
        writebacks of its evictions were enqueued)."""
        lay = win.admits
        if lay is not None and (lay.sb or lay.fb):
            wire.apply_packed_admits(self.embed, win.buf, lay)

    def _finish_window(self, win: _Window) -> None:
        """Enqueue the window's eviction writebacks (after the previous
        window's steps, before this window's admits), their slots read from
        the window's buffer; on the device planner, wait for the window's
        plan and move its rows (``finish_prepare``)."""
        with self.spans(ADMIT):
            if isinstance(win.staging, PreparedWindow):
                self.embed.finish_prepare(win.staging)
            else:
                self.embed.enqueue_writebacks(win.staging, win.wb_slots)

    def _gathered_rows(self, win: _Window, p: int) -> torch.Tensor:
        """Kernel 1 lookup of step p: (B*P, F, D) rows in the storage dtype;
        on a ragged window the flat (L_p, D) rows in stream order."""
        if win.bounds is not None:
            return gather_rows(self.embed.cache_weight, win.step_ids(p), 1)[:, 0]
        return gather_rows(self.embed.cache_weight, win.step_ids(p), self.cfg.num_sparse_features)

    def _pool_ragged(self, win: _Window, p: int, rows: torch.Tensor, count_dtype: torch.dtype) -> torch.Tensor:
        """Step p's bags of a ragged window: (B, F, D) f32 from its flat rows."""
        F, B = self.cfg.num_sparse_features, win.labels.shape[1]
        lengths, n = win.lengths[p], win.in_bags[p]
        # each id's bag; ids past the last offset go to bag F*B, which pooling drops
        seg = torch.full((rows.shape[0],), F * B, dtype=torch.int64, device=rows.device)
        seg[:n] = torch.repeat_interleave(torch.arange(F * B, device=rows.device), lengths.long(), output_size=n)
        pooled = pool_ragged(rows, seg, lengths, F * B, self.cfg.reduction_mode, count_dtype)
        return pooled.reshape(F, B, -1).transpose(0, 1)

    def branch_of(self, win: _Window) -> str:
        """The JAX trainer's update branch for ``win`` (``update_branch``). A
        fully resident table, and the device planner, train ragged batches
        by JAX's per-step function, which is always dense there."""
        adagrad = self.embed.cache_accum is not None
        if win.bounds is None:  # JAX ships no plans to the device planner's or the mesh's windows
            return update_branch(self.cfg, adagrad, self._device_rows(), win.slot_ids.shape[1],
                                 plans_shipped=not self.device_planner and self.mesh is None)
        if not isinstance(self.embed, CachedEmbeddingBag) or self.device_planner:
            return "dense"
        return update_branch(self.cfg, adagrad, self._device_rows(), win.vp, ragged=True)

    def _upcasts(self, branch: str, cw: torch.Tensor, pooling: int) -> bool:
        """Whether the gradient is taken w.r.t. the f32 upcast of the rows:
        under stochastic rounding, on the dense branch where JAX upcasts
        (fp8 rows, pooling > 1), and for fp8 rows always (torch takes no
        grad w.r.t. an fp8 leaf; the plan and sparse branches cast it to the
        rows' dtype as JAX's grad w.r.t. the storage-dtype rows is)."""
        return self._sr or cw.element_size() == 1 or (branch == "dense" and pooling > 1)

    def _sr_update(self, cw, g_rows, perm, grouped, bins, slr: float, seed: int, branch: str = "plan") -> None:
        """The rounding branch's update of one step, in place on ``cw``:
        Kernel 3 builds the (C, D) f32 grad (from bf16 grads for fp8 rows on
        the plan branch, as JAX casts them there, else from the f32 grads),
        row-wise Adagrad scales it in place (torch ops, JAX's formula), and
        Kernel 4's fused entry forms ``cw - slr * g`` in registers and rounds
        it stochastically into ``cw`` (bf16 and fp8 rows), with no f32 copy
        of ``cw``. f32 rows take ``cw - slr * g`` as it is."""
        if branch == "plan":
            # fp8 grads would flush the sub-ulp updates the rounding preserves;
            # bf16 keeps f32's exponent range at half the bytes
            gdt = torch.bfloat16 if cw.element_size() == 1 else cw.dtype
        else:
            gdt = torch.float32
        g32 = binned_scatter_add(g_rows.to(gdt), perm, grouped, bins, cw.shape[0])
        acc = self.embed.cache_accum
        if acc is not None:
            acc.add_(torch.mean(g32 * g32, dim=1))
            g32.div_((torch.sqrt(acc) + self.cfg.adagrad_eps)[:, None])
        if cw.dtype == torch.float32:
            cw.sub_(g32, alpha=slr)
        else:
            stochastic_sgd_round_(cw, g32, slr, seed)

    def _update(self, cw, g_rows, perm, grouped, bins, slr: float, branch: str) -> None:
        """The update of one step without stochastic rounding, in place on
        ``cw`` (and the accumulators): the branch's grads, then Kernel 5 on
        the sparse branch's bf16 and fp8 rows, Kernel 2's Adagrad epilogue
        under row-wise Adagrad, else Kernel 2's SGD epilogue."""
        if branch == "dense" and g_rows.dtype == torch.float32:
            g = g_rows  # JAX sums the f32 grads of the upcast rows
        else:  # the grads w.r.t. the storage-dtype rows, as JAX rounds them
            g = g_rows if g_rows.dtype == cw.dtype else astype_storage(g_rows, cw.dtype)
        acc = self.embed.cache_accum
        if branch == "sparse" and cw.dtype != torch.float32:
            ordered_scatter_add_(cw, g, perm, grouped, slr)
        elif acc is not None:
            binned_adagrad_update(cw, acc, g, perm, grouped, bins, slr, self.cfg.adagrad_eps)
        else:
            binned_sgd_update(cw, g, perm, grouped, bins, slr)

    def _ragged_update(self, cw, g, perm, grouped, bins, slr: float, branch: str) -> None:
        """The update of one step of a ragged window, in place on ``cw`` (and
        the accumulators), from the grads in the rows' dtype: the sparse
        branch as on uniform windows, else Kernel 5's ``ordered_grad_update_``
        (the grads summed in the rows' dtype, then SGD or row-wise Adagrad)."""
        if branch == "sparse":
            self._update(cw, g, perm, grouped, bins, slr, branch)
        else:
            ordered_grad_update_(cw, self.embed.cache_accum, g, perm, grouped, slr, self.cfg.adagrad_eps)

    def _pooled(self, win: _Window, p: int, rows: torch.Tensor, count_dtype: torch.dtype) -> torch.Tensor:
        """Step p's (B, F, D) bags from its gathered rows."""
        if win.bounds is not None:
            return self._pool_ragged(win, p, rows, count_dtype)
        return pool_uniform(rows, win.labels.shape[1], self.cfg.reduction_mode)

    def _dispatch_window(self, win: _Window, progresses: List[float]) -> torch.Tensor:
        """Land the admits and enqueue every step of the window. Returns the
        (P,) per-step losses (device tensor, not yet read back)."""
        if self.mesh is not None:
            return mesh_window.train_window(self, win, progresses)
        ragged = win.bounds is not None
        resident = not isinstance(self.embed, CachedEmbeddingBag)
        if ragged and resident and self.embed.cache_accum is not None:
            raise NotImplementedError(
                "row-wise Adagrad on a fully resident table with ragged batches: the JAX trainer trains "
                "them by its per-step function, which ignores the accumulators (ROADMAP Queue 3)")
        self._land_admits(win)
        cw = self.embed.cache_weight
        B = win.labels.shape[1]
        branch = self.branch_of(win)
        # ragged windows: the grads of the f32 upcast, cast to the rows' dtype
        # (JAX differentiates w.r.t. the storage-dtype rows); no rounding branch
        upcast = ragged or self._upcasts(branch, cw, win.slot_ids.shape[1] // (B * self.cfg.num_sparse_features))
        # a ragged bag's mean divides by a count summed in the rows' dtype
        # (JAX's embedding_bag), in f32 on the sparse branch
        count_dtype = torch.float32 if branch == "sparse" else cw.dtype
        params = list(self.model.parameters())
        losses = []
        for p, progress in enumerate(progresses):
            slr, dlr = self._lrs(progress)
            with self.spans(FORWARD_BACKWARD):
                rows = self._gathered_rows(win, p)
                if upcast:
                    rows = rows.float()
                rows.requires_grad_(True)
                sparse = self._pooled(win, p, rows, count_dtype)
                loss = _model_loss(self.cfg.model, self.model(win.dense[p], sparse), win.labels[p])
                loss.backward()
                g_rows = rows.grad.reshape(-1, cw.shape[1])
            with self.spans(EMBEDDING_UPDATE):
                perm, grouped, bins = self._step_plan(win, p)
                if ragged:
                    g = g_rows if g_rows.dtype == cw.dtype else astype_storage(g_rows, cw.dtype)
                    self._ragged_update(cw, g, perm, grouped, bins, slr, branch)
                elif self._sr:
                    seed = (self._step_idx * _SEED_MUL + p) & _M32
                    self._sr_update(cw, g_rows, perm, grouped, bins, slr, seed, branch)
                else:
                    self._update(cw, g_rows, perm, grouped, bins, slr, branch)
            with self.spans(DENSE_UPDATE), torch.no_grad():
                for prm in params:
                    prm.sub_(prm.grad * dlr)
                    prm.grad = None
            losses.append(loss.detach())
        return torch.stack(losses)

    def train(self, data: Iterable[Batch], num_iters: Optional[int] = None, log_every: int = 0) -> TrainReport:
        """Pipelined far-sighted training over uniform or ragged windows. With
        ``log_every``, prints ``it {done}: loss=... hit_rate=...`` whenever
        the steps done cross a multiple of it (a readback of the last loss)."""
        pn = max(1, self.cfg.cache.prefetch_num)
        it = iter(data)
        total = num_iters
        fetched = done = examples = 0
        loss_chunks: List[torch.Tensor] = []
        host_s: List[float] = []
        plan_s: List[float] = []
        wires: List[dict] = []
        window_spans: List[dict] = []
        events = []
        spans = self.spans

        def fetch_window() -> Tuple[List[Batch], dict]:
            """The next window's batches and its entry of span seconds, which
            the spans record into from here on."""
            nonlocal fetched
            spans.entry = {}
            want = pn if total is None else min(pn, total - fetched)
            window = []
            with spans(FETCH):
                for _ in range(want):
                    try:
                        window.append(next(it))
                    except StopIteration:
                        break
            fetched += len(window)
            return window, spans.entry

        readbacks = []

        def begin(batches, th):
            """Begin a window; returns it and the host seconds since ``th``."""
            win = self._begin_window(batches)
            return win, time.perf_counter() - th

        def finish(win, begun_s):
            th = time.perf_counter()
            pw = win.staging
            if isinstance(pw, PreparedWindow):
                with spans(READBACK_WAIT) as wait:
                    if pw.events:
                        pw.events[2].synchronize()  # the readback: what finish_prepare waits for
            self._finish_window(win)
            host_s.append(begun_s + time.perf_counter() - th)
            window_spans.append(spans.entry)
            plan_s.append(win.plan_s)
            if win.wire is not None:
                wires.append(win.wire)
            if isinstance(pw, PreparedWindow):
                readbacks.append((pw.readback_bytes, wait.s, pw.events))
            return win

        cuda = self.device.type == "cuda"
        # the device planner's plan runs on the device, so the next window's
        # begin goes on the stream before this window's steps (its readback
        # would wait for them otherwise) and its finish after them
        early = self.device_planner
        t0 = time.perf_counter()
        th = time.perf_counter()
        cur, ent_cur = fetch_window()
        win_cur = None
        if cur:
            win_cur = finish(*begin(cur, th))
        while cur:
            progresses = [0.0 if total is None else (done + i) / max(total, 1) for i in range(len(cur))]
            nxt, win_nxt, ent_nxt = [], None, None
            if early:
                th = time.perf_counter()
                nxt, ent_nxt = fetch_window()
                if nxt:
                    win_nxt, begun_s = begin(nxt, th)
            spans.entry = ent_cur
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with spans(DISPATCH):
                loss_chunks.append(self._dispatch_window(win_cur, progresses))
            if cuda:
                ev[1].record()
                events.append(ev)
            examples += sum(b.batch_size for b in cur)
            prev_done = done
            done += len(cur)
            self._step_idx += len(cur)
            if log_every and done // log_every != prev_done // log_every:
                print(f"it {done}: loss={loss_chunks[-1][-1].item():.5f} "
                      f"hit_rate={self.embed.stats.hit_rate(window=pn):.4f}")
            if early:
                if nxt:
                    spans.entry = ent_nxt
                    win_nxt = finish(win_nxt, begun_s)
            else:  # plan + stage the next window while the device executes this one
                th = time.perf_counter()
                nxt, ent_nxt = fetch_window()
                if nxt:
                    win_nxt = finish(*begin(nxt, th))
            cur, win_cur, ent_cur = nxt, win_nxt, ent_nxt
        spans.entry = None
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
            window_plan_s=plan_s,
            window_wire=wires,
            window_plan_device_s=[ev[0].elapsed_time(ev[1]) / 1e3 for _, _, ev in readbacks if ev],
            window_readback=[{"bytes": n, "wait_s": w, "device_s": ev[1].elapsed_time(ev[2]) / 1e3 if ev else None}
                             for n, w, ev in readbacks],
            window_spans=window_spans,
        )

    @torch.no_grad()
    def evaluate(self, data: Iterable[Batch]) -> dict:
        """AUROC/Accuracy evaluation through the same window machinery as
        training (cache maintenance via staged admits), forward only; on the
        device planner, a window of one batch at a time, as JAX plans and
        scores that path. Scores stay on the device and are read back in
        blocks."""
        metrics = StreamingMetrics()
        pending: List[torch.Tensor] = []
        pending_labels: List[np.ndarray] = []

        def drain():
            if pending:
                metrics.update(torch.cat(pending).cpu().numpy(), np.concatenate(pending_labels))
                pending.clear()
                pending_labels.clear()

        pn = 1 if self.device_planner else max(1, self.cfg.cache.prefetch_num)
        # as in JAX: the cache's windows ship the dense features in
        # dense_input_dtype, while a fully resident table is scored batch by
        # batch on the f32 features
        eval_dense = None if isinstance(self.embed, CachedEmbeddingBag) else "float32"
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
            win = self._begin_window(window, with_plan=False, dense_mode=eval_dense)
            self._finish_window(win)
            self._land_admits(win)
            if self.mesh is not None:  # each step's scores of the global batch, on every rank
                pending += mesh_window.eval_window(self, win)
            else:
                for p in range(len(window)):
                    sparse = self._pooled(win, p, self._gathered_rows(win, p), self.embed.cache_weight.dtype)
                    pending.append(_model_probs(self.cfg.model, self.model(win.dense[p], sparse)))
            pending_labels.append(np.concatenate([b.labels.numpy() for b in window]))
            if len(pending) >= _EVAL_READBACK_STEPS:
                drain()
        drain()
        return metrics.compute()

    def close(self) -> None:
        """Land outstanding writebacks and stop the cache's drain thread."""
        self.embed.close()
