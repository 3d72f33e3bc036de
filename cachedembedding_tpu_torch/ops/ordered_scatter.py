"""Ordered adds into rows of the storage dtype (Kernel 5 of the port): the
update of the JAX trainer's sparse-gradient branch, and the update of its
dense branch on ragged windows.

Counterpart of ``cw.at[v].add((-slr * g.astype(f32)).astype(cw.dtype))`` in
``cachedembedding_tpu/train/trainer.py`` (``_scan_window``), which XLA lowers
to a scatter whose combiner adds in the rows' dtype: every addend is rounded
to that dtype, and so is the row after each add, in stream order. No Pallas
kernel is involved; the port has a CUDA kernel (``csrc/ordered_scatter_add.cu``)
because no PyTorch call computes the ordered function: ``index_add_`` adds
with atomics on CUDA, in an order that changes from launch to launch, and
has no fp8.

    ordered_scatter_add_(cw, g, perm, v_grouped, slr)
        for i in stream order:  cw[v_i] = round(cw[v_i] + round(-slr * g[i]))

with ``round`` the cast to ``cw.dtype`` as ``jnp.astype`` casts it
(``ops/rounding.astype_storage``) and ``g`` in ``cw``'s dtype (f32, bf16,
float8_e4m3fn or float8_e5m2). In bf16, 1000 addends of 1.0 into a zero row
give 256: past 256 a bf16 step is 2, and 256 + 1 rounds back to 256.

The plan is the update's ``sort_plan_np`` (``ops/binned_scatter.py``): the
stream sorted stably by row, so each row's contributors are one run in
stream order, and a run's adds are a chain (each depends on the one
before). For bf16 and fp8 rows the kernel finds the heavy runs (more than
``heavy_threshold(L)`` contributors, at least HEAVY_RUN_MIN) on the card,
sorts them longest first, and gives each to a block that feeds the chain
from a ring of RING_STAGES stages of 32 grad rows in shared memory, filled
ahead by producer warps; the other runs (all runs of f32 rows) are walked
by warps, in registers, in a launch that overlaps the heavy one. No atomics
touch a value: it gives the plain version's bits, and the same bits on
every launch. On a plan not sorted by id it stops with a device-side
assert. The wrapper allocates the kernel's scratch (the heavy-run list);
``last_heavy_runs`` reads how many runs the last launch sent through the
ring.

The dense branch of a ragged window (``_scan_window``'s final ``else``)
differentiates with respect to the whole ``cw`` in its storage dtype: the
f32 row grads are cast to ``cw.dtype``, the transpose of the row gather adds
them **in that dtype, into zero rows, in stream order**, and only then does
the f32 update round each row once. ``ordered_grad_update_`` walks the same
plan and computes exactly that, with no (C, D) grad:

    ordered_grad_update_(cw, accum, g, perm, v_grouped, slr, eps)
        s_v = +0;  for i in stream order with v_i = v:  s_v = round(s_v + g[i])
        SGD (accum None):  cw[v] = round(cw[v] - slr * s_v)
        row-wise Adagrad:  accum[v] += mean(s_v * s_v)
                           cw[v] = round(cw[v] - slr * (s_v / (sqrt(accum[v]) + eps)))

with the mean's f32 sum taken in column order (XLA's order on its CPU
backend for D <= 32; the kernel's and the plain version's for every D).
Beyond D = 32 XLA sums in a vectorized order of its own: there the
accumulators differ from ``jnp.mean``'s within rtol 1e-6 and the rows by at
most one storage ulp (f32 rows: plus 1e-6 of the update where they cancel).

Untouched rows are not visited (JAX's ``cw - slr * 0`` leaves them equal).
So fp8 rows accumulate their ragged grads in fp8: that is JAX's function.
On the card the Adagrad entry needs the row in one warp: D <= 128 (D <= 32
where D is not a multiple of 4).

On a CPU tensor each wrapper runs its plain PyTorch version, which applies
the k-th contributor of every row in one indexed write, for k = 0, 1, ...;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from cachedembedding_tpu_torch.ops import _cuda
from cachedembedding_tpu_torch.ops.rounding import astype_storage, index_copy_storage_, index_select_f32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
HEAVY_RUN_MIN = 256     # kHeavyMin in csrc/ordered_scatter_add.cu
MAX_HEAVY_RUNS = 16384  # kMaxHeavy: the heavy-run list, sorted in shared memory
# kStages: the ring's stages of 32 grad rows, by row dtype (96 KB of 128-column slabs, at most 16);
# f32 rows take no ring (kHasRing)
RING_STAGES = {torch.bfloat16: 12, torch.float8_e4m3fn: 16, torch.float8_e5m2: 16}
_last_scratch: Optional[torch.Tensor] = None


def heavy_threshold(L: int) -> int:
    """Runs of more than this many contributors take the kernel's ring: at
    least HEAVY_RUN_MIN, and enough that a step's heavy runs fit the list."""
    return max(HEAVY_RUN_MIN, -(-L // MAX_HEAVY_RUNS))


def heavy_runs(v_grouped: torch.Tensor, dtype: torch.dtype) -> int:
    """How many runs of the sorted plan take the kernel's ring for rows of
    ``dtype`` (none for f32 rows)."""
    if dtype not in RING_STAGES:
        return 0
    _, counts = torch.unique_consecutive(v_grouped, return_counts=True)
    return int((counts > heavy_threshold(v_grouped.shape[0])).sum())


def last_heavy_runs() -> int:
    """The heavy runs that the last CUDA launch of either entry found (its
    scratch's counter; 0 where no run could be heavy). Synchronizes."""
    return 0 if _last_scratch is None else int(_last_scratch.view(torch.int32)[0])


def _scratch(L: int, cw: torch.Tensor) -> int:
    """The kernel's scratch for a plan of L ids into ``cw``, as a pointer (0
    where no run can be heavy): two counters, then room for every run that
    can be. Kept until the next launch, for ``last_heavy_runs``."""
    global _last_scratch
    t = heavy_threshold(L)
    _last_scratch = (torch.empty(1 + L // (t + 1), dtype=torch.int64, device=cw.device)
                     if L > t and cw.dtype in RING_STAGES else None)
    return 0 if _last_scratch is None else _last_scratch.data_ptr()


def _check_plan(name: str, cw, g, perm, v_grouped) -> None:
    C, D = cw.shape
    L = g.shape[0]
    if g.shape != (L, D) or perm.shape != (L,) or v_grouped.shape != (L,):
        raise ValueError(f"{name}: g (L, D), perm (L,) and v_grouped (L,) must agree")
    if g.dtype != cw.dtype:
        raise ValueError(f"g is {g.dtype}, cw is {cw.dtype}: {name} takes grads in the rows' dtype")


def _check_cuda(name: str, tensors) -> None:
    cw = tensors[0]
    if any(t.device != cw.device for t in tensors) or cw.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on the same CUDA device")
    if cw.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} supports float32, bfloat16 and fp8 rows, not {cw.dtype}")
    if any(t.dtype != torch.int32 for t in tensors[-2:]):
        raise ValueError("perm and v_grouped must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def bf16_add_sweep(device) -> tuple:
    """The check behind the kernel's bf16 chain, which adds with the card's
    bf16 add: against the f32 add then the cast to bf16, on all 2^32 pairs
    of bf16 operands. Returns (pairs whose bits differ, of them the pairs
    where both are NaN). A check, not a step's kernel: no launch count."""
    counts = torch.empty(2, dtype=torch.int64, device=device)
    rc = _cuda.kernel_entry("bf16_add_sweep")(counts.data_ptr(), _cuda.stream_of(counts))
    _cuda.check_launch("bf16_add_sweep", rc)
    return tuple(int(x) for x in counts.tolist())


def chain_latency(addends: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's chain alone, in registers, for rows of ``dtype``: 32 lanes
    each run n (a multiple of 8) dependent links w = round(w + a) from +0,
    cycling through their 8 addends (``addends``: (32, 8) f32 on the card,
    values of ``dtype``). Returns each lane's w, (32,) f32. A measurement,
    not a step's kernel: no launch count."""
    if addends.shape != (32, 8) or addends.dtype != torch.float32 or not addends.is_cuda or n % 8:
        raise ValueError("chain_latency takes (32, 8) f32 addends on the card and n a multiple of 8")
    addends = addends.contiguous()
    out = torch.empty(32, dtype=torch.float32, device=addends.device)
    rc = _cuda.kernel_entry("chain_latency")(addends.data_ptr(), out.data_ptr(), n, _DTYPE_CODES[dtype],
                                             _cuda.stream_of(out))
    _cuda.check_launch("chain_latency", rc)
    return out


def occurrence_rank(v_grouped: torch.Tensor) -> torch.Tensor:
    """Each element's rank among its row's contributors in a sorted stream."""
    L = v_grouped.shape[0]
    pos = torch.arange(L, device=v_grouped.device)
    start = torch.ones(L, dtype=torch.bool, device=v_grouped.device)
    start[1:] = v_grouped[1:] != v_grouped[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)), dim=0).values
    return pos - first


def ordered_scatter_add_plain(
    cw: torch.Tensor, g: torch.Tensor, perm: torch.Tensor, v_grouped: torch.Tensor, slr: float,
) -> torch.Tensor:
    """Plain PyTorch version (in place): the addends rounded to cw's dtype,
    then applied rank by rank, each add rounded."""
    ids = v_grouped.long()
    a = astype_storage(g.index_select(0, perm.long()).float() * -slr, cw.dtype).float()
    rank = occurrence_rank(v_grouped)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = torch.nonzero(rank == k)[:, 0]
        rows = ids.index_select(0, sel)
        index_copy_storage_(cw, rows, index_select_f32(cw, rows) + a.index_select(0, sel))
    return cw


def ordered_scatter_add_(
    cw: torch.Tensor,          # (C, D) rows, updated in place
    g: torch.Tensor,           # (L, D) row grads in stream order, cw's dtype
    perm: torch.Tensor,        # (L,) int32 permutation sorting the stream stably by id
    v_grouped: torch.Tensor,   # (L,) int32 ids, sorted
    slr: float,                # sparse learning rate
) -> torch.Tensor:
    """cw[v_i] = round(cw[v_i] + round(-slr * g[i])) in stream order; returns cw."""
    _check_plan("ordered_scatter_add_", cw, g, perm, v_grouped)
    tensors = (cw, g, perm, v_grouped)
    if all(t.device.type == "cpu" for t in tensors):
        return ordered_scatter_add_plain(cw, g, perm, v_grouped, float(slr))
    _check_cuda("ordered_scatter_add_", tensors)
    L, D = g.shape
    rc = _cuda.kernel_entry("ordered_scatter_add")(
        cw.data_ptr(), g.data_ptr(), perm.data_ptr(), v_grouped.data_ptr(), L, D, -float(slr),
        _DTYPE_CODES[cw.dtype], _scratch(L, cw), _cuda.stream_of(cw),
    )
    _cuda.check_launch("ordered_scatter_add", rc)
    ordered_scatter_add_.launches += 1
    return cw


ordered_scatter_add_.launches = 0


def ordered_grad_update_plain(
    cw: torch.Tensor, accum: Optional[torch.Tensor], g: torch.Tensor, perm: torch.Tensor,
    v_grouped: torch.Tensor, slr: float, eps: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version (in place on ``cw`` and ``accum``): each touched
    row's grads summed rank by rank into a zero row, each add rounded to
    cw's dtype, then the f32 epilogue. The elements are sorted by rank once,
    so rank k is one slice."""
    if v_grouped.numel() == 0:
        return cw
    rows, run_of = torch.unique_consecutive(v_grouped.long(), return_inverse=True)
    rank = occurrence_rank(v_grouped)
    order = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    gs = index_select_f32(g, perm.long().index_select(0, order))
    run_o = run_of.index_select(0, order)
    s = torch.zeros((rows.numel(), cw.shape[1]), dtype=torch.float32, device=cw.device)
    start = 0
    for n in sizes:
        j = run_o[start:start + n]
        s.index_copy_(0, j, astype_storage(s.index_select(0, j) + gs[start:start + n], cw.dtype).float())
        start += n
    if accum is not None:
        ss = torch.zeros(rows.numel(), dtype=torch.float32, device=cw.device)
        for j in range(cw.shape[1]):  # the squares summed in column order, as the kernel sums them
            ss = ss + s[:, j] * s[:, j]
        a = accum.index_select(0, rows) + ss / cw.shape[1]
        accum.index_copy_(0, rows, a)
        # torch's f32 sqrt on the CPU is not always correctly rounded (JAX's
        # and __fsqrt_rn are); from f64 it is
        s = s / (torch.sqrt(a.double()).float() + eps)[:, None]
    index_copy_storage_(cw, rows, index_select_f32(cw, rows) - slr * s)
    return cw


def ordered_grad_update_(
    cw: torch.Tensor,                # (C, D) rows, updated in place
    accum: Optional[torch.Tensor],   # (C,) f32 row-wise Adagrad accumulators (in place), or None: SGD
    g: torch.Tensor,                 # (L, D) row grads in stream order, cw's dtype
    perm: torch.Tensor,              # (L,) int32 permutation sorting the stream stably by id
    v_grouped: torch.Tensor,         # (L,) int32 ids, sorted
    slr: float,                      # sparse learning rate
    eps: float = 0.0,                # Adagrad's epsilon
) -> torch.Tensor:
    """The dense ragged update: each touched row's grads summed in cw's dtype
    in stream order from +0, then ``cw = round(cw - slr * s)`` (SGD) or
    row-wise Adagrad on s; returns cw."""
    _check_plan("ordered_grad_update_", cw, g, perm, v_grouped)
    if accum is not None and (accum.shape != (cw.shape[0],) or accum.dtype != torch.float32):
        raise ValueError(f"accum must be ({cw.shape[0]},) float32, not {tuple(accum.shape)} {accum.dtype}")
    tensors = tuple(t for t in (cw, accum, g, perm, v_grouped) if t is not None)
    if all(t.device.type == "cpu" for t in tensors):
        return ordered_grad_update_plain(cw, accum, g, perm, v_grouped, float(slr), float(eps))
    _check_cuda("ordered_grad_update_", tensors)
    L, D = g.shape
    if accum is not None and (D > 128 or (D % 4 and D > 32)):
        raise ValueError(f"the Adagrad entry takes each row in one warp: D <= 128 (D <= 32 where D is not "
                         f"a multiple of 4), not {D}")
    rc = _cuda.kernel_entry("ordered_grad_update")(
        cw.data_ptr(), 0 if accum is None else accum.data_ptr(), g.data_ptr(), perm.data_ptr(),
        v_grouped.data_ptr(), L, D, float(slr), float(eps), _DTYPE_CODES[cw.dtype], _scratch(L, cw),
        _cuda.stream_of(cw),
    )
    _cuda.check_launch("ordered_grad_update", rc)
    ordered_grad_update_.launches += 1
    return cw


ordered_grad_update_.launches = 0


# ordered_run_cases' shapes: name -> (D, elements the card's grads sit off
# 16-byte alignment). D = 18 and the offset take the kernel's one-element-a-
# lane path; Adagrad takes D = 128 and D = 32 (ORDERED_ADAGRAD_SHAPES).
ORDERED_RUN_SHAPES = {"D128": (128, 0), "D18": (18, 0), "D128 misaligned": (128, 1), "D32": (32, 0)}
ORDERED_ADAGRAD_SHAPES = ("D128", "D32")


def ordered_run_lengths() -> list:
    """Run lengths on the kernel's edges: one warp's batch (31, 32, 33), the
    heavy threshold of a plan of fewer than MAX_HEAVY_RUNS * HEAVY_RUN_MIN
    ids (- 1, at, + 1), one more than each ring (bf16, fp8) holds, and a run
    of several thousand."""
    rings = sorted({32 * s + 1 for s in RING_STAGES.values()})
    return [1, 31, 32, 33, HEAVY_RUN_MIN - 1, HEAVY_RUN_MIN, HEAVY_RUN_MIN + 1, *rings, 3000]


def ordered_run_cases(seed: int = 0) -> list:
    """Kernel 5 plans whose runs have ``ordered_run_lengths``, one case per
    ORDERED_RUN_SHAPES entry: [(name, case)], each case a dict of numpy
    arrays and scalars that a test hands to JAX and to the port alike:
    ``cw0`` (C, D) f32 rows, ``g`` (L, D) f32 grads (cast to the rows' dtype
    by the caller), ``v`` (L,) int32 ids in stream order, ``acc0`` (C,) f32
    Adagrad accumulators, ``slr``, ``eps``, ``offset``, and ``run_rows``
    (the row of each of ``ordered_run_lengths``' runs). The runs sit on
    rows that include three adjacent ones (the threshold's) and row C - 1; 400 light ids fill
    other rows; the stream order is shuffled; some grad rows repeat others
    (the same values at several stream positions)."""
    import numpy as np

    lengths = ordered_run_lengths()
    out = []
    for k, (name, (D, offset)) in enumerate(ORDERED_RUN_SHAPES.items()):
        rng = np.random.default_rng(seed * 1000 + k)
        C = 1024
        rows = rng.choice(np.arange(10, C - 1), len(lengths) - 4, replace=False)
        # the threshold's runs on adjacent rows 4, 5, 6, the longest on row C - 1
        run_rows = np.concatenate([rows[:4], [4, 5, 6], rows[4:], [C - 1]]).astype(np.int32)
        free = np.setdiff1d(np.arange(C), run_rows)
        v = np.concatenate([np.repeat(run_rows, lengths), rng.choice(free, 400)]).astype(np.int32)
        v = v[rng.permutation(v.shape[0])]
        L = v.shape[0]
        g = (rng.standard_normal((L, D)) * 0.3).astype(np.float32)
        rep = rng.choice(L, 64, replace=False)
        g[rep[32:]] = g[rep[:32]]  # repeated grad rows
        out.append((name, dict(cw0=rng.standard_normal((C, D)).astype(np.float32), g=g, v=v,
                               acc0=rng.random(C).astype(np.float32), slr=0.37, eps=1e-10, offset=offset,
                               run_rows=run_rows)))
    return out
