"""The model-free part of the plain reference: the canonical table init, the
loss, the bags and the training steps. PyTorch operations only, arithmetic
in float32 with TF32 off; it imports nothing of the program and takes
nothing the program made. The dense model is a module of its own beside this
one (``dlrm.py``), which a configuration names (``spec.reference``) and
whose ``logits`` ``train_steps`` takes.

A step's lookups are its ids in the order the program feeds their
gradients to its embedding update: example-major (example 0's features
first, each bag's ids together) for uniform bags, the flat feature-major
stream for ragged ones. Each lookup goes to its bag, and each bag is pooled
from its rows in f32 (a sum, or a mean where the configuration's
``reduction_mode`` says so); a lookup's gradient is its bag's.

Training is plain SGD on the dense parameters, and on the rows the
configuration's ``embedding_optimizer``:

* ``sgd``: each update rounds as ``precision.row_update`` states:
  ``per_step``, a row's summed gradient applied in f32 and the row rounded
  once to the stored dtype; ``per_addend``, each lookup's ``-lr * g``,
  rounded to the stored dtype, added to the row in that dtype, one rounding
  an addition, in lookup order;
* ``rowwise_adagrad``: on the row's summed gradient ``g``, ``acc += mean_d(g
  * g)``, then ``row -= lr * g / (sqrt(acc) + adagrad_eps)``, the row
  rounded once (torchrec's exact row-wise Adagrad), ``acc`` starting at
  ``adagrad_initial``.

A row's gradients of a step are summed as ``precision.row_grad_sum`` states:
``float32`` (the default), or ``stored_in_order``, each lookup's gradient
rounded to the stored dtype and added in that dtype in lookup order from
+0, one rounding an addition.

Only the rows the steps touch are held: a compact table of those rows, with
each step's lookups mapped into it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

_M32 = 0xFFFFFFFF
ROW_UPDATES = ("per_step", "per_addend")
GRAD_SUMS = ("float32", "stored_in_order")


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def canonical_rows(rows: torch.Tensor, table_sizes: Sequence[int], seed: int, dim: int) -> torch.Tensor:
    """(n, dim) f32 initial rows of the global ids ``rows``: per table of E
    rows ``U(-1/sqrt(E), 1/sqrt(E))`` from a 32-bit hash of (row, column,
    seed): ``h0 = mix(row * 0x9E3779B1 + seed)``, ``h = mix(h0 ^ (col *
    0x85EBCA77 + 1))``, value ``(h >> 8) * 2b / 2^24 - b`` rounded once to
    f32 (the canonical init the configurations' tables are defined by)."""
    dev = rows.device
    offs = torch.tensor([0, *torch.tensor(list(table_sizes)).cumsum(0).tolist()], dtype=torch.int64, device=dev)
    table = torch.searchsorted(offs, rows.to(torch.int64), right=True) - 1
    sizes = torch.tensor(list(table_sizes), dtype=torch.float64, device=dev)
    b = (sizes[table] ** -0.5).to(torch.float32)
    r = rows.to(torch.int64) & _M32
    h0 = _mix32((r * 0x9E3779B1 + (int(seed) & _M32)) & _M32)
    j = (torch.arange(dim, dtype=torch.int64, device=dev) * 0x85EBCA77 + 1) & _M32
    h = _mix32(h0[:, None] ^ j[None, :])
    scale = (2.0 * b.double()) / 16777216.0
    return ((h >> 8).double() * scale[:, None] - b.double()[:, None]).to(torch.float32)


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def rounder(lowered: Optional[torch.dtype]) -> Callable:
    """``t`` rounded to ``lowered`` and back to f32, or ``t`` itself."""
    if lowered is None:
        return lambda t: t
    return lambda t: t.to(lowered).float()


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y = y.to(z.dtype)
    return torch.mean(torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs())))


def add_in_order(rows: torch.Tensor, ids: torch.Tensor, addends: torch.Tensor, stored: torch.dtype) -> None:
    """``rows[ids[i]] = stored(rows[ids[i]] + addends[i])`` for i in order,
    in place: a row's additions one after another, distinct rows at once."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    pos = torch.arange(n, device=ids.device)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = s[1:] != s[:-1]
    rank = torch.empty_like(pos)
    rank[order] = pos - torch.cummax(torch.where(first, pos, 0), 0).values  # i's place among its row's
    by_rank = torch.argsort(rank, stable=True)
    bounds = torch.cumsum(torch.bincount(rank), 0).tolist()
    lo = 0
    for hi in bounds:
        sel = by_rank[lo:hi]
        r = ids[sel]
        rows[r] = (rows[r] + addends[sel]).to(stored).float()
        lo = hi


class Step(NamedTuple):
    """One training step's inputs. ``look``: (L,) int64, each lookup's
    compact row, in the program's feed order; ``bag``: (L,) int64, each
    lookup's bag ``b * features + f``, or None where every bag holds one id
    and the lookups are example-major; ``dense`` (B, Din) f32; ``labels``
    (B,)."""

    look: torch.Tensor
    bag: Optional[torch.Tensor]
    dense: torch.Tensor
    labels: torch.Tensor
    features: int


class Adagrad(NamedTuple):
    """Row-wise Adagrad's state: each compact row's accumulator (f32) and
    the configuration's epsilon."""

    acc: torch.Tensor
    eps: float


def _bags(look_rows: torch.Tensor, step: Step, mode: str) -> torch.Tensor:
    """(B, F, D) f32 pooled bags from the lookups' rows."""
    B, F = step.dense.shape[0], step.features
    if step.bag is None:
        return look_rows.view(B, F, -1)
    pooled = torch.zeros((B * F, look_rows.shape[1]), dtype=look_rows.dtype, device=look_rows.device)
    pooled = pooled.index_add(0, step.bag, look_rows)
    if mode == "mean":
        counts = torch.bincount(step.bag, minlength=B * F).clamp_(min=1).to(pooled.dtype)
        pooled = pooled / counts[:, None]
    elif mode != "sum":
        raise ValueError(f"unknown reduction_mode {mode!r}")
    return pooled.view(B, F, -1)


def train_steps(logits: Callable, params0: Dict[str, torch.Tensor], rows0: torch.Tensor, steps: List[Step],
                lr: float, stored: torch.dtype, row_update: str = "per_step", grad_sum: str = "float32",
                keep: Sequence[int] = (), lowered: Optional[torch.dtype] = None, mode: str = "sum",
                adagrad: Optional[Adagrad] = None) -> dict:
    """The reference's training over ``steps`` from ``params0`` and the
    compact rows ``rows0`` (f32, already in the stored dtype's values), the
    model's ``logits(params, dense, emb, lowered)``; with ``adagrad``, the
    rows train by row-wise Adagrad from its state, else by SGD. Returns the
    per-step losses, the first step's gradient of each compact row (the sum
    of its lookups' gradients, as ``grad_sum`` sums them), and after each
    step in ``keep`` (1-based) the dense parameters, the rows and the
    accumulators (None under SGD), f32, on the host.

    ``lowered`` is not the reference: it rounds every product's operands
    and each lookup's gradient to that dtype, as a program that computes
    in it would, to show what those roundings alone do to the readings."""
    if row_update not in ROW_UPDATES or grad_sum not in GRAD_SUMS:
        raise ValueError(f"unknown row_update {row_update!r} or row_grad_sum {grad_sum!r}")
    if adagrad is not None and row_update != "per_step":
        raise ValueError("row-wise Adagrad updates each row once a step: row_update must be per_step")
    rnd = rounder(lowered)
    with _no_tf32():
        params = {k: v.detach().float().clone() for k, v in params0.items()}
        rows = rows0.detach().float().clone()
        acc = None if adagrad is None else adagrad.acc.detach().float().clone().to(rows.device)
        losses, after, row_grad = [], {}, None
        for n, step in enumerate(steps, 1):
            for v in params.values():
                v.requires_grad_(True)
            look = rows[step.look].requires_grad_(True)  # (L, D)
            emb = _bags(look, step, mode)
            loss = bce(logits(params, step.dense.float(), emb, lowered), step.labels)
            grads = torch.autograd.grad(loss, [*params.values(), look])
            with torch.no_grad():
                params = {k: (v - lr * g).detach() for (k, v), g in zip(params.items(), grads[:-1])}
                ids = step.look
                g = rnd(grads[-1])
                summed = torch.zeros_like(rows)
                if grad_sum == "stored_in_order":
                    add_in_order(summed, ids, g.to(stored).float(), stored)
                else:
                    summed.index_add_(0, ids, g)
                if row_grad is None:
                    row_grad = summed.cpu()
                if adagrad is not None:
                    t = torch.unique(ids)
                    s = summed[t]
                    a = acc[t] + torch.mean(s * s, dim=1)
                    acc[t] = a
                    rows[t] = (rows[t] - lr * s / (torch.sqrt(a.double()).float() + adagrad.eps)[:, None]
                               ).to(stored).float()
                elif row_update == "per_addend":
                    add_in_order(rows, ids, (-lr * g).to(stored).float(), stored)
                else:
                    rows = (rows - lr * summed).to(stored).float()
            losses.append(float(loss.detach()))
            if n in keep:
                after[n] = ({k: v.cpu() for k, v in params.items()}, rows.detach().to("cpu", copy=True),
                            None if acc is None else acc.to("cpu", copy=True))
    return {"losses": losses, "row_grad": row_grad, "after": after}
