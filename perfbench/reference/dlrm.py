"""Plain reference of the benchmark's DLRM training steps: PyTorch operations
only, arithmetic in float32 with TF32 off. It imports nothing of the
program and takes nothing the program made.

The model (DLRM, arXiv:1906.00091, as the configurations state it):

* bottom tower: ``Linear`` + ReLU on every layer, dense features to
  ``embedding_dim``;
* each sparse feature's row of its table (one id a bag), so the batch's
  embeddings are ``(B, F, D)``;
* interaction: the ``F + 1`` vectors (the bottom tower's output first),
  every pairwise dot product ``i < j`` in row-major order, concatenated
  after the bottom tower's output;
* top tower: ``Linear`` + ReLU on all but the last layer, one logit;
* loss: the batch's mean binary cross-entropy on the logit.

Training is plain SGD on every parameter with the configuration's learning
rate. The rows are stored as the configuration states
(``precision.stored_rows``), the initial rows being the canonical init
rounded to that dtype, to nearest even, and each update rounds as the
configuration states (``precision.row_update``):

* ``per_step``: a row's contributions of the step are summed in f32 and
  the row rounds once;
* ``per_addend``: each contribution ``-lr * g``, rounded to the stored
  dtype, is added to the row in the stored dtype, one rounding an addition,
  in the order of the step's ids (example-major: example 0's features
  first).

Everything else, towers included, stays f32.

Only the rows the steps touch are held: a compact table of those rows,
with each batch's ids mapped into it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

_M32 = 0xFFFFFFFF


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


def _rounder(lowered: Optional[torch.dtype]):
    if lowered is None:
        return lambda t: t
    return lambda t: t.to(lowered).float()


def _tower(params: Dict[str, torch.Tensor], arch: str, x: torch.Tensor, last_relu: bool, rnd) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith(arch + ".") and k.endswith(".weight"))
    for i in range(n):
        x = rnd(x) @ rnd(params[f"{arch}.{i}.weight"]).t() + params[f"{arch}.{i}.bias"]
        if last_relu or i + 1 < n:
            x = torch.relu(x)
    return x


def logits(params: Dict[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor,
           lowered: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B,) logits from dense features (B, Din) and embeddings (B, F, D).
    With ``lowered``, every product's operands are rounded to that dtype
    first (products and sums stay f32)."""
    rnd = _rounder(lowered)
    z = _tower(params, "dense_arch", dense, True, rnd)
    v = rnd(torch.cat([z[:, None, :], emb], dim=1))
    n = v.shape[1]
    r, c = torch.triu_indices(n, n, 1, device=v.device)
    dots = torch.bmm(v, v.transpose(1, 2))[:, r, c]
    return _tower(params, "over_arch", torch.cat([z, dots], dim=1), False, rnd)[:, 0]


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


def train_steps(params0: Dict[str, torch.Tensor], rows0: torch.Tensor, steps: List[tuple], lr: float,
                stored: torch.dtype, per_addend: bool = False, keep: Sequence[int] = (),
                lowered: Optional[torch.dtype] = None) -> dict:
    """SGD over ``steps``, each ``(idx (F, B) int64 into the compact rows,
    dense (B, Din) f32, labels (B,))``, from ``params0`` and the compact
    rows ``rows0`` (f32, already in the stored dtype's values), the rows
    updated ``per_step`` or ``per_addend``. Returns the per-step losses, the
    first step's gradient of each compact row (the sum of its lookups'
    gradients), and after each step in ``keep`` (1-based) the dense
    parameters and rows (f32, on the host).

    ``lowered`` is not the reference: it rounds every product's operands
    and each lookup's gradient to that dtype, as a program that computes
    in it would, to show what those roundings alone do to the readings."""
    rnd = _rounder(lowered)
    with _no_tf32():
        params = {k: v.detach().float().clone() for k, v in params0.items()}
        rows = rows0.detach().float().clone()
        losses, after, row_grad = [], {}, None
        for n, (idx, dense, labels) in enumerate(steps, 1):
            for v in params.values():
                v.requires_grad_(True)
            emb = rows[idx.t()].requires_grad_(True)  # (B, F, D)
            loss = bce(logits(params, dense.float(), emb, lowered), labels)
            grads = torch.autograd.grad(loss, [*params.values(), emb])
            with torch.no_grad():
                params = {k: (v - lr * g).detach() for (k, v), g in zip(params.items(), grads[:-1])}
                ids = idx.t().reshape(-1)
                g = rnd(grads[-1].reshape(ids.shape[0], -1))
                summed = torch.zeros_like(rows).index_add_(0, ids, g)
                if row_grad is None:
                    row_grad = summed.cpu()
                if per_addend:
                    add_in_order(rows, ids, (-lr * g).to(stored).float(), stored)
                else:
                    rows = (rows - lr * summed).to(stored).float()
            losses.append(float(loss.detach()))
            if n in keep:
                after[n] = ({k: v.cpu() for k, v in params.items()}, rows.detach().to("cpu", copy=True))
    return {"losses": losses, "row_grad": row_grad, "after": after}
