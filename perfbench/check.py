"""The comparison that decides ``correct``: the program's training against
the plain reference's (``reference/dlrm.py``), in two stretches.

* **The start**: the first three steps from the seed. Both sides start from
  the same inputs (the benchmark's dense weights, the canonical table
  init, the same three batches).
* **The timed stretch**: the timed ``train`` call's first windows, at the
  timed sizes, with the cache full, evicting and writing rows back. The
  reference starts from the program's state read back just before the
  call (its dense parameters and the rows those windows touch) and is
  compared with the state read back when the trainer pulls the next
  window's first batch.

Both are read the same way, as gaps of norms: a leaf's ``|norm -
norm_ref| / max(norm_ref, median leaf's norm_ref)``. A leaf is one dense
parameter or one embedding table (its touched rows), each group against
its own median leaf.

* ``loss_gap``, ``stretch_loss_gap``: the largest ``|loss - loss_ref| /
  |loss_ref|`` over the stretch's steps;
* ``grad_gap_tables``: each table's first gradient as its update got it:
  the grad rows fed to the program's embedding update on step 1, summed
  per row, against the reference's f32 row gradients; the worst table;
* ``grad_gap_dense``: each dense leaf's first gradient, worked out from
  its state after step 1 (``(before - after) / lr``); the median leaf;
* ``change_gap_dense``, ``change_gap_tables`` (over the start's three
  steps) and ``stretch_change_gap_*`` (over the stretch): each leaf's
  change; the median leaf;
* ``writeback_gap``: the change over the stretch of the rows it touched
  that the program holds in its host table when the stretch ends (rows
  the stretch admitted, updated, evicted and wrote back), as one leaf.

The median leaf, not the worst, for the changes and the dense gradient:
the tables are stored in bf16 and the towers multiply bf16-rounded
operands, as the configurations state, so a leaf that moves by few last
places, or a dense leaf whose gradient is what is left after its
examples' terms cancel, reads round-off of its own size; the reference
with those roundings alone (``reference.train_steps(lowered=...)``)
reads the same. The worst leaf is printed beside each.
Leaves whose reference gradient is under a thousandth of their group's
median leaf's move by round-off alone and are left out.
Each number is held to the cell's limit (``perfbench/limits/<cell>.json``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

_NEGLIGIBLE = 1e-3  # a leaf's reference gradient under this share of the median leaf's: round-off only
START = ("loss_gap", "grad_gap_dense", "change_gap_dense", "grad_gap_tables", "change_gap_tables")
STRETCH = ("stretch_loss_gap", "stretch_change_gap_dense", "stretch_change_gap_tables")


def numbers_of(config: dict) -> tuple:
    """The numbers that decide ``correct`` for a configuration: the
    writeback's only where a cache evicts."""
    return START + STRETCH + (("writeback_gap",) if config["embedding"] == "cached" else ())


def leaves(dense: Dict[str, torch.Tensor], rows: torch.Tensor, table_of_row: np.ndarray,
           num_tables: int) -> Dict[str, torch.Tensor]:
    """One state as leaves: the dense parameters by name and ``table<t>``,
    the compact rows of table t."""
    out = {k: v.double() for k, v in dense.items()}
    r = rows.double()
    for t in range(num_tables):
        out[f"table{t}"] = r[torch.from_numpy(np.flatnonzero(table_of_row == t))]
    return out


def _norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], scale: float) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm((a[k] - b[k]).detach())) / scale for k in a}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap of norms, against the larger of its reference
    norm and the median kept leaf's."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def _kept(g_ref: Dict[str, float], tables: bool) -> List[str]:
    """A group's leaves whose reference gradient is not round-off."""
    names = [k for k in g_ref if k.startswith("table") == tables]
    med = statistics.median(g_ref[k] for k in names)
    return [k for k in names if g_ref[k] >= _NEGLIGIBLE * med and g_ref[k] > 0]


def _put(out: dict, number: str, gaps: Dict[str, float], how: str) -> None:
    """``out[number]``: the worst or the median leaf's gap; beside it the
    leaf and the worst gap, for the look."""
    if not gaps:
        out[number], out[number + ".leaf"], out[number + ".worst"] = 0.0, None, 0.0
        return
    order = sorted(gaps, key=gaps.get)
    k = order[-1] if how == "worst" else order[len(order) // 2]
    out[number], out[number + ".leaf"], out[number + ".worst"] = gaps[k], k, gaps[order[-1]]


def _loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def readings(prog: dict, ref: dict, lr: float) -> dict:
    """The start's numbers. ``prog`` and ``ref`` each hold ``losses`` (3),
    ``grad_tables`` (leaves: each table's first row gradients) and ``s0``,
    ``s1``, ``s3``: leaves (``leaves``) before step 1, after step 1 and
    after step 3."""
    out = {"loss_gap": _loss_gap(prog["losses"], ref["losses"]),
           "losses": list(prog["losses"]), "losses_ref": list(ref["losses"])}
    g_ref, g_prog = _norms(ref["s0"], ref["s1"], lr), _norms(prog["s0"], prog["s1"], lr)
    zero = {k: torch.zeros_like(v) for k, v in ref["grad_tables"].items()}
    g_ref.update(_norms(ref["grad_tables"], zero, 1.0))
    g_prog.update(_norms(prog["grad_tables"], zero, 1.0))
    c_ref, c_prog = _norms(ref["s3"], ref["s0"], 1.0), _norms(prog["s3"], prog["s0"], 1.0)
    for group, tables in (("dense", False), ("tables", True)):
        keep = _kept(g_ref, tables)
        _put(out, f"grad_gap_{group}", _gaps(g_prog, g_ref, keep), "worst" if tables else "median")
        _put(out, f"change_gap_{group}", _gaps(c_prog, c_ref, keep), "median")
        out[f"kept_{group}"] = f"{len(keep)} of {sum(1 for k in g_ref if k.startswith('table') == tables)}"
    return out


def stretch_readings(prog: dict, ref: dict, lr: float) -> dict:
    """The timed stretch's numbers. ``prog`` holds ``losses`` and ``sB``
    (leaves when the stretch ends) and ``host`` (the same for the rows read
    from the host table then, as one leaf); ``ref`` holds ``losses``,
    ``s1`` and ``sB`` (after its first and last step) and ``host``; both
    start from ``sA`` (the program's state before the stretch)."""
    sA = prog["sA"]
    out = {"stretch_loss_gap": _loss_gap(prog["losses"], ref["losses"])}
    g_ref = _norms(sA, ref["s1"], lr)
    c_ref, c_prog = _norms(ref["sB"], sA, 1.0), _norms(prog["sB"], sA, 1.0)
    for group, tables in (("dense", False), ("tables", True)):
        keep = _kept(g_ref, tables)
        _put(out, f"stretch_change_gap_{group}", _gaps(c_prog, c_ref, keep), "median")
    a, p, r = prog["host"]["A"], prog["host"]["B"], ref["host"]["B"]
    out["writeback_rows"] = int(a.shape[0])
    if a.shape[0]:
        n_ref = float(torch.linalg.vector_norm(r - a))
        n_prog = float(torch.linalg.vector_norm(p - a))
        out["writeback_gap"] = abs(n_prog - n_ref) / n_ref if n_ref > 0 else float("nan")
    else:
        out["writeback_gap"] = float("nan")
    return out


def judge(read: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}): each number that the cell's
    limits name at or under its limit, and finite."""
    checks = {k: {"value": read[k], "limit": v} for k, v in limits.items() if k != "set_from"}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
