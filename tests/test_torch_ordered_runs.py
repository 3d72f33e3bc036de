"""Kernel 5's plain versions on plans whose runs sit on the CUDA kernel's
edges (``ordered_run_cases``: runs of 1, 31, 32, 33 contributors, the heavy
threshold - 1, at and + 1, one more than the bf16 and the fp8 rings hold,
and 3,000), against the JAX package's functions, bit for bit.

The scatter entry is JAX's sparse-branch update ``cw.at[v].add((-slr *
g).astype(cw.dtype))``; the dense entry is the transpose of JAX's row gather
in the rows' dtype, then its SGD or row-wise Adagrad update. Adagrad's mean
square is summed over a row in column order: XLA's own order on its CPU
backend for D <= 32 (``jnp.mean`` there), the port's for every D. At D = 128
XLA sums a row in a vectorized order of its own, so the bit-exact reference
there is JAX's update with the row's sum taken in column order by JAX ops;
against XLA's own ``jnp.mean`` update the accumulators are held within rtol
1e-6 (f32 sums of 128 squares in two orders) and the rows within one
storage ulp, plus 1e-6 of the update where an f32 row cancels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np
from cachedembedding_tpu_torch.ops.ordered_scatter import (
    HEAVY_RUN_MIN,
    MAX_HEAVY_RUNS,
    ORDERED_ADAGRAD_SHAPES,
    ORDERED_RUN_SHAPES,
    RING_STAGES,
    heavy_runs,
    heavy_threshold,
    ordered_grad_update_,
    ordered_run_cases,
    ordered_run_lengths,
    ordered_scatter_add_,
)
from cachedembedding_tpu_torch.ops.rounding import astype_storage

ROW_DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
CASES = dict(ordered_run_cases(0))


def _plan(case):
    return (torch.from_numpy(a) for a in sort_plan_np(case["v"], case["cw0"].shape[0])[:2])


def _jax_scatter(case, name):
    dt = jnp.dtype(name)
    cw, g = jnp.asarray(case["cw0"]).astype(dt), jnp.asarray(case["g"]).astype(dt)
    out = cw.at[jnp.asarray(case["v"])].add((-case["slr"] * g.astype(jnp.float32)).astype(dt),
                                            mode="promise_in_bounds")
    return np.asarray(out.astype(jnp.float32))


def _storage_ulp(x, name):
    """The spacing of the rows' dtype at |x| (its subnormal spacing below the
    smallest normal)."""
    fi = jnp.finfo(jnp.dtype(name))
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), float(fi.smallest_normal)))) - fi.nmant)


def _within_xla_update(got, want, cw0, name):
    """Rows of an Adagrad step whose accumulators differ from XLA's within
    rtol 1e-6: within one storage ulp of XLA's rows, plus 1e-6 of the
    update's size (an f32 row near cw0 - slr * u = 0 cancels)."""
    return np.abs(got - want) <= _storage_ulp(want, name) + 1e-6 * np.abs(cw0 - want)


def _row_mean_sq(g32, column_order: bool):
    if not column_order:
        return jnp.mean(g32 * g32, axis=1)
    ss = jnp.zeros(g32.shape[0], jnp.float32)
    for j in range(g32.shape[1]):
        ss = ss + g32[:, j] * g32[:, j]
    return ss / g32.shape[1]


def _jax_dense_update(case, name, adagrad: bool, column_order: bool = False):
    """JAX's dense ragged update: the cotangent of ``take(cw, v)`` w.r.t. cw
    (the grads cast to the rows' dtype, added in it), then the f32 update."""
    dt = jnp.dtype(name)
    cw = jnp.asarray(case["cw0"]).astype(dt)
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(case["v"]), axis=0, mode="wrap").astype(jnp.float32), cw)
    (g,) = vjp(jnp.asarray(case["g"]))
    g32 = g.astype(jnp.float32)
    acc = None
    if adagrad:
        acc = jnp.asarray(case["acc0"]) + _row_mean_sq(g32, column_order)
        g32 = g32 / (jnp.sqrt(acc) + case["eps"])[:, None]
    out = (cw.astype(jnp.float32) - case["slr"] * g32).astype(dt)
    return np.asarray(out.astype(jnp.float32)), None if acc is None else np.asarray(acc)


def test_cases_sit_on_the_kernel_edges():
    """Each case's sorted plan has runs of exactly ordered_run_lengths (and
    light filler), the threshold of a plan of its size is HEAVY_RUN_MIN, and
    the runs above it, one more than each ring, are the heavy ones."""
    lengths = ordered_run_lengths()
    assert sorted({32 * s + 1 for s in RING_STAGES.values()}) == [385, 513]
    for name, case in CASES.items():
        _, grouped = _plan(case)
        counts = np.bincount(grouped.numpy(), minlength=case["cw0"].shape[0])
        L = grouped.shape[0]
        assert heavy_threshold(L) == HEAVY_RUN_MIN
        assert counts[case["run_rows"]].tolist() == lengths
        assert counts.max() == max(lengths) and np.sort(counts)[-len(lengths) - 1] < 31  # the filler is light
        assert heavy_runs(grouped, torch.bfloat16) == sum(n > HEAVY_RUN_MIN for n in lengths) == 4
        assert heavy_runs(grouped, torch.float32) == 0  # f32 rows take no ring
        assert case["cw0"].shape[1] == ORDERED_RUN_SHAPES[name][0]
        assert case["v"].max() == case["cw0"].shape[0] - 1  # a run on the last row


def test_heavy_threshold_keeps_the_list_short():
    for L in (1, HEAVY_RUN_MIN * MAX_HEAVY_RUNS, HEAVY_RUN_MIN * MAX_HEAVY_RUNS + 1, 10**8):
        t = heavy_threshold(L)
        assert t >= HEAVY_RUN_MIN and L // (t + 1) < MAX_HEAVY_RUNS


@pytest.mark.parametrize("name", ROW_DTYPES)
@pytest.mark.parametrize("shape", list(ORDERED_RUN_SHAPES))
def test_ordered_scatter_runs_bit_equal_to_jax(shape, name):
    case = CASES[shape]
    dt = getattr(torch, name)
    perm, grouped = _plan(case)
    cw = astype_storage(torch.from_numpy(case["cw0"].copy()), dt)  # f32 rows: no copy by the cast
    got = ordered_scatter_add_(cw, astype_storage(torch.from_numpy(case["g"]), dt), perm, grouped, case["slr"])
    np.testing.assert_array_equal(got.float().numpy(), _jax_scatter(case, name))


@pytest.mark.parametrize("name", ROW_DTYPES)
@pytest.mark.parametrize("shape", list(ORDERED_RUN_SHAPES))
def test_ordered_grad_update_sgd_runs_bit_equal_to_jax(shape, name):
    case = CASES[shape]
    dt = getattr(torch, name)
    perm, grouped = _plan(case)
    cw = astype_storage(torch.from_numpy(case["cw0"].copy()), dt)  # f32 rows: no copy by the cast
    got = ordered_grad_update_(cw, None, astype_storage(torch.from_numpy(case["g"]), dt), perm, grouped,
                               case["slr"])
    want, _ = _jax_dense_update(case, name, adagrad=False)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", ROW_DTYPES)
@pytest.mark.parametrize("shape", list(ORDERED_ADAGRAD_SHAPES))
def test_ordered_grad_update_adagrad_runs_bit_equal_to_jax(shape, name):
    case = CASES[shape]
    dt = getattr(torch, name)
    perm, grouped = _plan(case)
    cw = astype_storage(torch.from_numpy(case["cw0"].copy()), dt)  # f32 rows: no copy by the cast
    acc = torch.from_numpy(case["acc0"].copy())
    got = ordered_grad_update_(cw, acc, astype_storage(torch.from_numpy(case["g"]), dt), perm, grouped,
                               case["slr"], case["eps"])
    D = case["cw0"].shape[1]
    want, want_acc = _jax_dense_update(case, name, adagrad=True, column_order=D > 32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    xla_rows, xla_acc = _jax_dense_update(case, name, adagrad=True)
    np.testing.assert_allclose(acc.numpy(), xla_acc, rtol=1e-6)
    cw0 = astype_storage(torch.from_numpy(case["cw0"]), dt).float().numpy()
    assert _within_xla_update(got.float().numpy(), xla_rows, cw0, name).all()


@pytest.mark.parametrize("name", ROW_DTYPES)
@pytest.mark.parametrize("shape", list(ORDERED_ADAGRAD_SHAPES))
def test_adagrad_mean_square_order_against_xla(shape, name):
    """How far the row sum's order moves Adagrad from XLA's ``jnp.mean``
    update: the port's column order, and torch's vectorized ``mean`` (the
    order of the plain version before the kernel summed in column order).
    Both within rtol 1e-6 (accumulators) and one storage ulp (rows); column
    order bit-equal at D <= 32. Prints the reading (run with ``-s``):
    accumulators and row elements that differ from XLA's."""
    case = CASES[shape]
    dt = getattr(torch, name)
    perm, grouped = _plan(case)
    g = astype_storage(torch.from_numpy(case["g"]), dt)
    cw0 = astype_storage(torch.from_numpy(case["cw0"].copy()), dt)
    xla_rows, xla_acc = _jax_dense_update(case, name, adagrad=True)
    touched = np.unique(case["v"])
    # the row sums as the port forms them (JAX's, bit for bit), then each order's accumulators
    s = ordered_grad_update_(torch.zeros_like(cw0), None, g, perm, grouped, -1.0).float()[touched]
    acc0 = torch.from_numpy(case["acc0"])
    column = acc0.clone()
    ordered_grad_update_(cw0.clone(), column, g, perm, grouped, case["slr"], case["eps"])
    mean = acc0.clone()
    mean[touched] = acc0[touched] + torch.mean(s * s, dim=1)
    reading = {}
    for order, acc in (("column", column.numpy()), ("torch.mean", mean.numpy())):
        # XLA's update from this order's accumulators: the epilogue is the same on both sides
        a = jnp.asarray(acc)[jnp.asarray(touched)]
        u = jnp.asarray(s.numpy()) / (jnp.sqrt(a) + case["eps"])[:, None]
        rows = np.asarray((jnp.asarray(cw0.float().numpy()[touched]) - case["slr"] * u).astype(jnp.dtype(name))
                          .astype(jnp.float32))
        np.testing.assert_allclose(acc, xla_acc, rtol=1e-6)
        assert _within_xla_update(rows, xla_rows[touched], cw0.float().numpy()[touched], name).all()
        reading[order] = (int((acc[touched] != xla_acc[touched]).sum()), int((rows != xla_rows[touched]).sum()))
    if case["cw0"].shape[1] <= 32:
        assert reading["column"] == (0, 0)
    print(f"\n{shape} {name}: of {touched.size} rows, accumulators and row elements that differ from XLA's "
          f"jnp.mean update: {reading}")
