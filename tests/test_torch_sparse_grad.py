"""The sparse-gradient branch of the window step, and the choice between the
update branches, in the port against the JAX package.

JAX's ``_scan_window`` takes the plan branch when the host ships sort plans
(``ship_sort_perm``), else the sparse branch when ``accum is None and
(use_sparse_embed_grad or device_rows > 4 * L) and not sr``, else the dense
branch. Its sparse branch computes ``cw.at[v].add((-slr * g).astype(cw.dtype))``,
which XLA's CPU scatter adds in the rows' dtype in stream order, one rounding
per addend: the port's ordered scatter (``ops/ordered_scatter.py``) is
bit-equal to it for f32, bf16, float8_e4m3fn and float8_e5m2 rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jax_trainer_mod
import torch_parity as tp
from cachedembedding_tpu_torch.ops.binned_scatter import sort_plan_np
from cachedembedding_tpu_torch.ops.ordered_scatter import (
    occurrence_rank,
    ordered_scatter_add_,
    ordered_scatter_add_plain,
)
from cachedembedding_tpu_torch.ops.rounding import astype_storage
from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

ROW_DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


def _port_scatter(cw0: np.ndarray, g: np.ndarray, v: np.ndarray, slr: float, name: str) -> np.ndarray:
    dt = getattr(torch, name)
    cw = astype_storage(torch.from_numpy(cw0.copy()), dt)  # updated in place
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(v, cw0.shape[0]))
    return ordered_scatter_add_(cw, astype_storage(torch.from_numpy(g), dt), perm, grouped, slr).float().numpy()


def _jax_scatter(cw0: np.ndarray, g: np.ndarray, v: np.ndarray, slr: float, name: str) -> np.ndarray:
    """The JAX trainer's sparse-branch update, on rows and grads of ``name``."""
    dt = jnp.dtype(name)
    cw, gj = jnp.asarray(cw0).astype(dt), jnp.asarray(g).astype(dt)
    out = cw.at[jnp.asarray(v)].add((-slr * gj.astype(jnp.float32)).astype(dt), mode="promise_in_bounds")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("name", ROW_DTYPES)
def test_ordered_scatter_is_bit_equal_to_jax_scatter(name):
    """Skewed ids (a Zipf stream, rows with hundreds of addends) and grads
    large enough that the adds round: bit-equal to XLA's scatter, NaN and
    inf included."""
    rng = np.random.default_rng(3)
    C, D, L = 64, 8, 4000
    cw0 = rng.standard_normal((C, D)).astype(np.float32)
    g = (rng.standard_normal((L, D)) * 0.3).astype(np.float32)
    g[:4] *= 1e5  # past fp8's range: e4m3fn NaN, e5m2 inf, as JAX casts
    v = (rng.zipf(1.5, L) % C).astype(np.int32)
    got = _port_scatter(cw0, g, v, 0.37, name)
    want = _jax_scatter(cw0, g, v, 0.37, name)
    np.testing.assert_array_equal(got, want)


def test_1000_addends_of_one_into_bf16_give_256():
    """The case that shows the addends are summed in bf16: past 256 a bf16
    step is 2, and 256 + 1 rounds back to 256 (f32 sums would give 1000)."""
    v = np.zeros(1000, np.int32)
    g = np.full((1000, 1), -1.0, np.float32)  # -slr * g = +1 at slr = 1
    cw0 = np.zeros((2, 1), np.float32)
    got = _port_scatter(cw0, g, v, 1.0, "bfloat16")
    want = _jax_scatter(cw0, g, v, 1.0, "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 256.0 and got[1, 0] == 0.0
    x = jnp.zeros(2, jnp.bfloat16).at[jnp.zeros(1000, jnp.int32)].add(jnp.ones(1000, jnp.bfloat16))
    assert float(x[0]) == 256.0


def test_plain_version_applies_addends_in_stream_order():
    """The plain version (k-th contributor of every row in one write) equals
    a loop over the stream, one rounded add at a time; the sorted plan's
    occurrence rank counts each row's contributors from 0."""
    rng = np.random.default_rng(4)
    C, D, L, slr = 9, 3, 200, 0.75
    dt = torch.bfloat16
    v = rng.integers(0, C, L).astype(np.int32)
    cw0 = astype_storage(torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)), dt)
    g = astype_storage(torch.from_numpy(rng.standard_normal((L, D)).astype(np.float32)), dt)
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(v, C))
    got = ordered_scatter_add_plain(cw0.clone(), g, perm, grouped, slr)
    want = cw0.clone()
    for i in range(L):
        a = astype_storage(-slr * g[i].float(), dt)
        want[v[i]] = astype_storage(want[v[i]].float() + a.float(), dt)
    assert torch.equal(got, want)
    rank = occurrence_rank(grouped)
    counts = np.bincount(v, minlength=C)
    assert int(rank.max()) == counts.max() - 1 and int((rank == 0).sum()) == int((counts > 0).sum())


def test_wrapper_refuses_mismatched_grads():
    cw = torch.zeros((4, 2), dtype=torch.bfloat16)
    perm, grouped, _ = (torch.from_numpy(a) for a in sort_plan_np(np.array([1, 2], np.int32), 4))
    with pytest.raises(ValueError, match="rows' dtype"):
        ordered_scatter_add_(cw, torch.zeros((2, 2)), perm, grouped, 1.0)


class _Chosen(Exception):
    pass


def _jax_branch(monkeypatch, **kw) -> str:
    """The branch the JAX trainer takes for its first window: its window
    program is replaced by a recorder that stops the run."""
    seen = []

    def packed(*a, layout, sparse_grad, **k):
        seen.append("plan" if len(layout) > 10 and layout[10] else "sparse" if sparse_grad else "dense")
        raise _Chosen

    def step(*a, sparse_grad, **k):
        seen.append("sparse" if sparse_grad else "dense")
        raise _Chosen

    monkeypatch.setattr(jax_trainer_mod, "_train_window_packed", packed)
    monkeypatch.setattr(jax_trainer_mod, "_train_window_step", step)
    train = tp.data(False, 4, 7)
    tr = jax_trainer_mod.CachedDLRMTrainer(tp.config(False, **kw), id_freq_map=train.id_freq_map())
    with pytest.raises(_Chosen):
        tr.train(train, num_iters=4)
    return seen[0]


def _port_branch(**kw) -> str:
    train = tp.data(True, 4, 7)
    tr = CachedDLRMTrainer(tp.config(True, **kw), id_freq_map=train.id_freq_map(), device="cpu")
    branch = tr.branch_of(tr._begin_window(list(train)))
    tr.close()
    return branch


# device rows against 4 L = 4,096 (batch 256, 4 features): 2,785 at cache
# ratio 0.1, 12,525 at 0.5
@pytest.mark.parametrize("ship", [True, False], ids=["plan", "no_plan"])
@pytest.mark.parametrize("force", [False, True], ids=["auto", "use_sparse_embed_grad"])
@pytest.mark.parametrize("ratio", [0.1, 0.5], ids=["rows_below_4L", "rows_above_4L"])
@pytest.mark.parametrize("sr,opt", [("off", "sgd"), ("on", "sgd"), ("off", "rowwise_adagrad")],
                         ids=["sgd", "sgd_rounding_on", "adagrad"])
def test_branch_choice_matches_jax(ship, force, ratio, sr, opt, monkeypatch):
    kw = dict(cache_ratio=ratio, ship_sort_perm=ship, use_sparse_embed_grad=force, stochastic_rounding=sr,
              embedding_optimizer=opt)
    assert _port_branch(**kw) == _jax_branch(monkeypatch, **kw)


@pytest.mark.parametrize("kw", [
    dict(cache_ratio=0.5, ship_sort_perm=False),
    dict(cache_ratio=0.1, ship_sort_perm=False, use_sparse_embed_grad=True),
], ids=["rows_above_4L", "use_sparse_embed_grad"])
def test_sparse_branch_trainer_matches_jax_on_bf16_rows(kw, monkeypatch):
    """bf16 rows, f32 compute, the sparse branch in both packages: counts
    equal; losses and scores within rtol 1e-5 and AUROC within 1e-5 (the
    dense towers' f32 GEMMs sum in another order); at most 0.1% of the
    flushed row elements differ, each by one bf16 step (an f32 GEMM
    difference can flip a grad's bf16 rounding). Summing the addends in f32
    once per row, as Kernel 2 does, moves 3.6% of them, by up to 135 steps."""
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5)
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= 1e-5
    steps = tp.storage_steps(got["rows"], ref["rows"], torch.bfloat16)
    assert (steps > 0).mean() <= 1e-3 and steps.max() <= 1


def test_sparse_branch_on_f32_rows_is_kernel_2(monkeypatch):
    """f32 rows on the sparse branch: the port runs Kernel 2 (f32 sums, one
    rounding), JAX adds each addend in f32 in stream order; losses within
    rtol 1e-5 and flushed rows within 1e-5."""
    kw = dict(cache_ratio=0.5, ship_sort_perm=False, cache_dtype="float32")
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["rows"], ref["rows"], rtol=0, atol=1e-5)
