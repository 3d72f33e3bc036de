"""fp8 cache rows beyond the rounding slice, in the port against the JAX
package: float8_e4m3fn rows with stochastic rounding off on each update
branch, and float8_e5m2 rows with rounding on (``auto``) and off.

With rounding off, JAX's plan branch casts the grads to fp8 and runs its
fused binned SGD (the port: Kernel 2 on fp8 grads); its dense branch
upcasts the rows and sums f32 grads (Kernel 2 on f32 grads into fp8 rows);
its sparse branch adds fp8 addends one at a time (the ordered scatter). f32
compute throughout: the packages' f32 GEMMs sum in different orders, which
can flip an fp8 rounding now and then, so the flushed rows are compared in
steps of the storage dtype (at most 0.5% of the elements, one step each)
and the losses within rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from cachedembedding_tpu_torch.ops import rounding as port_rounding
from cachedembedding_tpu_torch.ops.rounding import astype_storage
from cachedembedding_tpu_torch.train.trainer import update_branch


def _compare(got, ref, dtype):
    assert got["stats"] == ref["stats"]
    assert np.isfinite(got["losses"]).all() and got["losses"].shape == (8,)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    assert abs(got["ev"]["auroc"] - ref["ev"]["auroc"]) <= 1e-3
    steps = tp.storage_steps(got["rows"], ref["rows"], dtype)
    assert (steps > 0).mean() <= 5e-3 and steps.max() <= 1, (int((steps > 0).sum()), int(steps.max()))


@pytest.mark.parametrize("ship,ratio,branch", [
    (True, 0.1, "plan"), (False, 0.1, "dense"), (False, 0.5, "sparse"),
], ids=["plan", "dense", "sparse"])
def test_e4m3_rounding_off_matches_jax(ship, ratio, branch, monkeypatch):
    kw = dict(cache_dtype="float8_e4m3fn", stochastic_rounding="off", ship_sort_perm=ship, cache_ratio=ratio)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    tr = got["trainer"]
    L = tp.BATCH * len(tp.TABLES)
    assert update_branch(tr.cfg, False, tr.embed.device_rows, L) == branch and not tr._sr
    _compare(got, ref, torch.float8_e4m3fn)


@pytest.mark.parametrize("sr", ["auto", "off"], ids=["rounding_on", "rounding_off"])
def test_e5m2_rows_match_jax(sr, monkeypatch):
    """float8_e5m2 rows, the plan branch: with rounding on (auto for fp8;
    Kernels 3 and 4, JAX's uniforms shared) and off (Kernel 2 on e5m2
    grads)."""
    if sr == "auto":
        monkeypatch.setattr(port_rounding, "philox_uniform", tp.jax_uniform)
    kw = dict(cache_dtype="float8_e5m2", stochastic_rounding=sr, cache_ratio=0.02)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert sum(got["stats"]["num_write_back_history"]) > 0, "this config must evict"
    assert got["trainer"]._sr == (sr == "auto")
    _compare(got, ref, torch.float8_e5m2)


def test_e5m2_storage_cast_matches_jnp():
    """``astype_storage`` to float8_e5m2 against ``jnp.astype`` on 2^24 f32
    bit patterns, one in every 256 over the whole range with random low
    bits (every exponent, both signs, ties, subnormals, overflow to inf):
    bit for bit except NaN inputs, which stay NaN."""
    rng = np.random.default_rng(0)
    bits = (np.arange(1 << 24, dtype=np.uint64) << np.uint64(8)) | rng.integers(0, 256, 1 << 24).astype(np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    got = astype_storage(torch.from_numpy(x), torch.float8_e5m2).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e5m2)).view(np.uint8)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(astype_storage(torch.from_numpy(x[nan]), torch.float8_e5m2).float().numpy()).all()
    # torch's own cast agrees past the range here, but the storage cast sets
    # those codes itself: +-inf from 61,440 on
    over = np.abs(x) >= 61440.0
    assert set(np.unique(got[over & ~nan])) == {0x7C, 0xFC}
