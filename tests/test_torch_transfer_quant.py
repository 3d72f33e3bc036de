"""int8 / int4 admit payloads (``transfer_dtype``) in the port against the
JAX package, on the CPU, on inputs made from a seed with numpy.

Tolerances: the host quantizers and the device dequantizing scatters are
bit-equal (rows compared through their bit patterns, fp8 rows included). The
cached trainer with int8 or int4 transfers and evictions is held to JAX's at
the tolerances ``tests/test_torch_trainer.py`` uses for the same branch (bf16
rows on the plan branch: counts equal, losses rtol 1e-4, flushed rows within
one bf16 step on at most 0.5% of the elements; f32 rows: losses rtol 1e-5,
rows within 1e-5). Writebacks land as bf16 values in every non-f32 mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from cachedembedding_tpu.cache import manager as jax_manager
from cachedembedding_tpu.cache import state as jax_state
from cachedembedding_tpu_torch.cache import manager, state
from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag
from cachedembedding_tpu_torch.train import dlrm_main as port_main

ROW_DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
_BITS = {4: np.uint32, 2: np.uint16, 1: np.uint8}


def _rows(seed=0, n=96, d=16):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((n, d)) * rng.uniform(0.01, 3, (n, 1))).astype(np.float32)
    rows[7] = 0.0  # the zero row: scale 1
    return rows


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_BITS[a.dtype.itemsize])


@pytest.mark.parametrize("bits", [8, 4])
def test_host_quantizers_match_jax(bits):
    rows = _rows(bits)
    got = (manager._quant_rows_host if bits == 8 else manager._quant_rows_host4)(rows)
    want = (jax_manager._quant_rows_host if bits == 8 else jax_manager._quant_rows_host4)(rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows_dtype", ROW_DTYPES)
def test_dequant_scatters_match_jax(rows_dtype, bits):
    """The admit scatter dequantizes to f32 (``q * scale`` rounded) and then
    casts to the rows' dtype, as JAX's does; slots land in a permuted order
    over a cache of other rows."""
    rows = _rows(10 + bits)
    C, D = 128, rows.shape[1]
    q, scales = (manager._quant_rows_host if bits == 8 else manager._quant_rows_host4)(rows)
    slots = np.random.default_rng(3).permutation(C)[: rows.shape[0]].astype(np.int64)
    base = np.random.default_rng(4).standard_normal((C, D)).astype(np.float32)
    jdt = jnp.dtype(rows_dtype)
    scatter = jax_state.scatter_admits_q8 if bits == 8 else jax_state.scatter_admits_q4
    want = np.asarray(scatter(jnp.asarray(base).astype(jdt), jnp.asarray(slots.astype(np.int32)), jnp.asarray(q),
                              jnp.asarray(scales)))
    from cachedembedding_tpu_torch.ops.rounding import astype_storage

    cw = astype_storage(torch.from_numpy(base), getattr(torch, rows_dtype))
    (state.scatter_admits_q8 if bits == 8 else state.scatter_admits_q4)(
        cw, torch.from_numpy(slots), torch.from_numpy(q), torch.from_numpy(scales))
    view = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[cw.element_size()]
    np.testing.assert_array_equal(cw.view(view).numpy(), _bits(want).astype(cw.view(view).numpy().dtype))


def test_gather_slots_q8_matches_jax():
    rows = _rows(5)
    slots = np.arange(rows.shape[0])[::-1].copy()
    q, s = state.gather_slots_q8(torch.from_numpy(rows), torch.from_numpy(slots))
    jq, js = jax_state.gather_slots_q8(jnp.asarray(rows), jnp.asarray(slots.astype(np.int32)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_bare_module_admits_and_writebacks(mode):
    """The bare module with a small cache: admitted rows equal
    dequant(quant(host row)) cast to the rows' dtype, and evicted rows come
    back to the host table as their bf16 values."""
    sizes = [300, 500]
    bag = CachedEmbeddingBag(sum(sizes), 16, cache_ratio=0.1, table_sizes=sizes, dtype=torch.float32,
                             weight_init="uniform", transfer_dtype=mode, device="cpu", device_init="off")
    host0 = bag.host_table.array.copy()
    rng = np.random.default_rng(0)
    ids = rng.choice(sum(sizes), 60, replace=False).astype(np.int32)
    slots = bag.prepare_ids(ids)
    quant = manager._quant_rows_host if mode == "int8" else manager._quant_rows_host4
    q, s = quant(host0[ids])
    want = (state.dequant_q8(torch.from_numpy(q), torch.from_numpy(s)) if mode == "int8"
            else state.dequant_rows_q4(torch.from_numpy(q), torch.from_numpy(s), 16))
    np.testing.assert_array_equal(bag.cache_weight[slots.long()].numpy(), want.numpy())
    with torch.no_grad():
        bag.cache_weight.add_(0.123456789)  # every cached row now holds an f32 value off the bf16 grid
    fresh = np.setdiff1d(np.arange(sum(sizes)), ids)[:60].astype(np.int32)
    bag.prepare_ids(fresh)  # evicts the first ids
    bag._drain_writebacks()
    evicted = np.setdiff1d(ids, bag._dir.resident()[1])
    assert evicted.size
    back = bag.host_table.array[evicted]
    np.testing.assert_array_equal(back, torch.from_numpy(back).to(torch.bfloat16).float().numpy())
    assert bag.stats.swap_out_bytes > 0
    bag.close()


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_trainer_with_quantized_transfers_matches_jax(mode, cache_dtype, monkeypatch):
    """A cached trainer with evictions (a 2.5% cache) and int8/int4 admit
    payloads against JAX's: the same counts, losses and evaluation, and the
    flushed host table within the plan branch's tolerance; the writebacks are
    bf16 in both."""
    kw = dict(transfer_dtype=mode, cache_dtype=cache_dtype, steps=24, cache_ratio=0.025)
    ref = tp.run(False, monkeypatch, **kw)
    got = tp.run(True, monkeypatch, **kw)
    assert got["stats"] == ref["stats"]
    assert sum(got["stats"]["num_write_back_history"]) > 0 and got["stats"]["swap_in_bytes"] > 0
    if cache_dtype == "float32":
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["rows"], ref["rows"], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        steps = tp.storage_steps(got["rows"], ref["rows"], torch.bfloat16)
        assert (steps > 0).mean() <= 5e-3 and steps.max() <= 1
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4, atol=1e-6)


def test_cli_accepts_quantized_transfers(tmp_path, capsys):
    """``--transfer_dtype int8|int4`` runs (no refusal) with the cached flags
    and learns on the CLI tests' files."""
    from test_torch_cli import small_argv, write_dataset

    d = write_dataset(tmp_path / "criteo_kaggle")
    for mode in ("int8", "int4"):
        port_main.main(small_argv(d, "--use_cache", "--cache_ratio", "0.8", "--transfer_dtype", mode,
                                  "--limit_train_batches", "8"))
        out = capsys.readouterr().out
        assert "val auroc=" in out or "auroc" in out
    args = port_main.parse_args(["--transfer_dtype", "int4"])
    assert port_main.build_config(args).cache.transfer_dtype == "int4"
