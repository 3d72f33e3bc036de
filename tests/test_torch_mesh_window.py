"""The port's column-wise mesh, continued (see ``test_torch_mesh.py``): the
rest of ``tests/test_mesh_window.py``'s cases against JAX's mesh of two
devices (int8 dense inputs, fp8 rows with stochastic rounding on and off,
the gather-scatter fused op, the mixed resident split), the device planner
on a mesh (JAX trains it there, and so does the port), a mesh of one rank
bit for bit against one card on both SGD branches, the checkpoint round trip
between two ranks and one card, and each rank's int8/int4 admit payload
against the full row's quantization.

Tolerances: bf16 rows on the dense branch as in ``test_torch_mesh.py``
(losses rtol 2e-2, AUROC 2e-2); float8_e4m3fn rows with JAX's rounding
uniforms given to the ranks, those of ``test_torch_trainer.py``'s fp8 slice
with shared uniforms in f32 compute (losses rtol 1e-4, AUROC 1e-4); the
port's mesh against its one card, JAX's 2e-4."""

import numpy as np
import pytest
import torch

import torch_dist as td
import torch_parity as tp
from test_torch_mesh import check_against_jax, jax_case

CASES = {
    "int8_dense": dict(batch=256, n=6, kw=dict(dense_input_dtype="int8")),
    "gather_scatter": dict(batch=256, n=6, kw=dict(fused_op="gather_scatter")),
    "resident_split": dict(batch=256, n=6, tables=[700, 300, 50, 20], cache_kw=dict(resident_threshold=100)),
    "device_planner": dict(batch=256, n=6, cache_kw=dict(planner="device")),
    "fp8_sr_off": dict(batch=256, n=8, eval_n=0, cache_kw=dict(cache_dtype="float8_e4m3fn",
                                                               stochastic_rounding="off")),
}
SINGLE = {"dense": dict(batch=256, n=6), "sparse": dict(batch=64, n=6),
          "fp8_sr": dict(batch=256, n=6, cache_kw=dict(cache_dtype="float8_e4m3fn", stochastic_rounding="on"))}
SR_STEPS = 8
_SEED_MUL, _M32 = 0x9E3779B9, 0xFFFFFFFF


def sr_case(shape) -> dict:
    """fp8 rows with stochastic rounding on, each step's rounding uniforms
    JAX's for its seed (the (C, D/w) shard's shape, as JAX draws them inside
    ``shard_map``)."""
    seeds = [((k - k % 2) * _SEED_MUL + k % 2) & _M32 for k in range(SR_STEPS)]  # windows of 2 steps
    uniforms = {s: tp.jax_uniform(s, shape).numpy() for s in seeds}
    return dict(batch=256, n=SR_STEPS, eval_n=0, uniforms=uniforms,
                cache_kw=dict(cache_dtype="float8_e4m3fn", stochastic_rounding="on"))


PAYLOAD_ROWS = np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The cases on one group of two ranks (and each rank's admit payloads),
    the SGD branches on a mesh of one rank, and the one-card runs."""
    root = tmp_path_factory.mktemp("mesh_window")
    one_card = {name: td.train_case(None, case) for name, case in CASES.items()}
    rows = int(0.9 * sum(td.TABLES))  # the cache's slots: its shard is (rows, 8) on each of two ranks
    cases = dict(CASES, fp8_sr_on=sr_case((rows, 8)))
    # a checkpoint of one card for the ranks to load, and one of the ranks for one card
    one_ckpt = root / "one_card_ckpt"
    ck = dict(batch=256, n=4, checkpoint=str(one_ckpt))
    one_card["checkpoint"] = td.train_case(None, ck)
    cases["checkpoint"] = dict(batch=256, n=6, checkpoint=str(root / "ranks_ckpt"), load=str(one_ckpt))
    cases["checkpoint_virtual"] = dict(batch=256, n=6, checkpoint=str(root / "ranks_virtual"),
                                       cache_kw=dict(weight_init="virtual", cache_ratio=0.3))
    cases["payloads"] = dict(payload_rows=PAYLOAD_ROWS)
    ranks = td.spawn("mesh_window_cases", 2, root / "two", cases)
    single = td.spawn("train_cases", 1, root / "one", SINGLE)[0]
    return dict(ranks=ranks, one_card=one_card, single=single, root=root, rows=rows)


@pytest.mark.parametrize("name", ["int8_dense", "gather_scatter", "resident_split", "device_planner"])
def test_mesh_matches_jax_mesh(port, name):
    """Two ranks against JAX's mesh of two devices and against the port's
    one card; every rank planned every window alike."""
    ranks = [r[name] for r in port["ranks"]]
    assert all(r["plan_digests"] == ranks[0]["plan_digests"] for r in ranks) and ranks[0]["plan_digests"]
    check_against_jax(ranks[0], jax_case(CASES[name], 2), sparse=False)
    one = port["one_card"][name]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=2e-4)
    np.testing.assert_allclose(ranks[0]["ev"]["auroc"], one["ev"]["auroc"], atol=2e-3)


def test_fp8_stochastic_rounding_active_and_matches_jax(port):
    """float8_e4m3fn rows on the mesh: rounding on trains with finite losses
    and differs from rounding off (JAX's own check); with JAX's uniforms
    both match JAX's mesh, and rounding off matches the one card."""
    on = port["ranks"][0]["fp8_sr_on"]
    off = port["ranks"][0]["fp8_sr_off"]
    assert on["sr"] and not off["sr"]
    assert np.isfinite(on["losses"]).all() and np.isfinite(off["losses"]).all()
    assert not np.array_equal(on["losses"], off["losses"]), "stochastic rounding had no effect on the mesh"
    want_on = jax_case(dict(batch=256, n=SR_STEPS, eval_n=0,
                            cache_kw=dict(cache_dtype="float8_e4m3fn", stochastic_rounding="on")), 2)
    want_off = jax_case(CASES["fp8_sr_off"], 2)
    assert want_on["sr"] and not want_off["sr"]
    np.testing.assert_allclose(on["losses"], want_on["losses"], rtol=1e-4)
    np.testing.assert_allclose(off["losses"], want_off["losses"], rtol=1e-4)
    np.testing.assert_allclose(off["losses"], port["one_card"]["fp8_sr_off"]["losses"], rtol=2e-4)


@pytest.mark.parametrize("branch", list(SINGLE))
def test_one_rank_equals_one_card_bit_for_bit(port, branch):
    """A mesh of one rank (its collectives identities, its loss factor 1.0)
    gives the one-card trainer's losses, evaluation and flushed rows bit for
    bit on SGD's dense (batch 256) and sparse (batch 64) branches; and on
    float8_e4m3fn rows with stochastic rounding, whose route is the one
    card's dense one at one rank (Kernel 3's f32 grad, then Kernel 4's fused
    entry, its Philox counting the same elements of the whole row)."""
    got = port["single"][branch]
    want = td.train_case(None, SINGLE[branch])
    np.testing.assert_array_equal(got["losses"], want["losses"])
    assert got["ev"] == want["ev"] and got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["rows"], want["rows"])


def test_checkpoint_round_trip_between_ranks_and_one_card(port):
    """Two ranks write one checkpoint (rank 0 the full-width table file, each
    rank its columns); one card loads it, holds the ranks' flushed rows, and
    scores as they did. The ranks load a one-card checkpoint, each its
    columns of the table."""
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer
    from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint

    ranks = [r["checkpoint"] for r in port["ranks"]]
    cfg = td.mesh_config(256)
    tr = CachedDLRMTrainer(cfg, device="cpu")
    assert load_checkpoint(str(port["root"] / "ranks_ckpt"), tr) == 6
    train_rows = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in td.mesh_data(td.TABLES, cfg, 6)]))
    np.testing.assert_array_equal(tr.embed.host_table.array[train_rows], td.join_columns(ranks))
    ev = tr.evaluate(td.mesh_data(td.TABLES, cfg, 2, seed=99))
    tr.close()
    np.testing.assert_allclose(ev["auroc"], ranks[0]["ev"]["auroc"], atol=1e-6)
    # the other way: each rank loaded its columns of the one card's table
    one = port["one_card"]["checkpoint"]
    full = td.join_columns(ranks, "loaded_table")
    arr = np.load(port["root"] / "one_card_ckpt" / "host_table.npy")
    np.testing.assert_array_equal(full, arr)
    assert ranks[0]["loaded_ev"] == ranks[1]["loaded_ev"] and one["losses"].shape == (4,)
    # a virtual host table: rank 0 writes the written rows, every rank's columns gathered
    virt = [r["checkpoint_virtual"] for r in port["ranks"]]
    cfg = td.mesh_config(256, cache_kw=dict(weight_init="virtual", cache_ratio=0.3))
    tr = CachedDLRMTrainer(cfg, device="cpu")
    load_checkpoint(str(port["root"] / "ranks_virtual"), tr)
    assert tr.embed.host_table.overlay_rows > 0, "this run must write rows back"
    train_rows = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in td.mesh_data(td.TABLES, cfg, 6)]))
    np.testing.assert_array_equal(tr.embed.host_table.gather(train_rows.astype(np.int64)), td.join_columns(virt))
    tr.close()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_rank_payloads_are_the_full_rows_quantization(port, mode):
    """Each rank's fetched-admit payload, dequantized, equals its columns of
    the full row quantized with the full row's scale (JAX's payload, sliced
    on the device), bit for bit."""
    from cachedembedding_tpu_torch.cache.manager import _quant_rows_host, _quant_rows_host4
    from cachedembedding_tpu_torch.cache.state import dequant_rows_q4

    q, scales = (_quant_rows_host if mode == "int8" else _quant_rows_host4)(PAYLOAD_ROWS)
    if mode == "int8":
        want = q.astype(np.float32) * scales[:, None]
    else:
        want = dequant_rows_q4(torch.from_numpy(q), torch.from_numpy(scales), 16).numpy()
    got = np.concatenate([r["payloads"][mode] for r in port["ranks"]], axis=1)
    np.testing.assert_array_equal(got, want)
