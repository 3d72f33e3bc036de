"""The column-wise mesh of the port (``parallel/column.py``,
``train/mesh_window.py``) on two spawned gloo ranks, against the JAX
package's mesh of two devices, on the cases of ``tests/test_mesh_window.py``
(this file: the update branches and the evictions; ``test_torch_mesh_window.py``
the rest), and against the port's own one-card trainer.

Tolerances. Against JAX's mesh: those of ``tests/test_torch_trainer.py`` and
``tests/test_torch_cli.py`` for the rows' dtype. bf16 rows on the dense
branch: losses rtol 2e-2, AUROC 2e-2 (Kernel 2 sums the same bf16 grads in f32
in another order than XLA, which moves a row's rounding by one ulp); the
sparse branch adds the same addends in the same order: losses rtol 1e-4,
AUROC 1e-4; f32 accumulators under row-wise Adagrad: rtol 1e-4. Against the
port's one card: JAX's own 2e-4 between its mesh and its single chip."""

import numpy as np
import pytest

import torch_dist as td
from cachedembedding_tpu_torch.train.trainer import update_branch

CASES = {
    # test_mesh_window_matches_single_chip: batch 64 takes the sparse branch, 256 the dense one
    "single_chip_64": dict(batch=64, n=6),
    "single_chip_256": dict(batch=256, n=6),
    "adagrad": dict(batch=256, n=6, kw=dict(embedding_optimizer="rowwise_adagrad")),
    # test_mesh_window_evictions: admits (synthesized and fetched) and writebacks
    "evictions_float32": dict(batch=128, n=8, eval_n=0, tables=[2000, 1000],
                              cache_kw=dict(cache_ratio=0.25, transfer_dtype="float32")),
    "evictions_int8": dict(batch=128, n=8, eval_n=0, tables=[2000, 1000],
                           cache_kw=dict(cache_ratio=0.25, transfer_dtype="int8")),
    "evictions_int4": dict(batch=128, n=8, eval_n=0, tables=[2000, 1000],
                           cache_kw=dict(cache_ratio=0.25, transfer_dtype="int4")),
}
BRANCH = {"single_chip_64": "sparse", "single_chip_256": "dense", "adagrad": "dense",
          "evictions_float32": "dense", "evictions_int8": "dense", "evictions_int4": "dense"}


def jax_case(case: dict, world):
    """``case`` in the JAX package, on a mesh of ``world`` devices (one chip
    where None)."""
    from cachedembedding_tpu.config import CacheConfig, DLRMConfig
    from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu.parallel.mesh import make_mesh
    from cachedembedding_tpu.train.trainer import CachedDLRMTrainer

    tables = case.get("tables", td.TABLES)
    ckw = dict(cache_ratio=0.9, warmup_ratio=0.7, buffer_size=0, prefetch_num=2, use_lfu_eviction=True,
               use_freq=False, planner="host")
    ckw.update(case.get("cache_kw", {}))
    cfg = DLRMConfig(num_embeddings_per_feature=list(tables), embedding_dim=16, dense_in_features=4,
                     dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(32, 16, 1),
                     batch_size=case["batch"], learning_rate=0.5, cache=CacheConfig(**ckw), **case.get("kw", {}))
    data = SyntheticLongTailDataset(tables, cfg.batch_size, num_batches=case["n"], dense_in_features=4, seed=21)
    tr = CachedDLRMTrainer(cfg, mesh=make_mesh(world) if world else None)
    rep = tr.train(data, num_iters=case["n"])
    ev = None
    if case.get("eval_n", 2):
        ev = tr.evaluate(SyntheticLongTailDataset(tables, cfg.batch_size, num_batches=case.get("eval_n", 2),
                                                  dense_in_features=4, seed=99))
    return dict(losses=np.asarray(rep.losses), ev=ev, sr=tr._sr)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on one group of two ranks, and on one card."""
    ranks = td.spawn("train_cases", 2, tmp_path_factory.mktemp("mesh2"), CASES)
    return {name: ([r[name] for r in ranks], td.train_case(None, case)) for name, case in CASES.items()}


def check_against_jax(got: dict, want: dict, sparse: bool) -> None:
    rtol = 1e-4 if sparse else 2e-2
    assert np.isfinite(got["losses"]).all() and got["losses"].shape == want["losses"].shape
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    if want["ev"] is not None:
        assert got["ev"]["count"] == want["ev"]["count"]
        assert abs(got["ev"]["auroc"] - want["ev"]["auroc"]) <= rtol


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_mesh(port, name):
    """Two ranks against JAX's mesh of two devices; both ranks planned every
    window alike and report the same losses and evaluation."""
    ranks, _ = port[name]
    want = jax_case(CASES[name], 2)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["plan_digests"] == r0["plan_digests"] and len(r0["plan_digests"]) > 0
        np.testing.assert_array_equal(r["losses"], r0["losses"])
        assert r["ev"] == r0["ev"] and r["stats"] == r0["stats"]
    case = CASES[name]
    L = case["batch"] * 2
    adagrad = "kw" in case
    assert update_branch(td.mesh_config(case["batch"], case.get("tables", td.TABLES), case.get("cache_kw"),
                                        **case.get("kw", {})),
                         adagrad, r0["device_rows"], L, plans_shipped=False) == BRANCH[name]
    check_against_jax(r0, want, BRANCH[name] == "sparse")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_one_card(port, name):
    """Two ranks against the port's one-card trainer on the same stream
    (JAX's mesh-against-single-chip tolerances: losses rtol 2e-4, AUROC
    2e-3), the cache counts equal, and the flushed bf16 rows, the ranks'
    columns side by side: on SGD within one ulp (the dense grads' f32 sums
    differ in order); under row-wise Adagrad, whose mean square the mesh
    sums over its ranks' columns where one card takes Kernel 2's epilogue,
    at least 99.5% of the elements equal and each within 4 ulps."""
    ranks, one = port[name]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=2e-4)
    assert ranks[0]["stats"] == one["stats"]
    if one["ev"] is not None:
        np.testing.assert_allclose(ranks[0]["ev"]["auroc"], one["ev"]["auroc"], atol=2e-3)
    ulps = bf16_ulps(td.join_columns(ranks), one["rows"])
    if name == "adagrad":
        assert (ulps > 0).mean() <= 5e-3 and ulps.max() <= 4, (int((ulps > 0).sum()), ulps.max())
    else:
        assert ulps.max() <= 1, ulps.max()


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of b's bf16 ulp."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
    return np.abs(a - b) / ulp


def test_four_ranks_match_jax_mesh(tmp_path):
    """The int8-payload evictions on four ranks (four columns each) against
    JAX's mesh of four devices, with a cache small enough (10%) and a run
    long enough (12 steps) that trained rows are evicted and fetched again:
    each fetched row is quantized with its largest |x| over all four ranks'
    columns, as JAX quantizes the whole row."""
    case = dict(CASES["evictions_int8"], n=12, cache_kw=dict(cache_ratio=0.1, transfer_dtype="int8"))
    ranks = td.spawn("train_case", 4, tmp_path, case)
    assert all(r["plan_digests"] == ranks[0]["plan_digests"] for r in ranks)
    check_against_jax(ranks[0], jax_case(case, 4), sparse=False)
    prepare_calls, hits, misses, writebacks = ranks[0]["stats"]
    assert sum(writebacks) > 0 and ranks[0]["fetched_rows"] > 0, "trained rows must come back"
