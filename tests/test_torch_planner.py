"""The port's sharding planner (``parallel/planner.py``) against the JAX
package's on the same table specs and topologies: the printed plan
(``Plan.pretty()``) string-equal and every ``TablePlan`` equal, on the cases
of ``tests/test_planner.py`` and on a hypothesis sweep of table sizes, device
counts and budgets, with the topology's values passed to both (the port's
defaults describe an H100 80GB, JAX's a TPU v5e). Exact: the planner is
integer arithmetic and the same numpy calls."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import cachedembedding_tpu.parallel.planner as jp
import cachedembedding_tpu_torch.parallel.planner as pp

GIB = 1 << 30
JAX_TOPOLOGY = dict(hbm_bytes_per_device=16 * GIB, host_dram_bytes=256 * GIB, hbm_budget_fraction=0.6)


def _plans(specs, topo_kw, **plan_kw):
    """Both packages' plans of ``specs`` (name, rows, dim[, hot]) on the same
    topology, or both packages' ValueError messages."""
    out = []
    for mod in (jp, pp):
        topo = mod.Topology(**{**JAX_TOPOLOGY, **topo_kw})
        sp = [mod.TableSpec(n, r, d, hot_fraction=h) for n, r, d, h in specs]
        kw = {k: (getattr(mod, type(v).__name__)[v.name] if hasattr(v, "name") else v) for k, v in plan_kw.items()}
        try:
            out.append(mod.EmbeddingShardingPlanner(topo).plan(sp, batch_size=1024, **kw))
        except ValueError as e:
            out.append(str(e))
    return out


def _table_plan(tp) -> tuple:
    s = tp.spec
    return (s.name, s.num_embeddings, s.embedding_dim, s.pooling_factor, s.weight_dtype_bytes, s.hot_fraction,
            tp.sharding.value, tp.kernel.value, list(tp.devices), tp.cache_ratio, tp.hbm_bytes_per_device,
            tp.host_bytes, tp.comm_bytes_per_sample)


def assert_same_plan(want, got) -> None:
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    assert got.pretty() == want.pretty()
    assert [_table_plan(t) for t in got.tables] == [_table_plan(t) for t in want.tables]
    np.testing.assert_array_equal(got.hbm_per_device(), want.hbm_per_device())
    assert got.host_bytes_total() == want.host_bytes_total()


# the cases of tests/test_planner.py (its six planner tests; the row-wise lookups come with the row-wise layout)
CASES = {
    "replicate_and_cache": ([("tiny", 1000, 128, None), ("mid", 5_000_000, 128, None),
                             ("huge", 400_000_000, 128, None)], dict(num_devices=4), {}),
    "balance_table_wise": ([(f"t{i}", 2_000_000, 128, None) for i in range(8)], dict(num_devices=4),
                           dict(force_sharding=jp.ShardingType.TABLE_WISE)),
    "host_group_row": ([("t", 40_000_000, 128, None)], dict(num_devices=8, devices_per_host=4),
                       dict(force_sharding=jp.ShardingType.TABLE_ROW_WISE)),
    "host_group_column": ([("t", 40_000_000, 128, None)], dict(num_devices=8, devices_per_host=4),
                          dict(force_sharding=jp.ShardingType.TABLE_COLUMN_WISE)),
    "host_groups_differ": ([("a", 40_000_000, 128, None), ("b", 40_000_000, 128, None)],
                           dict(num_devices=8, devices_per_host=4),
                           dict(force_sharding=jp.ShardingType.TABLE_ROW_WISE)),
    "auto_prefers_host_group": ([("grp", 40_000_000, 128, None), ("huge", 800_000_000, 128, None)],
                                dict(num_devices=8, devices_per_host=4, host_dram_bytes=512 * GIB), {}),
    "impossible": ([("huge", 1_000_000_000, 128, None)],
                   dict(num_devices=1, hbm_bytes_per_device=1 * GIB, host_dram_bytes=1 * GIB), {}),
    "forced_cached": ([("a", 3_000_000, 64, 0.05), ("b", 500, 64, None)], dict(num_devices=2),
                      dict(force_kernel=jp.Kernel.CACHED)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_jax(name):
    specs, topo, kw = CASES[name]
    want, got = _plans(specs, topo, **kw)
    assert_same_plan(want, got)
    if name == "impossible":
        assert got.startswith("plan does not fit")


def test_specs_from_sizes_match_jax():
    """The per-table hot fractions from an id-frequency map."""
    freq = np.concatenate([np.r_[np.full(5, 1000), np.ones(95)], np.ones(50)]).astype(np.int64)
    for weight_bytes in (2, 4):
        a = jp.specs_from_sizes([100, 50], 16, id_freq_map=freq, weight_dtype_bytes=weight_bytes)
        b = pp.specs_from_sizes([100, 50], 16, id_freq_map=freq, weight_dtype_bytes=weight_bytes)
        assert [vars(x) for x in a] == [vars(x) for x in b]
        assert b[0].hot_fraction < 0.3 and b[1].hot_fraction > 0.9


def test_topology_defaults_describe_an_h100():
    """The port's defaults: 80 GiB of device memory, the budget at JAX's 0.6
    of it, an NVLink figure for the links; JAX's describe a TPU v5e."""
    t = pp.Topology()
    assert t.hbm_bytes_per_device == 80 * GIB and t.hbm_budget == int(80 * GIB * 0.6)
    assert jp.Topology().hbm_bytes_per_device == 16 * GIB
    assert t.ici_bytes_per_s == 450e9 and 0 < t.host_link_bytes_per_s < 128e9


@settings(max_examples=60, deadline=None)
@given(
    sizes=st.lists(st.integers(1, 600_000_000), min_size=1, max_size=8),
    dim=st.sampled_from([16, 64, 96, 128]),
    ndev=st.sampled_from([1, 2, 3, 4, 8]),
    per_host=st.sampled_from([0, 1, 2, 4]),
    hbm_gb=st.sampled_from([1, 16, 80]),
    host_gb=st.sampled_from([64, 256, 2048]),
    hot=st.lists(st.one_of(st.none(), st.floats(0.0, 1.0)), min_size=8, max_size=8),
    forced=st.sampled_from([None, "TABLE_WISE", "COLUMN_WISE", "ROW_WISE", "CACHED"]),
)
def test_plan_sweep_matches_jax(sizes, dim, ndev, per_host, hbm_gb, host_gb, hot, forced):
    specs = [(f"t{i}", n, dim, hot[i]) for i, n in enumerate(sizes)]
    topo = dict(num_devices=ndev, devices_per_host=per_host, hbm_bytes_per_device=hbm_gb * GIB,
                host_dram_bytes=host_gb * GIB)
    kw = {}
    if forced == "CACHED":
        kw["force_kernel"] = jp.Kernel.CACHED
    elif forced:
        kw["force_sharding"] = jp.ShardingType[forced]
    want, got = _plans(specs, topo, **kw)
    assert_same_plan(want, got)
