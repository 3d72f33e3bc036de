"""The headline bench (``cachedembedding_tpu_torch/bench.py``) against the
repo root's ``bench.py``: its configuration field for field at every scale,
its trainer against the JAX trainer on the same batches at ``--scale small``
(losses within rtol 2e-2, bf16 compute, as ``tests/test_torch_cli.py``
allows; hits, misses, writebacks and swap bytes equal), its one stdout line,
its segment selection, and its refusal to fall back to the CPU. The JAX
config is built here as ``bench.py:448-480`` builds it."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from cachedembedding_tpu.cache.manager import CacheStats as JaxCacheStats
from cachedembedding_tpu.config import CacheConfig as JaxCacheConfig
from cachedembedding_tpu.config import DLRMConfig as JaxDLRMConfig
from cachedembedding_tpu.data.synthetic import SyntheticLongTailDataset as JaxDataset
from cachedembedding_tpu.train.trainer import CachedDLRMTrainer as JaxTrainer
from cachedembedding_tpu_torch import bench
from cachedembedding_tpu_torch.cache.manager import CacheStats
from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

STATS = ("num_hits_history", "num_miss_history", "num_write_back_history", "swap_in_bytes", "swap_out_bytes",
         "synth_rows")
SMALL = ["--scale", "small", "--platform", "cpu", "--batch-size", "64", "--prefetch", "2"]


def _jax_config(args):
    """``bench.py:424-480`` with the JAX package's classes."""
    from cachedembedding_tpu.config import (
        AVAZU_NUM_DENSE,
        AVAZU_NUM_EMBEDDINGS_PER_FEATURE,
        CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE,
        CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
    )

    full_resident = False
    if args.scale == "kaggle":
        tables, dense_in, cache_ratio = CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE, 13, args.cache_ratio
    elif args.scale == "avazu":
        tables, dense_in, cache_ratio, full_resident = AVAZU_NUM_EMBEDDINGS_PER_FEATURE, AVAZU_NUM_DENSE, 1.0, True
    elif args.scale == "terabyte":
        tables, dense_in, cache_ratio = CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE, 13, args.cache_ratio
    else:
        tables, dense_in, cache_ratio = [100_000, 50_000, 20_000, 10_000] * 4, 13, max(args.cache_ratio, 0.25)
    return JaxDLRMConfig(
        num_embeddings_per_feature=tables, embedding_dim=128, dense_in_features=dense_in,
        batch_size=args.batch_size, learning_rate=1.0, compute_dtype="bfloat16",
        dense_input_dtype=args.dense_wire, use_sparse_embed_grad=args.sparse_grad,
        cache=JaxCacheConfig(
            cache_ratio=cache_ratio, warmup_ratio=0.7, prefetch_num=args.prefetch, buffer_size=0,
            use_lfu_eviction=False, use_pallas_lookup=bool(args.pallas), weight_init=args.weight_init,
            transfer_dtype="bfloat16", cache_dtype=args.cache_dtype, id_wire=args.id_wire,
            ship_sort_perm=args.ship_sort_perm, resident_threshold=0 if full_resident else args.resident_threshold,
        ),
    )


@pytest.mark.parametrize("scale,metric", [
    ("kaggle", "dlrm_kaggle_cached_train_throughput"), ("small", "dlrm_small_cached_train_throughput"),
    ("avazu", "dlrm_avazu_resident_train_throughput"), ("terabyte", "dlrm_terabyte_cached_train_throughput"),
])
def test_config_and_metric_match_bench_py(scale, metric):
    """Every scale: the metric name, the A100 baseline, and the config
    field for field (flags at their defaults and a few set)."""
    for extra in ([], ["--sparse-grad", "--ship-sort-perm", "--cache-dtype", "float8_e4m3fn", "--dense-wire", "int4",
                       "--id-wire", "ranktier", "--resident-threshold", "0", "--cache-ratio", "0.02", "--pallas"]):
        args = bench.parse_args(["--scale", scale] + extra)
        setup = bench.build_config(args)
        assert setup.metric == metric
        assert setup.full_resident == (scale == "avazu")
        assert setup.baseline == {"avazu": 111 * 16384, "terabyte": 42 * 16384}.get(scale, 819_200)
        assert dataclasses.asdict(setup.cfg) == dataclasses.asdict(_jax_config(args))


def _resident(cfg):
    """avazu's setup (bench.py:430-437 and 520-531) on small tables."""
    return dataclasses.replace(cfg, cache=dataclasses.replace(cfg.cache, cache_ratio=1.0, resident_threshold=0))


@pytest.mark.parametrize("case", ["resident_tables", "all_cached", "resident_bag"])
def test_bench_trainer_matches_jax(case):
    """The bench's trainer (``build_config`` and ``build_trainer``) against
    JAX's on the same seed-7 batches: two windows as a warmup, then a
    segment of two windows with fresh statistics and its writebacks
    drained, as the bench times it. At --scale small every table is
    resident at the default threshold; at 0 every table is cached at 25%;
    "resident_bag" is avazu's fully resident bf16 table on the small tables.
    No segment churns at this size: ``tests/test_torch_trainer.py``'s
    ``eviction_churn`` holds the writebacks against JAX."""
    args = bench.parse_args(SMALL + ["--resident-threshold", "0" if case == "all_cached" else "500000"])
    setup = bench.build_config(args)
    jax_cfg = _jax_config(args)
    if case == "resident_bag":
        setup = setup._replace(cfg=_resident(setup.cfg), full_resident=True)
        jax_cfg = _resident(jax_cfg)
    n, tables = 8, setup.cfg.num_embeddings_per_feature
    port_data = SyntheticLongTailDataset(tables, 64, num_batches=n, dense_in_features=13, skew=0.5, seed=7,
                                         learnable_labels=False)
    jax_data = JaxDataset(tables, 64, num_batches=n, dense_in_features=13, skew=0.5, seed=7,
                          learnable_labels=False)
    port, freq_s = bench.build_trainer(setup, port_data, torch.device("cpu"))
    assert (freq_s is None) == (case == "resident_bag")
    if case == "resident_bag":
        import jax.numpy as jnp

        from cachedembedding_tpu.baselines.full_resident import FullyResidentEmbeddingBag

        embed = FullyResidentEmbeddingBag(jax_cfg.total_num_embeddings, 128, table_sizes=tables,
                                          seed=jax_cfg.seed, dtype=jnp.bfloat16)
        ref = JaxTrainer(jax_cfg, embed_override=embed)
        assert port.embed.cache_weight.dtype == torch.bfloat16
    else:
        ref = JaxTrainer(jax_cfg, id_freq_map=jax_data.id_freq_map())
    losses = {"port": [], "jax": []}
    stats = {}
    for name, tr, data, fresh in (("port", port, port_data, CacheStats), ("jax", ref, jax_data, JaxCacheStats)):
        batches = [data.make_batch(i) for i in range(n)]
        losses[name] += tr.train(batches[:4], num_iters=4).losses
        tr.embed.stats = fresh()
        losses[name] += tr.train(batches[4:], num_iters=4).losses
        if hasattr(tr.embed, "_drain_writebacks"):
            tr.embed._drain_writebacks()
        stats[name] = {k: getattr(tr.embed.stats, k) for k in STATS}
    port.close()
    assert stats["port"] == stats["jax"]
    if case == "all_cached":
        assert len(stats["port"]["num_hits_history"]) == 2
        assert sum(stats["port"]["num_hits_history"]) > 0 and sum(stats["port"]["num_miss_history"]) > 0
    assert np.isfinite(losses["port"]).all() and len(losses["port"]) == n
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-2)


def test_main_prints_one_line(capsys):
    """``main`` at --scale small on the CPU: exactly one stdout line with
    bench.py's four keys and metric name, and the stderr summary."""
    assert bench.main(SMALL + ["--warmup-iters", "4", "--iters", "4", "--segments", "2", "--deadline", "0",
                               "--resident-threshold", "0"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "dlrm_small_cached_train_throughput" and rec["unit"] == "examples/s"
    assert rec["value"] > 0 and rec["vs_baseline"] == round(rec["value"] / 819_200, 4)
    summary = json.loads(err.split("bench summary: ", 1)[1].splitlines()[0])
    assert summary["card"] == "cpu" and summary["windows"] == 4 and len(summary["segments"]) == 2
    assert summary["peak_gib"] is None and summary["hbm_share"] is None  # no device numbers from a CPU run
    assert summary["device_share"] is None and summary["launches"] == {}  # the plain versions launch nothing
    assert 0 < summary["hit_rate"] <= 1 and summary["ceiling"]["ms_per_iter"] > 0
    assert "WARNING: no segment carried eviction writebacks" in err
    # each segment's statistics are its own: the ceiling probe's window is counted in none
    logged = re.findall(r"segment (\d+): .* hit=([0-9.]+) ", err)
    assert [int(i) for i, _ in logged] == [0, 1]
    for i, hit in logged:
        assert f"{summary['segments'][int(i)]['hit_rate']:.4f}" == hit


def _seg(ex_s: float, swap_out: int) -> bench.Segment:
    stats = CacheStats()
    stats.swap_out_bytes = swap_out
    return bench.Segment(ex_s, 1.0, None, stats)


@pytest.mark.parametrize("case", ["prefers_churning", "drops_10x", "equal_segments", "none_churn", "empty"])
def test_select_best(case):
    if case == "prefers_churning":
        runs = [_seg(900, 0), _seg(500, 1), _seg(600, 1), _seg(100, 1)]
        assert bench.select_best(runs) == (2, [1, 2, 3], [])
    elif case == "drops_10x":
        best, churning, excluded = bench.select_best([_seg(1000, 1), _seg(99, 1), _seg(100, 1)])
        assert (best, churning) == (0, [0, 2])
        assert excluded == [{"segment": 1, "ex_s": 99.0, "reason": ">=10x below best segment"}]
    elif case == "equal_segments":
        # two equal segments: each is reported by its own index (bench.py:654's runs.index gives the first twice)
        a, b = _seg(50, 1), _seg(50, 1)
        assert a == b
        best, churning, excluded = bench.select_best([_seg(1000, 0), a, b, _seg(700, 1)])
        assert [e["segment"] for e in excluded] == [1, 2]
        assert (best, churning) == (3, [3])
        assert bench.select_best([_seg(10, 1), _seg(300, 1), _seg(300, 1)])[0] == 1
    elif case == "none_churn":
        assert bench.select_best([_seg(300, 0), _seg(400, 0)]) == (1, [], [])
    else:
        assert bench.select_best([]) == (None, [], [])


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a GPU and without --platform cpu, main raises before building
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default platform is valid")

    def never(*a, **k):
        raise AssertionError("the bench built its configuration without a device")

    monkeypatch.setattr(bench, "build_config", never)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        bench.main(["--scale", "small", "--batch-size", "64", "--prefetch", "2"])
