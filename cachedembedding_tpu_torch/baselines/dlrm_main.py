"""Baseline trainer command line (counterpart of
``cachedembedding_tpu/baselines/dlrm_main.py``), the torchrec-DMP comparison
harness: pick an embedding kernel and a sharding type, let the planner
(``parallel/planner.py``) make and print a placement, then train and evaluate
the same DLRM on the same data as the flagship command line.

Kernels: ``hbm``, the whole table resident on the device (torchrec's
"fused"; ``baselines/full_resident.py``, f32 rows); ``cached``, the
host-DRAM table with a device hot-row cache; ``auto``, the plan executed:
its HBM_FULL tables resident and its CACHED tables cached, in one mixed bag.
``--sharding`` (auto, table, column, row, tablerow, tablecolumn) shapes the
printed plan only, as in JAX; training runs on one device.

    python -m cachedembedding_tpu_torch.baselines.dlrm_main --kernel hbm --plan_only
    python -m cachedembedding_tpu_torch.baselines.dlrm_main --kernel cached --limit_train_batches 50

It runs on the current CUDA device; ``--platform cpu`` runs it on the CPU.
``--num_devices`` (the plan's devices) defaults to the visible CUDA devices
(1 under ``--platform cpu``) and ``--hbm_gb`` to an H100's 80. Besides the
JAX command line's lines it prints ``run stats: {json}`` on stderr: the
kernel launches, examples/s, the losses, the plan's HBM_FULL tables and the
bag's resident tables, host and device seconds a window, peak device memory.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cachedembedding_tpu_torch baseline trainer")
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--num_embeddings_per_feature", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=16384)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--embedding_dim", type=int, default=128)
    p.add_argument("--learning_rate", "--lr", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--kernel", choices=["hbm", "cached", "auto"], default="hbm",
                   help="embedding kernel: hbm (whole table on the device), cached (host table + device "
                        "cache), or auto (the plan's per-table kernels in one mixed bag)")
    p.add_argument("--sharding", choices=["auto", "table", "column", "row", "tablerow", "tablecolumn"],
                   default="auto",
                   help="sharding type fed to the planner (tablerow/tablecolumn shard within one host group: "
                        "set --devices_per_host)")
    p.add_argument("--devices_per_host", type=int, default=0,
                   help="devices per host for the hierarchical tablerow/tablecolumn placements (0 = one host)")
    p.add_argument("--cache_ratio", type=float, default=0.01)
    p.add_argument("--use_freq", action="store_true")
    p.add_argument("--prefetch_num", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=None,
                   help="topology size for planning (default: the visible CUDA devices)")
    p.add_argument("--hbm_gb", type=float, default=80.0)
    p.add_argument("--host_gb", type=float, default=256.0)
    p.add_argument("--plan_only", action="store_true", help="print the sharding plan and exit")
    p.add_argument("--platform", type=str, default=None,
                   help="torch device type to run on: cuda (default) or cpu")
    return p.parse_args(argv)


def default_num_devices(device) -> int:
    """The plan's devices without ``--num_devices``: the visible CUDA
    devices (as JAX's ``len(jax.devices())``), one for a CPU run."""
    import torch

    return 1 if device.type == "cpu" else torch.cuda.device_count()


def main(argv=None) -> None:
    import torch

    from cachedembedding_tpu_torch.config import CacheConfig
    from cachedembedding_tpu_torch.ops import launch_counts
    from cachedembedding_tpu_torch.parallel.planner import (
        EmbeddingShardingPlanner,
        Kernel,
        ShardingType,
        Topology,
        specs_from_sizes,
    )
    from cachedembedding_tpu_torch.train import dlrm_main as flagship

    args = parse_args(argv)
    # reuse the flagship command line's dataset plumbing
    base = flagship.parse_args([])
    base.dataset_dir = args.dataset_dir
    base.num_embeddings_per_feature = args.num_embeddings_per_feature
    base.batch_size = args.batch_size
    base.limit_train_batches = args.limit_train_batches
    base.limit_val_batches = args.limit_val_batches
    base.use_freq = args.use_freq
    base.embedding_dim = args.embedding_dim
    base.platform = args.platform
    if args.embedding_dim != 128:
        # DenseArch must end at embedding_dim for the interaction
        base.dense_arch_layer_sizes = f"{4 * args.embedding_dim},{args.embedding_dim}"
    device = flagship.resolve_platform(base)
    cfg = flagship.build_config(base)
    cfg.learning_rate = args.learning_rate
    cfg.seed = args.seed
    cfg.cache = CacheConfig(
        cache_ratio=args.cache_ratio, prefetch_num=args.prefetch_num, use_freq=args.use_freq, buffer_size=0,
    )

    freq = flagship.get_freq(base, cfg) if args.use_freq else None
    ndev = args.num_devices or default_num_devices(device)
    topo = Topology(
        num_devices=ndev,
        hbm_bytes_per_device=int(args.hbm_gb * (1 << 30)),
        host_dram_bytes=int(args.host_gb * (1 << 30)),
        devices_per_host=args.devices_per_host,
    )
    specs = specs_from_sizes(cfg.num_embeddings_per_feature, cfg.embedding_dim, id_freq_map=freq)
    force_sharding = {
        "auto": None,
        "table": ShardingType.TABLE_WISE,
        "column": ShardingType.COLUMN_WISE,
        "row": ShardingType.ROW_WISE,
        "tablerow": ShardingType.TABLE_ROW_WISE,
        "tablecolumn": ShardingType.TABLE_COLUMN_WISE,
    }[args.sharding]
    plan = EmbeddingShardingPlanner(topo).plan(
        specs,
        batch_size=cfg.batch_size,
        force_kernel=Kernel.CACHED if args.kernel == "cached" else None,
        force_sharding=force_sharding,
        default_cache_ratio=args.cache_ratio,
    )
    print(plan.pretty())
    if args.plan_only:
        return

    from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    if args.kernel == "hbm":
        embed = FullyResidentEmbeddingBag(
            cfg.total_num_embeddings, cfg.embedding_dim,
            table_sizes=cfg.num_embeddings_per_feature, seed=cfg.seed, device=device,
        )
        trainer = CachedDLRMTrainer(cfg, embed_override=embed)
    elif args.kernel == "auto":
        # execute the plan: per-table kernels in one mixed bag
        from cachedembedding_tpu_torch.cache.manager import CachedEmbeddingBag

        resident = [i for i, tp in enumerate(plan.tables) if tp.kernel is Kernel.HBM_FULL]
        embed = CachedEmbeddingBag(
            cfg.total_num_embeddings, cfg.embedding_dim,
            table_sizes=cfg.num_embeddings_per_feature,
            cache_ratio=args.cache_ratio,
            ids_freq_mapping=freq,
            warmup_ratio=cfg.cache.warmup_ratio if freq is not None else 0.0,
            buffer_size=0, seed=cfg.seed,
            resident_tables=resident,
            device=device,
        )
        print(
            f"mixed-kernel: {len(resident)} resident tables "
            f"({embed.resident_total} rows HBM), "
            f"{len(plan.tables) - len(resident)} cached "
            f"(capacity {embed.capacity})", file=sys.stderr,
        )
        trainer = CachedDLRMTrainer(cfg, embed_override=embed)
    else:
        trainer = CachedDLRMTrainer(cfg, id_freq_map=freq, device=device)

    train_data = flagship.get_data(base, cfg, "train")
    report = trainer.train(train_data, num_iters=args.limit_train_batches, log_every=100)
    print(
        f"train: {len(report.losses)} iters, {report.it_per_s:.2f} it/s, "
        f"{report.examples_per_s:.0f} ex/s", file=sys.stderr,
    )
    val = flagship.get_data(base, cfg, "val")
    if args.limit_val_batches:
        val = list(val)[: args.limit_val_batches]
    metrics = trainer.evaluate(val)
    trainer.close()
    print(f"val: auroc={metrics['auroc']:.9f} accuracy={metrics['accuracy']:.9f}")
    stats = {
        "kernel_launches": launch_counts(),
        "examples_per_s": report.examples_per_s,
        "losses": report.losses,
        "plan_hbm_full_tables": [i for i, tp in enumerate(plan.tables) if tp.kernel is Kernel.HBM_FULL],
        "resident_tables": list(getattr(trainer.embed, "resident_tables", range(len(plan.tables)))),
        "window_host_s": report.window_host_s,
        "window_device_s": report.window_device_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }
    print(f"run stats: {json.dumps(stats)}", file=sys.stderr)


if __name__ == "__main__":
    main()
