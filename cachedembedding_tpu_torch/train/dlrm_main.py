"""Training command line for one device (counterpart of
``cachedembedding_tpu/train/dlrm_main.py``): every flag of the JAX CLI, with
the same defaults.

    python -m cachedembedding_tpu_torch.train.dlrm_main --dataset_dir /data/criteo_kaggle \\
        --kaggle --use_cache --use_freq --cache_ratio 0.01 --warmup_ratio 0.7 --buffer_size 50000

It runs on the current CUDA device; ``--platform cpu`` runs it on the CPU
(without it and with no GPU it raises). With no ``--dataset_dir`` it trains on
procedural long-tail batches. Without ``--use_cache`` the whole table lives on
the device (``baselines/full_resident.py``, f32 rows), with its row-wise
Adagrad accumulators under ``--embedding_optimizer rowwise_adagrad`` (the
JAX CLI builds its resident table without them, so there it trains with
SGD). ``--cache_dtype`` also takes ``float8_e5m2``, which the JAX trainer
stores but the JAX CLI does not offer. Flags that name a multi-device layout,
and options the port does not run yet, raise ``NotImplementedError`` naming
their ROADMAP item; with ``--world_size`` unset and several GPUs visible, it
says on stderr that it trains on one (the JAX CLI would use them all).
``--profile_dir`` writes a ``torch.profiler`` trace there;
``--memory_fraction`` caps this process's share of device memory;
``--pin_memory`` and ``--use_overlap`` are accepted (host payloads are
pinned, and staging overlaps the device's steps, always).

Besides the JAX CLI's lines it prints, on stderr, ``run stats: {json}``: the
kernel launches, the table's fill seconds, the frequency map's seconds, host
and device seconds a window, the update plans' host ms a step, the peak
device memory, the bytes of fetched admits, each window's id wire format and
the first window's bytes by block, with ``--planner device`` each window's
plan device seconds and plan readback (bytes, device seconds, host wait),
and under row-wise Adagrad the rows whose accumulator grew.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cachedembedding_tpu_torch DLRM trainer")
    # data
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--kaggle", action="store_true", help="treat dataset as criteo kaggle")
    p.add_argument("--num_embeddings_per_feature", type=str, default=None,
                   help="comma-separated table sizes (overrides dataset constants)")
    p.add_argument("--batch_size", type=int, default=16384)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--limit_test_batches", type=int, default=None)
    p.add_argument("--shuffle_batches", action="store_true")
    p.add_argument("--pin_memory", action="store_true", help="accepted: host payloads are always pinned")
    # model
    p.add_argument("--model", choices=["dlrm", "deepfm"], default="dlrm")
    p.add_argument("--deep_fm_dimension", type=int, default=16)
    p.add_argument("--embedding_dim", type=int, default=128)
    p.add_argument("--dense_arch_layer_sizes", type=str, default="512,256,128")
    p.add_argument("--over_arch_layer_sizes", type=str, default="1024,1024,512,256,1")
    # training
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", "--lr", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--change_lr", action="store_true")
    p.add_argument("--lr_change_point", type=float, default=0.8)
    p.add_argument("--lr_after", type=float, default=0.2)
    p.add_argument("--validation_freq_within_epoch", type=int, default=None)
    # cache
    p.add_argument("--use_cache", action="store_true")
    p.add_argument("--cache_ratio", type=float, default=0.01)
    p.add_argument("--cache_sets", type=int, default=None,
                   help="legacy reference flag (pre --cache_ratio); accepted, unused")
    p.add_argument("--warmup_ratio", type=float, default=0.7)
    p.add_argument("--buffer_size", type=int, default=50_000)
    p.add_argument("--use_freq", action="store_true")
    p.add_argument("--use_lfu", action="store_true")
    p.add_argument("--use_overlap", action="store_true", help="accepted: staging always overlaps")
    p.add_argument("--prefetch_num", type=int, default=8, help="far-sighted prefetch window depth")
    p.add_argument("--transfer_dtype", choices=["float32", "bfloat16", "int8", "int4"], default="float32",
                   help="host<->device row payload dtype (int8/int4: per-row quantized admits)")
    p.add_argument("--cache_dtype", choices=["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"],
                   default="bfloat16", help="device cache-row storage dtype")
    p.add_argument("--stochastic_rounding", choices=["auto", "on", "off"], default="auto",
                   help="stochastic rounding of cache-row updates (auto = on for fp8 rows)")
    p.add_argument("--planner", choices=["auto", "host", "device"], default="auto",
                   help="cache planner: native host directory vs the device state machine")
    # parallelism: ROADMAP Queue 1 item 9
    p.add_argument("--use_tablewise", action="store_true")
    p.add_argument("--use_rowwise", action="store_true")
    p.add_argument("--fused_op", choices=["all_to_all", "gather_scatter"], default="all_to_all")
    p.add_argument("--world_size", type=int, default=None, help="devices to use (1 in this port)")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # observability / debug
    p.add_argument("--inspect_time", action="store_true",
                   help="run 200 iters printing per-step loss + timing, then exit")
    p.add_argument("--profile_dir", type=str, default="", help="write a torch.profiler trace here")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="save a flush-coherent checkpoint here after each epoch "
                        "(and resume from it at startup if present)")
    p.add_argument("--memory_fraction", type=float, default=None,
                   help="torch.cuda.set_per_process_memory_fraction")
    p.add_argument("--platform", type=str, default=None,
                   help="torch device type to run on: cuda (default) or cpu")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--embedding_optimizer", choices=["sgd", "rowwise_adagrad"], default="sgd",
                   help="embedding-table optimizer; rowwise_adagrad state tiers with the cache")
    p.add_argument("--adagrad_eps", type=float, default=1e-10)
    p.add_argument("--use_sparse_embed_grad", action="store_true",
                   help="force the sparse-gradient update (the ordered scatter-add in the rows' dtype); "
                        "otherwise taken where the device rows exceed 4x a step's ids")
    return p.parse_args(argv)


def refuse_outside_port(args) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every flag
    this single-device port does not run yet."""
    refusals = [
        (args.use_tablewise, "--use_tablewise"),
        (args.use_rowwise, "--use_rowwise"),
        (args.multihost, "--multihost"),
        (args.world_size is not None and args.world_size > 1, f"--world_size {args.world_size}"),
    ]
    for bad, flag in refusals:
        if bad:
            raise NotImplementedError(f"{flag}: multi-device training is ROADMAP Queue 1 item 9")


def note_single_card(args) -> None:
    """With ``--world_size`` unset the JAX CLI trains on every visible
    device; this port trains on one: say so, in one line on stderr."""
    import torch

    n = torch.cuda.device_count()
    if args.world_size is None and n > 1:
        print(f"note: {n} CUDA devices are visible and --world_size is unset: this port trains on one card, "
              "where the JAX CLI would use every visible device (multi-device training is ROADMAP Queue 1 "
              "item 9)", file=sys.stderr)


def build_config(args):
    from cachedembedding_tpu_torch.config import (
        AVAZU_NUM_DENSE,
        AVAZU_NUM_EMBEDDINGS_PER_FEATURE,
        CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE,
        CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
        CRITEO_NUM_DENSE,
        CacheConfig,
        DLRMConfig,
    )

    dense_in = CRITEO_NUM_DENSE
    if args.num_embeddings_per_feature:
        tables = [int(x) for x in args.num_embeddings_per_feature.split(",")]
    elif args.dataset_dir is None:
        tables = [100_000, 20_000, 10_000, 5_000]
    elif "kaggle" in args.dataset_dir or args.kaggle:
        tables = CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE
    elif "avazu" in args.dataset_dir:
        tables = AVAZU_NUM_EMBEDDINGS_PER_FEATURE
        dense_in = AVAZU_NUM_DENSE
    else:
        tables = CRITEO_1TB_NUM_EMBEDDINGS_PER_FEATURE

    cache = CacheConfig(
        cache_ratio=args.cache_ratio,
        warmup_ratio=args.warmup_ratio,
        buffer_size=args.buffer_size,
        use_lfu_eviction=args.use_lfu,
        use_freq=args.use_freq,
        prefetch_num=args.prefetch_num,
        use_overlap=args.use_overlap,
        transfer_dtype=args.transfer_dtype,
        cache_dtype=args.cache_dtype,
        stochastic_rounding=args.stochastic_rounding,
        planner=args.planner,
    )
    return DLRMConfig(
        model=args.model,
        deep_fm_dimension=args.deep_fm_dimension,
        num_embeddings_per_feature=tables,
        embedding_dim=args.embedding_dim,
        dense_in_features=dense_in,
        dense_arch_layer_sizes=tuple(int(x) for x in args.dense_arch_layer_sizes.split(",")),
        over_arch_layer_sizes=tuple(int(x) for x in args.over_arch_layer_sizes.split(",")),
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        seed=args.seed,
        change_lr=args.change_lr,
        lr_change_point=args.lr_change_point,
        lr_after=args.lr_after,
        shuffle_batches=args.shuffle_batches,
        validation_freq_within_epoch=args.validation_freq_within_epoch,
        use_tablewise=args.use_tablewise,
        fused_op=args.fused_op,
        compute_dtype=args.compute_dtype,
        embedding_optimizer=args.embedding_optimizer,
        adagrad_eps=args.adagrad_eps,
        use_sparse_embed_grad=args.use_sparse_embed_grad,
        cache=cache,
    )


def get_data(args, cfg, stage: str):
    if args.dataset_dir is None:
        from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

        n = {"train": args.limit_train_batches or 10,
             "val": args.limit_val_batches or 2,
             "test": args.limit_test_batches or 2}[stage]
        return SyntheticLongTailDataset(
            cfg.num_embeddings_per_feature, cfg.batch_size, n,
            dense_in_features=cfg.dense_in_features,
            seed=cfg.seed + {"train": 0, "val": 1, "test": 2}[stage],
        )
    if "avazu" in args.dataset_dir:
        from cachedembedding_tpu_torch.data import avazu as mod
    else:
        from cachedembedding_tpu_torch.data import criteo as mod
    return mod.get_dataloader(
        args.dataset_dir, stage, cfg.batch_size,
        shuffle_batches=cfg.shuffle_batches, seed=cfg.seed,
        hashes=cfg.num_embeddings_per_feature,
    )


def get_freq(args, cfg) -> Optional[np.ndarray]:
    if not args.use_freq:
        return None
    if args.dataset_dir is None:
        return get_data(args, cfg, "train").id_freq_map()
    if "avazu" in args.dataset_dir:
        from cachedembedding_tpu_torch.data.avazu import get_id_freq_map
    else:
        from cachedembedding_tpu_torch.data.criteo import get_id_freq_map
    return np.asarray(get_id_freq_map(args.dataset_dir, table_sizes=cfg.num_embeddings_per_feature))


def resolve_platform(args):
    """The torch device of ``--platform`` (the current CUDA device when
    absent; with no GPU that raises)."""
    from cachedembedding_tpu_torch import resolve_device

    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"--platform {args.platform!r}: cpu or cuda")
    return resolve_device(None if args.platform in (None, "gpu") else args.platform)


def build_trainer(args, cfg, freq, device):
    """The cached trainer with ``--use_cache``, else the trainer over the
    fully device-resident table (f32 rows, as the JAX CLI builds it)."""
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    if args.use_cache:
        return CachedDLRMTrainer(cfg, id_freq_map=freq, device=device)
    from cachedembedding_tpu_torch.baselines.full_resident import FullyResidentEmbeddingBag

    embed = FullyResidentEmbeddingBag(
        cfg.total_num_embeddings, cfg.embedding_dim,
        table_sizes=cfg.num_embeddings_per_feature, seed=cfg.seed, device=device,
        optimizer=cfg.embedding_optimizer, adagrad_initial=cfg.adagrad_initial,
    )
    return CachedDLRMTrainer(cfg, embed_override=embed)


def _limited(data, lim):
    return list(data)[:lim] if lim else data


def main(argv=None) -> None:
    import torch

    from cachedembedding_tpu_torch.ops import launch_counts
    from cachedembedding_tpu_torch.utils.misc import get_mem_info

    args = parse_args(argv)
    refuse_outside_port(args)
    note_single_card(args)
    device = resolve_platform(args)
    if device.type == "cuda":
        if args.memory_fraction is not None:
            torch.cuda.set_per_process_memory_fraction(args.memory_fraction, device)
        torch.cuda.reset_peak_memory_stats(device)
    cfg = build_config(args)
    print(f"config: {cfg}", file=sys.stderr)
    t0 = time.perf_counter()
    cached_freq = bool(args.use_freq and args.dataset_dir
                       and os.path.exists(os.path.join(args.dataset_dir, "id_freq_map.npy")))
    freq = get_freq(args, cfg)
    freq_s = time.perf_counter() - t0
    if freq is not None:
        print(f"id_freq_map: {'loaded' if cached_freq else 'computed'} in {freq_s:.2f} s", file=sys.stderr)

    trainer = build_trainer(args, cfg, freq, device)
    print(f"table filled in {trainer.embed.table_init_s:.2f} s", file=sys.stderr)
    print(get_mem_info("after model init", device), file=sys.stderr)

    if args.checkpoint_dir and os.path.exists(os.path.join(args.checkpoint_dir, "meta.json")):
        from cachedembedding_tpu_torch.utils.checkpoint import load_checkpoint

        step = load_checkpoint(args.checkpoint_dir, trainer)
        print(f"resumed from {args.checkpoint_dir} at step {step}", file=sys.stderr)

    train_data = get_data(args, cfg, "train")
    limit = args.limit_train_batches

    if args.inspect_time:
        report = trainer.train(train_data, num_iters=min(limit or 200, 200), log_every=1)
        print(f"inspect: {report.it_per_s:.2f} it/s over {len(report.losses)} iters")
        trainer.embed.print_comm_stats()
        trainer.close()
        return

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()

    reports = []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        vfreq = cfg.validation_freq_within_epoch
        if vfreq:
            # mid-epoch validation every vfreq iterations
            it = iter(train_data)
            done = 0
            parts = []
            while limit is None or done < limit:
                seg = vfreq if limit is None else min(vfreq, limit - done)
                rep = trainer.train(it, num_iters=seg, log_every=100)
                if not rep.losses:
                    break
                parts.append(rep)
                done += len(rep.losses)
                m = trainer.evaluate(_limited(get_data(args, cfg, "val"), args.limit_val_batches))
                print(f"epoch {epoch} it {done}: val auroc={m['auroc']:.6f}")
                if len(rep.losses) < seg:
                    break
            tot = time.perf_counter() - t0
            losses = [x for r in parts for x in r.losses]
            report = type(parts[0])(
                losses=losses, it_per_s=len(losses) / tot,
                examples_per_s=len(losses) * cfg.batch_size / tot,
                hit_rate=parts[-1].hit_rate,
                window_host_s=[x for r in parts for x in r.window_host_s],
                window_device_s=[x for r in parts for x in r.window_device_s],
                window_plan_s=[x for r in parts for x in r.window_plan_s],
                window_wire=[x for r in parts for x in r.window_wire],
                window_copy_s=[x for r in parts for x in r.window_copy_s],
                window_plan_device_s=[x for r in parts for x in r.window_plan_device_s],
                window_readback=[x for r in parts for x in r.window_readback],
            )
        else:
            report = trainer.train(train_data, num_iters=limit, log_every=100)
        reports.append(report)
        print(
            f"epoch {epoch}: {len(report.losses)} iters in {time.perf_counter() - t0:.0f}s "
            f"({report.it_per_s:.2f} it/s, {report.examples_per_s:.0f} ex/s, "
            f"hit_rate={report.hit_rate:.4f})"
        )
        trainer.embed.print_comm_stats()
        if args.checkpoint_dir:
            from cachedembedding_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint_dir, trainer)
            print(f"checkpoint saved to {args.checkpoint_dir}", file=sys.stderr)
        for stage, lim in [("val", args.limit_val_batches), ("test", args.limit_test_batches)]:
            metrics = trainer.evaluate(_limited(get_data(args, cfg, stage), lim))
            print(f"epoch {epoch} {stage}: auroc={metrics['auroc']:.9f} "
                  f"accuracy={metrics['accuracy']:.9f} over {metrics['count']}")

    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    trainer.close()
    print(get_mem_info("after training", device), file=sys.stderr)
    steps = sum(len(r.losses) for r in reports)
    stats = {
        "kernel_launches": launch_counts(),
        "table_init_s": trainer.embed.table_init_s,
        "freq_s": freq_s if freq is not None else None,
        "examples_per_s": [r.examples_per_s for r in reports],
        "losses": [x for r in reports for x in r.losses],
        "window_host_s": [x for r in reports for x in r.window_host_s],
        "window_device_s": [x for r in reports for x in r.window_device_s],
        "plan_host_ms_per_step": 1e3 * sum(x for r in reports for x in r.window_plan_s) / max(steps, 1),
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "swap_in_bytes": trainer.embed.stats.swap_in_bytes,
        "wire_formats": [w["format"] for r in reports for w in r.window_wire],
        "window_bytes": [w["bytes"] for r in reports for w in r.window_wire][:1],
        "window_plan_device_s": [x for r in reports for x in r.window_plan_device_s],
        "window_readback": [x for r in reports for x in r.window_readback],
    }
    if trainer.embed.cache_accum is not None:
        # row-wise Adagrad: rows whose accumulator grew, on the device and,
        # written back on eviction, in the host store
        stats["accum_positive_device_rows"] = int((trainer.embed.cache_accum > 0).sum())
        host = getattr(trainer.embed, "host_accum", None)
        if host is not None:
            st = host.save_state()
            stats["accum_positive_host_rows"] = int((st["arr" if st["kind"] == "dense" else "vals"] > 0).sum())
    print(f"run stats: {json.dumps(stats)}", file=sys.stderr)


if __name__ == "__main__":
    main()
