"""Training command line (counterpart of
``cachedembedding_tpu/train/dlrm_main.py``): every flag of the JAX CLI, with
the same defaults.

    python -m cachedembedding_tpu_torch.train.dlrm_main --dataset_dir /data/criteo_kaggle \\
        --kaggle --use_cache --use_freq --cache_ratio 0.01 --warmup_ratio 0.7 --buffer_size 50000

It runs on the CUDA devices; ``--platform cpu`` runs it on the CPU (without
it and with no GPU it raises). ``--world_size`` ranks train one column-wise
mesh (``parallel/column.py``, ``train/mesh_window.py``), as the JAX CLI
does with more than one device: unset, it means every visible CUDA device
(1 under ``--platform cpu``); more than the visible cards raises. With more
than one rank the command spawns them itself (one process a rank, NCCL on
the card, gloo on the CPU, a file rendezvous), unless a launcher such as
``torchrun`` started it; only rank 0 prints. ``--multihost`` makes the
process one host of several, where the JAX CLI's process is one controller
of a host's devices: with ``--coordinator_address H:P --num_processes N
--process_id p`` it spawns its ``local`` ranks (the visible cards, or
``--world_size / N`` under ``--platform cpu``), rank i joining
``tcp://H:P`` as global rank ``p * local + i`` of ``N * local``, and each
host's first rank prints, as each JAX controller does; without
``--coordinator_address`` it joins a launcher's process group (and raises
where none is set); every layout runs under it. With no ``--dataset_dir`` it trains on
procedural long-tail batches. Without ``--use_cache`` the whole table lives on
the device (``baselines/full_resident.py``, f32 rows), with its row-wise
Adagrad accumulators under ``--embedding_optimizer rowwise_adagrad`` (the
JAX CLI builds its resident table without them, so there it trains with
SGD). ``--cache_dtype`` also takes ``float8_e5m2``, which the JAX trainer
stores but the JAX CLI does not offer. ``--use_tablewise`` trains the
table-wise layout (``run_hybrid``: ``models/hybrid.HybridParallelDLRM`` over
a mesh of ``--world_size`` ranks, one rank too), window by window, then
validates and tests after each epoch, as the JAX CLI's ``run_hybrid`` does;
like it, it trains DLRM towers with plain SGD on f32 cache rows and f32
admits, and says on stderr which of the flags it ignores were set
(``TABLEWISE_IGNORES``). ``--use_rowwise`` trains the row-sharded cached
layout (``run_rowwise``: ``parallel/row_cached.py``) the same way, as the
JAX CLI's ``run_rowwise`` does: plain SGD on f32 cache rows, f32 compute,
the window planned once and trained step by step, evaluation batch by
batch; it names the flags it ignores too (``ROWWISE_IGNORES``).
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
each span's median host ms a window (``span_ms_per_window``, by the names of
``utils/spans.py``: the window's fetch, staging, the cache's host plan and
its range check, the readback wait, the admits, the dispatch and its steps'
forward-backward, embedding update and dense update, and on the host
planner the wire's encoding, packing, update plans and shipping), the bytes
copied over the host link each way (``h2d_bytes``, ``d2h_bytes``), and
under row-wise Adagrad the rows whose accumulator grew.
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
    # parallelism
    p.add_argument("--use_tablewise", action="store_true")
    p.add_argument("--use_rowwise", action="store_true")
    p.add_argument("--fused_op", choices=["all_to_all", "gather_scatter"], default="all_to_all")
    p.add_argument("--world_size", type=int, default=None,
                   help="ranks of the mesh (default: every visible device)")
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


def resolve_hosts(args) -> int:
    """The processes (hosts) of the run: ``--num_processes`` under
    ``--multihost --coordinator_address``, else 1. Exits with the JAX CLI's
    message where the coordinator comes without its counts, and raises
    where ``--multihost`` has neither a coordinator nor a launcher."""
    from cachedembedding_tpu_torch.parallel.mesh import launched

    if not args.multihost:
        return 1
    if args.coordinator_address:
        if args.num_processes is None or args.process_id is None:
            sys.exit("--coordinator_address requires --num_processes and --process_id (jax.distributed cannot "
                     "autodetect them off-pod)")
        if not 0 <= args.process_id < args.num_processes:
            raise ValueError(f"--process_id {args.process_id} outside [0, {args.num_processes})")
        return int(args.num_processes)
    if not launched():
        raise RuntimeError("--multihost without --coordinator_address joins a launcher's process group (torchrun's "
                           "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT); none is set")
    return 1


def resolve_world_size(args) -> int:
    """The mesh's ranks, as the JAX CLI resolves them (its ``--world_size
    or len(jax.devices())``): ``--world_size``, else the launcher's world
    size, else every visible CUDA device of every host, and one rank a host
    under ``--platform cpu``. On the card, more ranks on one host than its
    visible cards raise."""
    import torch

    from cachedembedding_tpu_torch.parallel.mesh import launched

    cpu = args.platform == "cpu"
    hosts = resolve_hosts(args)
    if args.world_size is not None:
        n = int(args.world_size)
    elif launched():
        n = int(os.environ["WORLD_SIZE"])
    else:
        n = hosts * (1 if cpu else torch.cuda.device_count())
    if n < 1:
        raise ValueError(f"--world_size {n}: at least one rank")
    if n % hosts:
        raise ValueError(f"--world_size {n} does not split evenly over {hosts} processes")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n)) if launched() else n // hosts
    if not cpu and local > max(torch.cuda.device_count(), 1):
        where = f" ({local} a process)" if hosts > 1 else ""
        raise ValueError(f"--world_size {n}{where}: {torch.cuda.device_count()} CUDA devices are visible")
    return n


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


def build_trainer(args, cfg, freq, device, mesh=None):
    """The cached trainer with ``--use_cache`` or on a mesh (as in JAX),
    else the trainer over the fully device-resident table (f32 rows, as the
    JAX CLI builds it)."""
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    if mesh is not None:
        return CachedDLRMTrainer(cfg, id_freq_map=freq, mesh=mesh)
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
    """Parse, resolve the world size, then train on one device, or spawn the
    mesh's ranks (each runs ``run``), or, under a launcher, be one of them."""
    import torch.distributed as dist

    from cachedembedding_tpu_torch.parallel.mesh import launched, make_mesh

    args = parse_args(argv)
    device = resolve_platform(args)
    world = resolve_world_size(args)  # (it checks the --multihost flags)
    argv = sys.argv[1:] if argv is None else list(argv)
    if args.multihost and args.coordinator_address:
        local = world // args.num_processes
        return _spawn(argv, world, local, f"tcp://{args.coordinator_address}", args.process_id * local)
    if world == 1 and not launched():
        return run(args, device)
    if launched() or dist.is_initialized():
        return run(args, device, make_mesh(world, device.type))
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dlrm_main_") as root:
        _spawn(argv, world, world, f"file://{os.path.join(root, 'rendezvous')}", 0)


def _spawn(argv, world: int, nprocs: int, init_method: str, first_rank: int) -> None:
    """Start ``nprocs`` ranks of this host (global ranks ``first_rank`` on)
    and wait for them."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(world, init_method, argv, first_rank), nprocs=nprocs,
                       start_method="spawn")


def _rank_main(i: int, world: int, init_method: str, argv, first_rank: int = 0):
    """Local rank ``i`` of the command line: join the mesh as global rank
    ``first_rank + i`` on this host's card ``i``, then ``run``."""
    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh

    args = parse_args(argv)
    mesh = make_mesh(world, "cpu" if args.platform == "cpu" else "cuda", init_method=init_method,
                     rank=first_rank + i, local_rank=i)
    try:
        return run(args, mesh.device, mesh, quiet=i != 0)
    finally:
        destroy_mesh(mesh)


def run(args, device, mesh=None, quiet: Optional[bool] = None):
    """Train and evaluate, as one device or as one rank of ``mesh`` (every
    rank runs it; where ``quiet`` is not given, only rank 0 prints; the
    ranks the command spawns print where they are the first of their host). Returns ``run_hybrid``'s result under
    ``--use_tablewise``, ``run_rowwise``'s under ``--use_rowwise``, else
    None."""
    import contextlib

    if quiet is None:
        quiet = mesh is not None and mesh.rank != 0
    if quiet:
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet), contextlib.redirect_stderr(quiet):
            return _run(args, device, mesh)
    return _run(args, device, mesh)


def _run(args, device, mesh):
    import torch
    import torch.distributed as dist

    from cachedembedding_tpu_torch.ops import launch_counts
    from cachedembedding_tpu_torch.utils.misc import get_mem_info
    from cachedembedding_tpu_torch.utils.spans import median_ms

    if device.type == "cuda":
        if args.memory_fraction is not None:
            torch.cuda.set_per_process_memory_fraction(args.memory_fraction, device)
        torch.cuda.reset_peak_memory_stats(device)
    cfg = build_config(args)
    print(f"config: {cfg}", file=sys.stderr)
    t0 = time.perf_counter()
    cached_freq = bool(args.use_freq and args.dataset_dir
                       and os.path.exists(os.path.join(args.dataset_dir, "id_freq_map.npy")))
    if mesh is not None and mesh.rank != 0:
        dist.barrier(group=mesh.host_group)  # rank 0 counts and writes id_freq_map.npy first
    freq = get_freq(args, cfg)
    if mesh is not None and mesh.rank == 0:
        dist.barrier(group=mesh.host_group)
    freq_s = time.perf_counter() - t0
    if freq is not None:
        print(f"id_freq_map: {'loaded' if cached_freq else 'computed'} in {freq_s:.2f} s", file=sys.stderr)
    if args.use_tablewise:
        return run_hybrid(args, cfg, freq, device, mesh, freq_s)
    if args.use_rowwise:
        return run_rowwise(args, cfg, freq, device, mesh, freq_s)
    if mesh is not None and mesh.size == 1:
        mesh = None  # one rank trains as one device, as the JAX CLI's one-device run does
    if mesh is not None:
        print(f"mesh: {mesh.size} devices, column-wise hybrid", file=sys.stderr)

    trainer = build_trainer(args, cfg, freq, device, mesh)
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
    if args.profile_dir and (mesh is None or mesh.rank == 0):
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
                window_plan_device_s=[x for r in parts for x in r.window_plan_device_s],
                window_readback=[x for r in parts for x in r.window_readback],
                window_spans=[x for r in parts for x in r.window_spans],
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
        "span_ms_per_window": median_ms([x for r in reports for x in r.window_spans]),
        "h2d_bytes": trainer.embed.stats.h2d_bytes,
        "d2h_bytes": trainer.embed.stats.d2h_bytes,
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


# flags that --use_tablewise reads nowhere, as JAX's run_hybrid reads none of them
TABLEWISE_IGNORES = ("model", "cache_dtype", "embedding_optimizer", "transfer_dtype", "stochastic_rounding",
                     "planner", "use_sparse_embed_grad", "fused_op", "checkpoint_dir", "profile_dir", "inspect_time",
                     "validation_freq_within_epoch")


# flags that --use_rowwise reads nowhere, as JAX's run_rowwise reads none of them
ROWWISE_IGNORES = ("cache_dtype", "embedding_optimizer", "adagrad_eps", "stochastic_rounding", "planner",
                   "use_sparse_embed_grad", "compute_dtype", "fused_op", "checkpoint_dir", "profile_dir",
                   "inspect_time", "validation_freq_within_epoch")


def note_ignored_flags(args, layout: str, ignores, why: str) -> None:
    """Print one stderr line naming the flags of ``ignores`` that were set
    to other than their defaults, where there are any."""
    defaults = vars(parse_args([]))
    set_ = [f"--{k} {getattr(args, k)}" for k in ignores if getattr(args, k) != defaults[k]]
    if set_:
        print(f"{layout} ignores {', '.join(set_)}: {why}", file=sys.stderr)


def run_hybrid(args, cfg, freq, device, mesh=None, freq_s: Optional[float] = None) -> dict:
    """``--use_tablewise``: the table-wise layout over ``mesh`` (where it is
    None, a mesh of one rank, made here and destroyed at the end unless a
    process group was there already), trained window by window (each window planned once on every rank and trained
    step by step), with val and test AUROC and accuracy after each epoch,
    printed in the JAX CLI's words. Returns the model (still open), the
    losses, each epoch's metrics and the numbers of its ``run stats``
    line."""
    import torch
    import torch.distributed as dist

    from cachedembedding_tpu_torch.models.hybrid import HybridParallelDLRM
    from cachedembedding_tpu_torch.ops import launch_counts
    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics
    from cachedembedding_tpu_torch.utils.misc import get_mem_info

    own_mesh = mesh is None and not dist.is_initialized()
    if mesh is None:
        mesh = make_mesh(1, device.type)
    try:
        note_ignored_flags(args, "--use_tablewise", TABLEWISE_IGNORES, "it trains DLRM towers with plain SGD on f32 "
                           "cache rows and f32 admits, as the JAX CLI's run_hybrid does")
        n = mesh.size
        print(f"mesh: {n} devices, tablewise hybrid", file=sys.stderr)
        model = HybridParallelDLRM(cfg, mesh=mesh, id_freq_map=freq)
        print(model.model_stats("HybridParallelDLRM"), file=sys.stderr)
        print(f"table filled in {model.embed.table_init_s:.2f} s", file=sys.stderr)
        print(get_mem_info("after model init", device), file=sys.stderr)
        offsets = np.concatenate([[0], np.cumsum(cfg.num_embeddings_per_feature)]).astype(np.int64)
        pn = max(1, cfg.cache.prefetch_num)
        cuda = device.type == "cuda"
        host_s: list = []
        events: list = []

        def ids_bf(b):
            f = b.sparse_features
            vals = np.asarray(f.values)
            return vals.reshape(f.num_features, f.batch_size).T - offsets[:-1][None, :]

        def fetch(it, k):
            out = []
            for _ in range(k):
                try:
                    out.append(next(it))
                except StopIteration:
                    break
            return out

        def run_windows(data, limit, train: bool, progress_total=None):
            """A windowed pass: (the per-step losses, or the metrics; the
            steps done)."""
            it = iter(data)
            metrics = StreamingMetrics()
            losses = []
            done = 0
            while True:
                th = time.perf_counter()
                want = pn if limit is None else min(pn, limit - done)
                if want <= 0:
                    break
                window = fetch(it, want)
                if not window:
                    break
                slot_ids, plans = model.embed.begin_prepare_window([ids_bf(b) for b in window])
                model.embed.finish_prepare(plans)
                dense_P = np.stack([np.asarray(b.dense_features) for b in window])
                if train:
                    lr = cfg.learning_rate
                    if progress_total and cfg.change_lr and done / max(progress_total, 1) >= cfg.lr_change_point:
                        lr = cfg.lr_after
                    lrs = [lr] * len(window)
                    labels_P = np.stack([np.asarray(b.labels) for b in window])
                    host_s.append(time.perf_counter() - th)
                    if cuda:
                        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    losses.append(model.train_window(dense_P, slot_ids, labels_P, lrs, lrs))
                    if cuda:
                        ev[1].record()
                        events.append(ev)
                else:
                    probs = model.eval_window(dense_P, slot_ids)
                    metrics.update(probs.reshape(-1).cpu().numpy(),
                                   np.concatenate([np.asarray(b.labels) for b in window]))
                done += len(window)
            if train:
                return (torch.cat(losses).cpu().tolist() if losses else []), done
            return metrics.compute(), done

        limit = args.limit_train_batches
        all_losses, epochs, examples_per_s = [], [], []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            train_losses, n_it = run_windows(get_data(args, cfg, "train"), limit, train=True, progress_total=limit)
            dt = time.perf_counter() - t0
            all_losses += train_losses
            examples_per_s.append(n_it * cfg.batch_size / dt)
            print(f"hybrid[{n}dev,tablewise] epoch {epoch}: {n_it} iters in {dt:.0f}s "
                  f"({n_it / dt:.2f} it/s, {n_it * cfg.batch_size / dt:.0f} ex/s), "
                  f"final loss={train_losses[-1]:.5f}" if train_losses else "no data")
            model.embed.print_comm_stats()
            metrics = {}
            for stage, lim in [("val", args.limit_val_batches), ("test", args.limit_test_batches)]:
                m, _ = run_windows(get_data(args, cfg, stage), lim, train=False)
                metrics[stage] = m
                print(f"hybrid[{n}dev,tablewise] epoch {epoch} {stage}: "
                      f"auroc={m['auroc']:.9f} accuracy={m['accuracy']:.9f} over {m['count']}")
            epochs.append(metrics)
        if cuda:
            torch.cuda.synchronize(device)
        print(get_mem_info("after training", device), file=sys.stderr)
        stats = {
            "kernel_launches": launch_counts(),
            "table_init_s": model.embed.table_init_s,
            "freq_s": freq_s if freq is not None else None,
            "examples_per_s": examples_per_s,
            "losses": all_losses,
            "hit_rate": model.embed.stats.hit_rate(),
            "window_host_s": host_s,
            "window_device_s": [a.elapsed_time(b) / 1e3 for a, b in events],
            "peak_device_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "swap_in_bytes": model.embed.stats.swap_in_bytes,
            "swap_out_bytes": model.embed.stats.swap_out_bytes,
        }
        print(f"run stats: {json.dumps(stats)}", file=sys.stderr)
        return {"model": model, "metrics": epochs, **stats}
    finally:
        if own_mesh:
            destroy_mesh(mesh)


def run_rowwise(args, cfg, freq, device, mesh=None, freq_s: Optional[float] = None) -> dict:
    """``--use_rowwise``: the row-sharded cached layout over ``mesh`` (where
    it is None, a mesh of one rank, made here and destroyed at the end unless
    a process group was there already), as the JAX CLI's ``run_rowwise``:
    each window's ids routed to their owners' shards and planned once (every
    rank gets the global batch's ids), then trained step by step; each
    evaluation batch planned and scored alone; plain SGD on f32 cache rows
    with ``lr_at(i)`` as both learning rates, f32 dense inputs and compute.
    Prints the JAX CLI's lines. Returns the embedding and model (still
    open), the losses, each epoch's metrics and the numbers of its ``run
    stats`` line."""
    import torch
    import torch.distributed as dist

    from cachedembedding_tpu_torch.cache.state import EvictionStrategy
    from cachedembedding_tpu_torch.models.deepfm import DeepFM
    from cachedembedding_tpu_torch.models.dlrm import DLRM
    from cachedembedding_tpu_torch.ops import launch_counts
    from cachedembedding_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    from cachedembedding_tpu_torch.parallel.row_cached import (
        RowShardedCachedEmbeddingBag,
        build_rowwise_cached_step,
        build_rowwise_cached_window,
    )
    from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics
    from cachedembedding_tpu_torch.utils.misc import get_mem_info

    own_mesh = mesh is None and not dist.is_initialized()
    if mesh is None:
        mesh = make_mesh(1, device.type)
    try:
        note_ignored_flags(args, "--use_rowwise", ROWWISE_IGNORES, "it trains with plain SGD on f32 cache rows "
                           "and f32 compute, as the JAX CLI's run_rowwise does")
        n, c, dev = mesh.size, cfg.cache, mesh.device
        print(f"mesh: {n} devices, rowwise cached", file=sys.stderr)
        embed = RowShardedCachedEmbeddingBag(
            cfg.total_num_embeddings, cfg.embedding_dim, mesh=mesh, cache_ratio=c.cache_ratio,
            ids_freq_mapping=freq if c.use_freq else None, warmup_ratio=c.warmup_ratio, buffer_size=c.buffer_size,
            evict_strategy=(EvictionStrategy.DATASET if not c.use_lfu_eviction and c.use_freq and freq is not None
                            else EvictionStrategy.LFU),
            seed=cfg.seed, weight_init=c.weight_init if c.weight_init != "virtual" else "uniform",
            transfer_dtype=c.transfer_dtype,
        )
        F, Din = cfg.num_sparse_features, cfg.dense_in_features
        if cfg.model == "deepfm":
            net = DeepFM(cfg.embedding_dim, F, Din, hidden_layer_size=cfg.dense_arch_layer_sizes[0],
                         deep_fm_dimension=cfg.deep_fm_dimension, seed=cfg.seed, device=dev)
        else:
            net = DLRM(cfg.embedding_dim, F, Din, cfg.dense_arch_layer_sizes, cfg.over_arch_layer_sizes,
                       seed=cfg.seed, device=dev)
        print(f"table filled in {embed.table_init_s:.2f} s", file=sys.stderr)
        print(get_mem_info("after model init", device), file=sys.stderr)
        kw = dict(num_features=F, global_batch=cfg.batch_size, pooling=1, capacity=embed.capacity, model=cfg.model)
        window_step = build_rowwise_cached_window(mesh, **kw)
        score = build_rowwise_cached_step(mesh, train=False, **kw)
        B_local = cfg.batch_size // n
        me = slice(mesh.rank * B_local, (mesh.rank + 1) * B_local)
        pn = max(1, c.prefetch_num)
        cuda = dev.type == "cuda"
        host_s: list = []
        events: list = []

        def per_rank_ids(batch):
            fb = np.asarray(batch.sparse_features.values).reshape(F, cfg.batch_size, -1)
            return np.stack([fb[:, r * B_local: (r + 1) * B_local].reshape(-1) for r in range(n)])

        def to_dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        def run_stage(stage, limit, train: bool, progress_total=None):
            """A pass: (the per-step losses, or the metrics; the steps done)."""
            metrics = StreamingMetrics()
            losses, done = [], 0
            it = iter(get_data(args, cfg, stage))

            def lr_at(i):
                if progress_total and cfg.change_lr and i / max(progress_total, 1) >= cfg.lr_change_point:
                    return cfg.lr_after
                return cfg.learning_rate

            while limit is None or done < limit:
                th = time.perf_counter()
                if train:
                    window = []
                    for _ in range(pn if limit is None else min(pn, limit - done)):
                        try:
                            window.append(next(it))
                        except StopIteration:
                            break
                    if not window:
                        break
                    P = len(window)
                    ids = np.stack([per_rank_ids(b) for b in window])  # (P, W, L)
                    enc = embed.prepare_ids_per_rank(ids.transpose(1, 0, 2).reshape(n, -1))
                    enc = enc.reshape(n, P, -1)[mesh.rank]  # this rank's (P, L)
                    dense = np.stack([np.asarray(b.dense_features, np.float32)[me] for b in window])
                    labels = np.stack([np.asarray(b.labels, np.float32)[me] for b in window])
                    lrs = [lr_at(done + i) for i in range(P)]
                    host_s.append(time.perf_counter() - th)
                    if cuda:
                        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    losses.append(window_step(net, embed.global_cache(), to_dev(enc), to_dev(dense), to_dev(labels),
                                              lrs, lrs))
                    if cuda:
                        ev[1].record()
                        events.append(ev)
                    done += P
                else:
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    enc = embed.prepare_ids_per_rank(per_rank_ids(batch))[mesh.rank]
                    probs = score(net, embed.global_cache(), to_dev(enc),
                                  to_dev(np.asarray(batch.dense_features, np.float32)[me]))
                    metrics.update(probs.reshape(-1).cpu().numpy(), np.asarray(batch.labels))
                    done += 1
            if train:
                return (torch.cat(losses).cpu().tolist() if losses else []), done
            return metrics.compute(), done

        limit = args.limit_train_batches
        all_losses, epochs, examples_per_s = [], [], []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            train_losses, n_it = run_stage("train", limit, True, progress_total=limit)
            dt = time.perf_counter() - t0
            all_losses += train_losses
            examples_per_s.append(n_it * cfg.batch_size / dt)
            msg = (f"rowwise[{n}dev] epoch {epoch}: {n_it} iters in {dt:.0f}s "
                   f"({n_it / dt:.2f} it/s, {n_it * cfg.batch_size / dt:.0f} ex/s)")
            if train_losses:
                msg += f", final loss={train_losses[-1]:.5f}"
            print(msg)
            print(embed.aggregate_stats().summary())
            metrics = {}
            for stage, lim in [("val", args.limit_val_batches), ("test", args.limit_test_batches)]:
                m, _ = run_stage(stage, lim, False)
                metrics[stage] = m
                print(f"rowwise[{n}dev] epoch {epoch} {stage}: "
                      f"auroc={m['auroc']:.9f} accuracy={m['accuracy']:.9f} over {m['count']}")
            epochs.append(metrics)
        if cuda:
            torch.cuda.synchronize(dev)
        print(get_mem_info("after training", device), file=sys.stderr)
        st = embed.aggregate_stats()
        stats = {
            "kernel_launches": launch_counts(),
            "table_init_s": embed.table_init_s,
            "freq_s": freq_s if freq is not None else None,
            "examples_per_s": examples_per_s,
            "losses": all_losses,
            "hit_rate": st.hit_rate(),
            "window_host_s": host_s,
            "window_device_s": [a.elapsed_time(b) / 1e3 for a, b in events],
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "swap_in_bytes": st.swap_in_bytes,
            "swap_out_bytes": st.swap_out_bytes,
        }
        print(f"run stats: {json.dumps(stats)}", file=sys.stderr)
        return {"embed": embed, "model": net, "metrics": epochs, **stats}
    finally:
        if own_mesh:
            destroy_mesh(mesh)


if __name__ == "__main__":
    main()
