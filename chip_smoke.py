#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``cachedembedding_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100 is the target) and the checkout around this file;
it imports torch, numpy and the port, nothing of JAX. Phases:

  1. Build: the host C++ library (g++) and each CUDA kernel (nvcc, sm_90a),
     all started together, from the sources in the checkout into
     ``cachedembedding_tpu_torch/build/``.
  2. Reference: the slice at a small f32 width, trained 6 windows and
     evaluated on the card and on the CPU (the kernels' plain versions) from
     the same seed; cache counts equal, losses, AUROC and dense weights within
     f32 order, and the flushed rows of every id the training stream touched
     within 1e-5, among them rows that were trained, evicted and admitted
     again (which holds the writeback ordering to account).
  3. The slice: bench.py's headline configuration (Criteo-Kaggle tables,
     D=128, batch 16,384, 1% cache, prefetch 8, bf16 rows and compute,
     resident tables <= 500k rows) with ship_sort_perm and the gather lookup
     on: build the trainer, train 3 windows (24 steps), evaluate 1 window,
     flush, and check flushed rows against the cache rows they came from.
     Kernel launch counts are zeroed just before and read just after.
  4. Kernels against their plain PyTorch versions on the slice's own first
     training step (its device addresses and its grouping plan, 26 x 16,384
     ids into 901,228 x 128 bf16 rows): the row gather must equal
     index_select bit for bit; the fused binned SGD update must leave
     untouched rows bit-equal, keep touched rows within one bf16 ulp of the
     plain version, and give identical bits on two launches. Median times
     beside each kernel's bound and yardsticks.

Prints per-phase results, then the card's name and power limit, then a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
ITERS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build() -> None:
    from cachedembedding_tpu_torch._native import hostops
    from cachedembedding_tpu_torch.ops import _cuda

    jobs = {"libhostops (g++)": hostops.build_lib}
    for name in _cuda.SOURCES:
        jobs[f"{name} (nvcc sm_90a)"] = lambda name=name: _cuda.build_kernel(name)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        for k, fut in futs.items():
            path, secs, out = fut.result()
            log(f"[build] {k}: {secs:.1f} s -> {path.name}")
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    log(f"[build]   {line.strip()}")


def slice_config():
    from cachedembedding_tpu_torch.config import (
        CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
        CacheConfig,
        DLRMConfig,
    )

    return DLRMConfig(
        num_embeddings_per_feature=CRITEO_KAGGLE_NUM_EMBEDDINGS_PER_FEATURE,
        embedding_dim=128,
        dense_in_features=13,
        dense_arch_layer_sizes=(512, 256, 128),
        over_arch_layer_sizes=(1024, 1024, 512, 256, 1),
        batch_size=16384,
        learning_rate=1.0,
        compute_dtype="bfloat16",
        dense_input_dtype="bfloat16",
        cache=CacheConfig(
            cache_ratio=0.01, warmup_ratio=0.7, prefetch_num=8, buffer_size=0,
            use_lfu_eviction=False, weight_init="virtual", transfer_dtype="bfloat16",
            cache_dtype="bfloat16", resident_threshold=500_000,
            ship_sort_perm=True, use_pallas_lookup=True,
        ),
    )


def _ulp_bf16(x):
    import torch

    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def phase_kernels(cfg, tr, win) -> list:
    """Hold both kernels against their plain versions on the first training
    step of the slice: its device addresses, its grouping plan and the
    trained cache rows (cloned, so the trainer's state is not touched)."""
    import torch

    from cachedembedding_tpu_torch.ops.binned_scatter import (
        BLOCK_ROWS,
        binned_sgd_update,
        binned_sgd_update_plain,
    )
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

    F, D, B = cfg.num_sparse_features, cfg.embedding_dim, cfg.batch_size
    ids = win.slot_ids[0]
    perm, grouped, bins = (a[0] for a in win.plan)
    L = ids.shape[0]
    cw = tr.embed.cache_weight.clone()
    C = cw.shape[0]
    device = cw.device
    gen = torch.Generator(device=device).manual_seed(0)
    row_bytes = D * cw.element_size()
    results = []

    # ---- Kernel 1: the row gather ----
    out = gather_rows(cw, ids, F)
    ids_nf = ids.reshape(F, B).t().reshape(-1).long()  # the output's row order
    plain = gather_rows_plain(cw, ids, F)
    lib = torch.index_select(cw, 0, ids_nf).reshape(B, F, D)
    torch.cuda.synchronize()
    if not (torch.equal(out, plain) and torch.equal(out, lib)):
        raise AssertionError("gather_rows kernel differs from index_select")
    err = (out.float() - plain.float()).abs().max().item()
    # the least traffic: the ids, each distinct row read once, the output written
    n_distinct = int(torch.unique(ids).numel())
    k1 = dict(
        name="gather_rows", route="cuda",
        source="cachedembedding_tpu_torch/csrc/gather_rows.cu",
        replaces="cachedembedding_tpu/ops/pallas_bag.py:29",
        max_abs_err=err,
        ms=median_ms(lambda: gather_rows(cw, ids, F)),
        plain_ms=median_ms(lambda: gather_rows_plain(cw, ids, F)),
        bound_ms=(L * 4 + (n_distinct + L) * row_bytes) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=median_ms(lambda: torch.index_select(cw, 0, ids_nf)),
        tolerance="bit-exact",
    )
    log(f"[kernel] gather_rows: {n_distinct} distinct rows, equal to index_select; {json.dumps(k1)}")
    results.append(k1)
    del out, plain, lib

    # ---- Kernel 2: the fused binned SGD update ----
    slr = cfg.learning_rate
    g = (1e-3 * torch.randn((L, D), generator=gen, device=device)).to(torch.bfloat16)  # stream order (B, F)
    a = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
    b = binned_sgd_update(cw.clone(), g, perm, grouped, bins, slr)
    ref = binned_sgd_update_plain(cw.clone(), g, perm, grouped, bins, slr)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("binned_sgd kernel is not deterministic across launches")
    touched = torch.zeros(C, dtype=torch.bool, device=device)
    touched[ids.long()] = True
    n_touched = int(touched.sum())
    if not torch.equal(a[~touched], cw[~touched]):
        raise AssertionError("binned_sgd kernel changed untouched rows")
    at, rt = a[touched].float(), ref[touched].float()
    diff = (at - rt).abs()
    # one bf16 ulp of the result, plus f32 rounding of the O(0.1) terms where
    # cw - slr*acc cancels towards zero
    tol = _ulp_bf16(torch.maximum(at.abs(), rt.abs())) + 1e-6
    if bool((diff > tol).any()):
        raise AssertionError(f"binned_sgd kernel off by {diff.max().item()} > one bf16 ulp")
    sizes = torch.diff(bins)
    top = torch.topk(sizes, 5)
    heavy = [(int(n), int(b) * BLOCK_ROWS) for n, b in zip(top.values, top.indices)]
    cw_t = cw.clone()
    cw_l = cw.clone()
    bytes2 = L * row_bytes + 2 * L * 4 + bins.numel() * 4 + 2 * n_touched * row_bytes
    k2 = dict(
        name="binned_sgd", route="cuda",
        source="cachedembedding_tpu_torch/csrc/binned_sgd.cu",
        replaces="cachedembedding_tpu/ops/binned_scatter.py:199",
        max_abs_err=diff.max().item(),
        ms=median_ms(lambda: binned_sgd_update(cw_t, g, perm, grouped, bins, slr)),
        plain_ms=median_ms(lambda: binned_sgd_update_plain(cw_t, g, perm, grouped, bins, slr)),
        bound_ms=bytes2 / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        # rounds each addend to bf16: a different result, timed as a yardstick
        library_ms=median_ms(lambda: cw_l.index_add_(0, ids_nf, g, alpha=-slr)),
        tolerance="untouched bit-equal; touched within one bf16 ulp (+1e-6 abs)",
    )
    log(f"[kernel] binned_sgd: {n_touched} touched rows; heaviest bins (ids, first row) {heavy}, "
        f"cache slots below row {tr.embed.capacity}; two launches bit-identical; {json.dumps(k2)}")
    results.append(k2)
    return results


def phase_reference(device) -> None:
    """The slice at a small width with f32 rows and compute, once on the card
    (through the kernels) and once on the CPU (through their plain versions),
    on the same seeded stream. Cache counts must be equal; losses, AUROC and
    the dense weights may differ only by f32 sum order (rtol 1e-4, AUROC
    within 1e-4), and the flushed rows of every id the training stream
    touched by 1e-5 (as the CPU tests hold the port against the JAX package).
    Six windows through a cache of 480 slots evict trained rows and admit
    them again, so a writeback that read a slot out of order (before the
    previous window's update, or after this window's admits) would show."""
    import numpy as np

    from cachedembedding_tpu_torch.config import CacheConfig, DLRMConfig
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    tables = [50, 300, 4000, 20000]
    steps, P = 24, 4
    cfg = DLRMConfig(
        num_embeddings_per_feature=tables, embedding_dim=16, dense_in_features=13,
        dense_arch_layer_sizes=(32, 16), over_arch_layer_sizes=(64, 32, 1),
        batch_size=256, learning_rate=1.0, compute_dtype="float32",
        cache=CacheConfig(
            cache_ratio=0.02, resident_threshold=500, prefetch_num=P, weight_init="virtual",
            ship_sort_perm=True, use_pallas_lookup=True, cache_dtype="float32",
        ),
    )
    train = SyntheticLongTailDataset(tables, 256, steps, dense_in_features=13, skew=0.5, seed=7)
    test = SyntheticLongTailDataset(tables, 256, 4, dense_in_features=13, skew=0.5, seed=99)
    batches = list(train)
    touched = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in batches]))
    first = np.unique(np.concatenate([b.sparse_features.values.numpy() for b in batches[:P]]))
    runs = []
    for dev in (device, "cpu"):
        tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=dev)
        rep = tr.train(batches, num_iters=steps)
        emb = tr.embed
        # trained in the first window, written back on eviction, and in the
        # cache again at the end: evicted and admitted again
        emb._drain_writebacks()
        _, cached_rows = emb._dir.resident()
        again = first[emb.host_table.written_mask(first) & np.isin(first, cached_rows)]
        ev = tr.evaluate(test)
        s = emb.stats
        counts = (s.num_hits_history, s.num_miss_history, s.num_write_back_history)
        weights = [p.detach().cpu().numpy() for p in tr.model.parameters()]
        rows = emb.dense_weight(touched)
        tr.close()
        runs.append((np.asarray(rep.losses), ev["auroc"], counts, weights, rows, again))
    (lg, ag, cg, wg, rg, xg), (lc, ac, cc, wc, rc, xc) = runs
    if cg != cc:
        raise AssertionError(f"cache counts differ between the card and the CPU: {cg} vs {cc}")
    if not np.array_equal(xg, xc) or xg.size == 0:
        raise AssertionError(f"no trained row was evicted and admitted again ({xg.size} vs {xc.size})")
    if lg.shape != (steps,) or not np.allclose(lg, lc, rtol=1e-4, atol=0):
        raise AssertionError(f"losses differ between the card and the CPU: {lg} vs {lc}")
    if abs(ag - ac) > 1e-4:
        raise AssertionError(f"AUROC differs between the card and the CPU: {ag} vs {ac}")
    for a, b in zip(wg, wc):
        if not np.allclose(a, b, rtol=1e-4, atol=1e-7):
            raise AssertionError("dense weights differ between the card and the CPU")
    row_err = float(np.abs(rg - rc).max())
    if row_err > 1e-5:
        raise AssertionError(f"flushed rows differ between the card and the CPU by {row_err}")
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    log(f"[reference] small f32 slice, card vs CPU: counts equal, {sum(cg[2])} writebacks, "
        f"{xg.size} trained rows evicted and admitted again; {touched.size} trained rows "
        f"max abs diff {row_err:.2e}; loss max rel diff {rel:.2e}, auroc {ag:.6f} vs {ac:.6f}")


def phase_slice(cfg, device):
    """Drive the slice through its entry points with the launch counts
    zeroed just before. Returns the counts, the trainer (still open) and its
    first training window, which phase_kernels reads."""
    import numpy as np
    import torch

    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.ops.binned_scatter import binned_sgd_update
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    steps, P = 24, cfg.cache.prefetch_num
    sizes = cfg.num_embeddings_per_feature
    train = SyntheticLongTailDataset(sizes, cfg.batch_size, steps, skew=0.5, seed=7)
    test = SyntheticLongTailDataset(sizes, cfg.batch_size, P, skew=0.5, seed=8)
    t0 = time.perf_counter()
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    torch.cuda.synchronize()
    log(f"[slice] trainer built in {time.perf_counter() - t0:.1f} s: capacity "
        f"{tr.embed.capacity}, device rows {tr.embed.device_rows}")
    first = []
    begin = tr._begin_window

    def begin_and_keep(batches, with_plan=True):
        win = begin(batches, with_plan)
        if not first:
            first.append(win)
        return win

    tr._begin_window = begin_and_keep
    torch.cuda.reset_peak_memory_stats(device)
    gather_rows.launches = 0
    binned_sgd_update.launches = 0
    rep = tr.train(train, num_iters=steps)
    t1 = time.perf_counter()
    ev = tr.evaluate(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = {"gather_rows": gather_rows.launches, "binned_sgd": binned_sgd_update.launches}
    peak = torch.cuda.max_memory_allocated(device)
    losses = np.asarray(rep.losses)
    per_window = [float(x) for x in losses.reshape(-1, P).mean(axis=1)]
    log(f"[slice] loss per window {per_window}")
    log(f"[slice] hit rate {rep.hit_rate:.4f}; {rep.examples_per_s:.0f} examples/s "
        f"({rep.it_per_s:.2f} it/s) over {steps} steps; peak device memory {peak / 2**30:.2f} GiB")
    log(f"[slice] host s/window {[round(x, 4) for x in rep.window_host_s]}; "
        f"device s/window {[round(x, 4) for x in rep.window_device_s]}")
    log(f"[slice] eval of {ev['count']} examples in {eval_s:.2f} s: auroc {ev['auroc']:.4f}")
    log(f"[slice] kernel launches {launches}")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"losses not finite: {losses}")
    if not 0.0 < rep.hit_rate <= 1.0:
        raise AssertionError(f"hit rate {rep.hit_rate} outside (0, 1]")
    if launches["gather_rows"] < steps + P or launches["binned_sgd"] < steps:
        raise AssertionError(f"a kernel of the path did not run every step: {launches}")
    if ev["count"] != P * cfg.batch_size or not np.isfinite(ev["auroc"]):
        raise AssertionError(f"bad eval: {ev}")
    # flushed host rows must equal the cache rows they came from
    emb = tr.embed
    emb.flush()
    slots, rows = emb._dir.resident()
    pick = np.random.default_rng(0).choice(slots.shape[0], min(4096, slots.shape[0]), replace=False)
    res_pick = np.random.default_rng(1).choice(emb.resident_total, min(4096, emb.resident_total), replace=False)
    addrs = np.concatenate([slots[pick].astype(np.int64), emb.capacity + res_pick])
    host = emb.host_table.gather(np.concatenate([rows[pick], emb._res_rows[res_pick]]))
    dev = emb.cache_weight[torch.from_numpy(addrs).to(device)].float().cpu().numpy()
    if not np.array_equal(host, dev):
        raise AssertionError("flushed host rows differ from their cache rows")
    log(f"[slice] flush: {addrs.shape[0]} sampled rows equal their cache rows")
    return launches, tr, first[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cachedembedding_tpu_torch  # noqa: F401  (fails outside the checkout)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[build] done in {time.perf_counter() - t0:.1f} s; card: {smi}")
    cfg = slice_config()
    phase_reference(device)
    launches, tr, win = phase_slice(cfg, device)
    kernels = phase_kernels(cfg, tr, win)
    tr.close()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
