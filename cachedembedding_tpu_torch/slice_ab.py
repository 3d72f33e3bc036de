"""Compare one training slice of two checkouts of the port on the card.

    python3 cachedembedding_tpu_torch/slice_ab.py OTHER_TREE [--dtype float8_e4m3fn]

Runs ``chip_smoke.py``'s headline slice (``slice_config``) with the given
cache dtype for the checkout around this file (B) and for OTHER_TREE (A),
one process each, in turns A B B A, on one card: each builds its own
kernels, trains 24 steps, reads its device s/window (CUDA events) and its
peak device memory, and trains two more windows under torch.profiler
(``profile_window``: device busy time, idle share, heaviest kernels). Prints
one ``AB {...}`` JSON line per turn. Unpack the other tree with ``git
archive`` into a directory that ``.gitignore`` lists.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

STEPS = 24


def profile_window(tr, cfg, data=None) -> dict:
    """Train one more window of ``tr`` (on ``data``, a window of batches, or
    the slice's synthetic stream) under torch.profiler and return its
    device busy time (the union of its kernels' and copies' intervals), the
    span from the first to the last of them, the idle share of that span,
    and the device ms of its heaviest kernels, a window's total. Profiling
    slows the host's launches, so the span and idle share are upper bounds
    for an unprofiled window; the busy time is not affected."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset

    P = cfg.cache.prefetch_num
    if data is None:
        data = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, P, skew=0.5, seed=9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train(data, num_iters=P)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    by_name = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3, "idle_share": 1 - busy / span if span else None,
            "kernels": len(spans), "top_ms": {k[:60]: v for k, v in top}}


def run_one(tree: str, dtype: str) -> dict:
    """One turn, in its own process: the slice of the checkout at ``tree``."""
    sys.path.insert(0, tree)
    import torch

    import cachedembedding_tpu_torch
    import chip_smoke
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    if not cachedembedding_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {cachedembedding_tpu_torch.__file__}, not the port under {tree}")
    device = torch.device("cuda", 0)
    chip_smoke.phase_build()
    cfg = chip_smoke.slice_config(dtype)
    train = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, STEPS, skew=0.5, seed=7)
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    rep = tr.train(train, num_iters=STEPS)
    peak = torch.cuda.max_memory_allocated(device)
    profiled = [profile_window(tr, cfg) for _ in range(2)]
    tr.close()
    return {"device_s": rep.window_device_s, "host_s": rep.window_host_s, "examples_per_s": rep.examples_per_s,
            "peak_gib": peak / 2**30, "last_loss": rep.losses[-1], "profiled": profiled}


def main() -> int:
    args = sys.argv[1:]
    dtype = "float8_e4m3fn"
    if "--dtype" in args:
        i = args.index("--dtype")
        dtype = args[i + 1]
        del args[i:i + 2]
    if args[:1] == ["--run"]:
        print("AB " + json.dumps({"tree": args[1], "dtype": dtype, **run_one(os.path.abspath(args[1]), dtype)}),
              flush=True)
        return 0
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree, "--dtype", dtype],
                              cwd=tree, capture_output=True, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
