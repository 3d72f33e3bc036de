#!/usr/bin/env python3
"""Host time of the port's update plan (``hostops.sort_plan``) in two trees,
on the same ids.

    python3 plan_ab.py OTHER_TREE [ITERS]

Builds the first window of ``chip_smoke.py``'s bf16 slice on the CPU with
this checkout (8 steps of 26 x 16,384 slot ids into 901,228 device rows, in
the trainer's (N, F) stream order), then times ``sort_plan`` of this checkout
and of OTHER_TREE (another commit's checkout, for example unpacked with
``git archive`` under ``cachedembedding_tpu_torch/build/``) on those ids, each
in its own process, in turns A, B, B, A. Each turn plans the window's 8 steps
ITERS times (default 10), over the slice's device rows, and its global ids
over the 33,762,577 rows of the fully resident Criteo-Kaggle table (what the
resident path plans).
Prints a JSON line per turn, then one with each tree's median ms per step
over its turns, by row count. Needs no GPU; each tree builds its host
library at first use.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BLOCK_ROWS = 64
RESIDENT_ROWS = 33_762_577  # the Criteo-Kaggle table, whole on the device


def first_window(path: Path) -> int:
    """Save the bf16 slice's first window of update streams, (2, 8, L)
    int32: its device addresses, then its global ids, to ``path``; returns
    the device row count the addresses index."""
    import numpy as np

    from chip_smoke import slice_config
    from cachedembedding_tpu_torch.data.synthetic import SyntheticLongTailDataset
    from cachedembedding_tpu_torch.train.trainer import CachedDLRMTrainer

    cfg = slice_config("bfloat16")
    P, F = cfg.cache.prefetch_num, cfg.num_sparse_features
    train = SyntheticLongTailDataset(cfg.num_embeddings_per_feature, cfg.batch_size, 24, skew=0.5, seed=7)
    tr = CachedDLRMTrainer(cfg, id_freq_map=train.id_freq_map(), device="cpu")
    batches = [b for _, b in zip(range(P), train)]
    win = tr._begin_window(batches, with_plan=False)
    streams = np.stack([[s.reshape(F, -1).T.reshape(-1) for s in ids] for ids in
                        (win.slot_ids.numpy(), [b.sparse_features.values.numpy() for b in batches])])
    rows = tr.embed.device_rows
    tr.close()
    np.save(path, streams)
    return rows


def time_tree(tree: str, ids_path: str, num_rows: int, iters: int) -> None:
    """Child process: median ms of ``tree``'s ``sort_plan`` per step, on the
    device addresses over ``num_rows`` rows and on the global ids over
    RESIDENT_ROWS rows."""
    sys.path.insert(0, tree)
    import numpy as np

    from cachedembedding_tpu_torch._native import hostops

    if not Path(hostops.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {hostops.__file__}, not {tree}'s")
    hostops.load_lib()
    windows = np.load(ids_path)
    medians = {}
    for rows, streams in zip((num_rows, RESIDENT_ROWS), windows):
        times = []
        for _ in range(iters):
            for v in streams:
                t0 = time.perf_counter()
                hostops.sort_plan(v, rows, BLOCK_ROWS)
                times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        medians[rows] = times[len(times) // 2]
    print(json.dumps({"tree": tree, "median_ms": medians, "plans": len(times)}))


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        time_tree(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
        return 0
    other = str(Path(sys.argv[1]).resolve())
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    ids_path = HERE / "cachedembedding_tpu_torch" / "build" / "plan_ab_ids.npy"
    ids_path.parent.mkdir(parents=True, exist_ok=True)
    rows = first_window(ids_path)
    medians = {str(HERE): {}, other: {}}
    for tree in (str(HERE), other, other, str(HERE)):
        out = subprocess.run(
            [sys.executable, __file__, "--child", tree, str(ids_path), str(rows), str(iters)],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        for n, ms in json.loads(out)["median_ms"].items():
            medians[tree].setdefault(n, []).append(ms)
    ids_path.unlink()
    print(json.dumps({"median_ms_per_step": medians, "device_rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
