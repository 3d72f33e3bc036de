"""Readings that set a cell's limits: the numbers ``check.py`` compares, for
the sound program, the control and the planted faults, over many seeds at
the cell's own size. The benchmark's runs never run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--mode sound|control|<fault>] [--out FILE]

Each seed runs the cell as ``run.py`` does, with the fault or the control
planted, and a timed call just long enough for the check's stretch; one
JSON line a seed, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import faults, run, spec  # noqa: E402


def readings(cell: str, seed: int, mode: str, device: torch.device, config=None, mix=None, limits=None,
             warmup_iters=None) -> dict:
    """One seed's readings of ``cell`` in ``mode``: a run of the cell as
    ``run.py`` makes it, with a timed call just long enough for the check's
    stretch; the sound program's also carry the witness
    (``run.compare``)."""
    w = spec.workload(spec.load_benchmark(), cell)
    config = config or spec.config(w["config"])
    if mode == "control":
        config = faults.control_config(config)
    plant = faults.FAULTS[mode]() if mode in faults.FAULTS else contextlib.nullcontext()
    with plant:
        out, read = run.run_cell(cell, seed, 0.0, False, device, config=config, mix=mix, limits=limits,
                                 warmup_iters=warmup_iters, witness=mode == "sound")
    keep = {k: v for k, v in read.items() if not k.startswith("losses")}
    return {"cell": cell, "mode": mode, "seed": seed, "correct": out["correct"], **keep}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", default="sound", choices=["sound", "control", *faults.FAULTS])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    for s in a.seeds.split(","):
        t = time.perf_counter()
        r = readings(a.workload, int(s), a.mode, device)
        r["seconds"] = time.perf_counter() - t
        line = json.dumps(r)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
