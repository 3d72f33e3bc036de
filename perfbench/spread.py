"""Repeated runs of one cell, each a process of its own as the benchmark's
command runs it, and the spread of each metric: the distance between the
first and third quartiles as a share of the median, from which the
end-to-end bounds are set (``stats.spread``).

    python3 perfbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        --seconds 51 [--trace 0|1] [--out FILE]

Each run's result line (and its last lines of standard error) are appended
to ``--out``; the summary goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import stats  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=[0, 1])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    results = []
    for s in a.seeds.split(","):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", a.workload, "--seed", s,
                               "--seconds", str(a.seconds), "--trace", str(a.trace)],
                              cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        rec = {"seed": int(s), "rc": proc.returncode, "wall_s": wall, "result": res,
               "stderr_tail": proc.stderr[-3000:]}
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        brief = {k: v["value"] for k, v in res["metrics"].items()} if res else None
        print(json.dumps({"seed": int(s), "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": res and res["correct"], "metrics": brief}), flush=True)
        if res is None:
            print(proc.stderr[-3000:], file=sys.stderr)
        results.append(res)
    ok = [r for r in results if r]
    if len(ok) >= 2:
        for name in ok[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            sp = stats.spread(vals) if len(vals) >= 2 else float("nan")
            print(f"{a.workload} {name}: median {statistics.median(vals):.6g}, spread {sp:.4f}, "
                  f"values {[round(v, 6) for v in vals]}")
    return 0 if len(ok) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
