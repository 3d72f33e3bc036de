"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names the cells and metrics; each configuration, traffic mix, cell limit
and per-layer metric is a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix's stream parameters (``traffic.py``);
* ``limits/<cell>.json``: the limit of each number that decides ``correct``;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` list and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
