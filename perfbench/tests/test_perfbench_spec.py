"""The harness finds every part of a cell by name from BENCHMARK.json."""

import pytest

from perfbench import check, spec
from perfbench.program import dlrm_config

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    config, mix, limits = spec.config(w["config"]), spec.mix(w["traffic"]), spec.limits(cell)
    assert config["name"] == w["config"] and mix["name"] == w["traffic"]
    assert set(limits) - {"set_from"} == set(check.numbers_of(config))
    cfg = dlrm_config(config, mix, 2**31 + 5)
    assert cfg.batch_size == mix["batch_size"] and cfg.seed == (2**31 + 5) & 0xFFFFFFFF
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"perfbench/configs/{w['config']}.json"
    assert callable(spec.reference(config).logits)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("cell", CELLS)
def test_cells_report_what_their_metrics_move(cell):
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(BENCH, cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


def test_missing_parts_are_refused():
    with pytest.raises(KeyError):
        spec.workload(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_a_configuration_names_its_reference():
    from perfbench.reference import dlrm

    assert spec.reference({}) is dlrm  # none named: DLRM's
    assert spec.reference({"reference": "dlrm"}) is dlrm
    assert set(dlrm.dense_shapes(spec.config("dlrm-criteo-kaggle-cached")["dlrm"])) >= {"over_arch.4.bias"}
    for unknown in ("no_such_model", "../run", "dlrm.py"):
        with pytest.raises(FileNotFoundError):
            spec.reference({"reference": unknown})
    with pytest.raises(ValueError):  # a module of the reference that is no model
        spec.reference({"reference": "training"})
