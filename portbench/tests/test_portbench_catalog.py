"""BENCHMARK.json against the benchmark's files, and the traffic kinds."""

import json
import re

import numpy as np
import pytest

from portbench import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_units_and_readers(m):
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(catalog.module("metrics", m["name"]).read)
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if "moves" in m:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=CELLS)
def test_cells_name_known_files(w):
    cell = catalog.cell(w["name"])
    assert cell["name"] == w["name"] and cell["config"] == w["config"]
    config = catalog.config(cell["config"])
    assert (catalog.config_dir() / config["plan"]).is_file()
    assert callable(catalog.module("kinds", config["kind"]).System)
    traffic = catalog.module("traffic", cell["traffic"]["kind"])
    assert callable(traffic.plan) and callable(traffic.drive)
    assert w["traffic"].startswith(cell["traffic"]["kind"])
    end_to_end = catalog.metrics_for(BENCH, w["name"], False)
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    assert catalog.metrics_for(BENCH, w["name"], True)


@pytest.mark.parametrize("c", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configs_files(c):
    path = catalog.ROOT / c["file"]
    config = json.loads(path.read_text())
    assert config["name"] == c["name"] and config["source"]
    assert sorted(config["reduced"]) == sorted(c["reduced"])
    assert c["name"] in {w["config"] for w in BENCH["workloads"]}


def test_traffic_is_reproducible_and_differs_by_seed():
    traffic = catalog.module("traffic", "closed")
    a = traffic.plan({"clients": 8}, 2 ** 31 + 12345, 5.0, 64)
    b = traffic.plan({"clients": 8}, 2 ** 31 + 12345, 5.0, 64)
    c = traffic.plan({"clients": 8}, 7, 5.0, 64)
    assert np.array_equal(a["order"], b["order"])
    assert not np.array_equal(a["order"], c["order"])
    assert sorted(a["order"]) == list(range(64))
