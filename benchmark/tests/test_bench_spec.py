"""BENCHMARK.json and the files it names: each found by name, each within
the limits that the benchmark's format sets."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_budget():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full regression check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads_by_name(entry):
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and NAME.match(entry["name"])
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert spec.load_module("rooflines", entry["name"]).bound_s_per_step


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_loads_by_name(entry):
    cell = spec.cell(entry["name"])
    assert NAME.match(entry["name"]) and entry["chips"] in (1, 4)
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
    wl = cell["workload"]
    assert wl["check"]["samples"] < wl["check"]["span"]


def test_four_card_cells_within_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_file_loads_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.load_module("metrics", metric["name"]).read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")


def test_one_layer_name_a_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
