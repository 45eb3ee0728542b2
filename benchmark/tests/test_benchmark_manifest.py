"""BENCHMARK.json against the benchmark's contract, and every file it
names."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

from .conftest import SMALL_DIR

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert BENCH["command"][1].startswith("benchmark/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e["name"]


@pytest.mark.parametrize("group,name", list(_all_names()))
def test_names(group, name):
    assert NAME.match(name), name


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert set(m) <= METRIC_KEYS
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                       m["name"] + ".py"))
    for w in m.get("workloads", []):
        assert w in CELLS
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_setup_s_on_every_cell_with_the_bound_of_a_quarter():
    (m,) = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert "workloads" not in m and m["bound"] == 0.25


def _reports(cell, group):
    return [m["name"] for m in BENCH[group]
            if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = _reports(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert _reports(cell, "per_layer")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in _reports(cell, "end_to_end")


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    data = json.load(open(os.path.join(ROOT, c["file"])))
    assert data["source"] == c["source"] and data["name"] == c["name"]
    assert data["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert NAME.match(k)
    for text in (c["source"], c["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    _, _, config, mix = harness.cell_spec(w["name"])
    for kind, name in (("traffic", mix["generator"]),
                       ("entries", mix["entry"])):
        assert os.path.exists(os.path.join(harness.HERE, kind, name + ".py"))
    assert config["scoring"]["width"] == "sat"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_a_small_file(cell):
    """A cell comes with its CPU coverage: the small size and the control
    that every parametrised test of the cells reads."""
    path = os.path.join(SMALL_DIR, cell + ".json")
    assert os.path.exists(path), f"no tests/small/{cell}.json"
    small = json.load(open(path))
    assert set(small) <= {"config", "traffic", "control"}
    assert small["control"] in harness.CONTROLS


def test_every_small_file_names_a_cell():
    names = [f[:-len(".json")] for f in os.listdir(SMALL_DIR)]
    assert set(names) <= set(CELLS)
    assert all(f.endswith(".json") for f in os.listdir(SMALL_DIR))


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(harness.HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
