"""BENCHMARK.json against the contract's form, and every file it names
found by name."""

import json
import re

import pytest

from _util import ROOT
from portbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == KEYS[group], e["name"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert BENCH["command"][1:] == ["portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(set(names)) == len(names)
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            reported = {e["name"] for e in manifest.metrics(BENCH, w, False)}
            assert m["moves"] in reported, (m["name"], w)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    w = manifest.cell(BENCH, cell)
    config = manifest.config(BENCH, w["config"])
    assert config["name"] == w["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("portbench/configs/")
    assert config["reduced"] == entry["reduced"]
    traffic = manifest.traffic(w["traffic"])
    assert traffic["name"] == w["traffic"]
    for trace in (False, True):
        for m in manifest.metrics(BENCH, cell, trace):
            assert callable(manifest.reader(m["name"]))


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        json.loads((ROOT / c["file"]).read_text())
