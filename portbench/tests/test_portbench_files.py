"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, job kind, limit file and metric reader is there and parses, and
the names and units keep to the benchmark's character rules."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
FOLDER = REPO / BENCH["paths"][0]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_parses(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert cfg["file"].startswith(BENCH["paths"][0] + "/")
    for key in ("tile", "grid", "overlap", "channels", "dtype", "spacing", "stage_error_px",
                "position_jitter_px", "psf_sigma_px", "assumed", "reduced"):
        assert key in data
    assert len(data["tile"]) == len(data["grid"]) == len(data["overlap"])
    assert set(cfg["reduced"]) <= set(data.get("reduced", {}))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_parse(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((FOLDER / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (FOLDER / "jobs" / f"{traffic['job']}.py").is_file()
    limits = json.loads((FOLDER / "cells" / f"{cell['name']}.json").read_text())["limits"]
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(NAME.match(w["traffic"]) for w in BENCH["workloads"])


def test_every_metric_has_a_reader():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"] == "setup_s" or (FOLDER / "e2e_metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (FOLDER / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # a cell that reports a layer metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    assert "setup_s" in e2e


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert len(e2e) >= 2 and layer, w["name"]
