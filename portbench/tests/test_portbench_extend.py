"""A new cell comes as new files and entries only: a throwaway
configuration, traffic mix, limit file and layer-metric reader added beside
the others, with no edit to a file that is there, run and report."""

from __future__ import annotations

import json


def test_a_throwaway_cell_runs_from_new_files(tiny_root, run_tiny):
    folder = tiny_root / "portbench"
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    cfg = json.loads((folder / "configs" / "grid2d_256.json").read_text())
    cfg.update(name="grid2d_one", channels=1, grid=[2, 3])
    (folder / "configs" / "grid2d_one.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "fuse_once.json").write_text(json.dumps(
        {"job": "fuse_memory", "pacing": {"mode": "slots", "jobs": 1}, "check_jobs": 1}))
    (folder / "cells" / "grid2d_one.fuse_once.json").write_text(json.dumps(
        {"limits": {"max_counts": 4, "mean_counts": 0.03, "origin_px": 0}}))
    (folder / "layer_metrics" / "jobs_run.throwaway.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "grid2d_one", "source": "a test", "reduced": [],
                             "file": "portbench/configs/grid2d_one.json", "why": "a test"})
    bench["workloads"].append({"name": "grid2d_one.fuse_once", "config": "grid2d_one",
                               "traffic": "fuse_once", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "fuse_mvox_s", "unit": "Mvox/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["grid2d_one.fuse_once"]})
    bench["per_layer"].append({"name": "jobs_run.throwaway", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "fuse_mvox_s",
                               "workloads": ["grid2d_one.fuse_once"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, line, err = run_tiny(tiny_root, "grid2d_one.fuse_once", trace=1)
    assert rc == 0, err
    assert line["correct"] and line["attempted"] == 1 + 3  # the window's job and 3 traced
    assert line["metrics"]["jobs_run.throwaway"]["value"] == 1.0
    rc, line, err = run_tiny(tiny_root, "grid2d_one.fuse_once")
    assert rc == 0 and set(line["metrics"]) == {"fuse_mvox_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
