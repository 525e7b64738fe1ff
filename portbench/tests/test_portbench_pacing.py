"""The window's pacing, the output sample and the zarr cell's disk
reckoning."""

from __future__ import annotations

import json
import math

import pytest

from conftest import REPO
from portbench import data, harness
from portbench.reference import fusion, pyramid


def test_back_to_back_starts_while_the_window_is_open():
    pacing = {"mode": "back_to_back"}
    assert harness.planned_start(0, 0.0, 30, pacing) == 0.0
    assert harness.planned_start(7, 29.9, 30, pacing) == 29.9
    assert harness.planned_start(8, 30.0, 30, pacing) is None
    assert harness.planned_start(0, 31.0, 30, pacing) == 31.0  # the first job always runs


def test_slots_start_at_their_share_of_the_window_or_late():
    pacing = {"mode": "slots", "jobs": 3}
    assert harness.planned_start(0, 0.0, 30, pacing) == 0.0
    assert harness.planned_start(1, 6.0, 30, pacing) == 10.0    # waits for its slot
    assert harness.planned_start(2, 24.0, 30, pacing) == 24.0   # late: at once
    assert harness.planned_start(2, 31.0, 30, pacing) is None   # the window has closed
    assert harness.planned_start(3, 25.0, 30, pacing) is None   # three jobs only


def test_the_sample_is_drawn_from_the_seed():
    def drawn(seed):
        s = harness._Sample(2, seed)
        for k in range(40):
            s.offer(k, k)
        return sorted(s.kept)

    assert drawn(2**31 + 5) == drawn(2**31 + 5)
    assert len(drawn(7)) == 2
    assert len({tuple(drawn(s)) for s in range(20)}) > 1


def test_zarr_cell_writes_about_three_gigabytes_a_run():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/grid3d_256.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/zarr_to_zarr.json").read_text())
    assert traffic["pacing"] == {"mode": "slots", "jobs": 4}
    n_tiles = math.prod(cfg["grid"])
    tiles = n_tiles * math.prod(cfg["tile"]) * 2
    # the largest output the jitter and the stage errors allow: every axis
    # widened by twice their sum, and a pixel
    shape = [e + 2 * math.ceil(j + s) + 1 for e, j, s in
             zip(data.grid_extent(cfg), cfg["position_jitter_px"], cfg["stage_error_px"])]
    store = math.prod(shape) * 2
    level = list(shape)
    for rel in pyramid.level_factors(shape):
        level = [s // f for s, f in zip(level, rel)]
        store += math.prod(level) * 2
    # the warm-up job's store too, and in a traced run the traced jobs'
    written = tiles + (traffic["pacing"]["jobs"] + 1) * store
    assert 2.5e9 < written < 3.2e9
    assert written + traffic["traced_jobs"] * store < 3.5e9
    assert bench["run_seconds"] >= 5 * traffic["pacing"]["jobs"]  # a slot holds a job of about 5 s


@pytest.mark.parametrize("shape,expect", [((101, 1306, 1306), 3), ((2, 1306, 1306), 3)])
def test_pyramid_levels(shape, expect):
    assert len(pyramid.level_factors(shape[1:] if shape[0] == 2 else shape)) == expect
    assert fusion.output_geometry([[0, 0], [0, 80.5]], (100, 100), 1.0)[1] == (100, 180)

