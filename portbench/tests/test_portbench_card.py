"""A cell on the card, briefly: the command as the benchmark runs it, one
run of each cell with a short window, correct and complete."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
