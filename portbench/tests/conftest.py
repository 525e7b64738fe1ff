"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root with its configurations shrunk to a few small tiles, run on
the CPU through the port's plain kernels."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the shapes the CPU tests give each configuration: a few tiles, the
# configuration's dtype, channels, spacing and stage errors kept
TINY = {
    "grid3d_256": {"tile": [16, 24, 24], "grid": [1, 3, 3], "overlap": [0, 6, 6]},
    "grid2d_256": {"tile": [96, 96], "grid": [3, 3], "overlap": [20, 20]},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the card with "
                   "`python -m pytest portbench/tests -m card`)")


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark under ``dest`` whose configurations are TINY."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def run_tiny(capsys):
    """Run a workload on the CPU under a root; returns (exit code, the last
    stdout line parsed, stderr)."""
    from portbench import harness

    def run(root: Path, workload: str, seed=2**31 + 11, seconds=0.5, trace=0):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)],
                          root=root, device="cpu", port_root=None)
        out, err = capsys.readouterr()
        lines = [ln for ln in out.splitlines() if ln.strip()]
        return rc, (json.loads(lines[-1]) if lines and rc == 0 else None), err

    return run
