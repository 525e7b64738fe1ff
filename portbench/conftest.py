"""Shapes the benchmark's CPU tests give the configurations added after
``tests/conftest.py``'s ``TINY`` table, put into that table before the
tests run, so that every configuration of ``BENCHMARK.json`` has one."""

from __future__ import annotations

from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"
# a few small views, each configuration's spacing, angles and corrections kept
TINY = {
    "lightsheet4v": {"tile": [16, 32, 32]},
}


def pytest_sessionstart(session):
    for plugin in session.config.pluginmanager.get_plugins():
        table = getattr(plugin, "TINY", None)
        if isinstance(table, dict) and Path(getattr(plugin, "__file__", "")).parent == TESTS:
            for name, shape in TINY.items():
                table.setdefault(name, shape)
