"""What a run loads: no ``jax`` and no JAX package, compared by whole
top-level names; the reference loads nothing of the port either."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import REPO, make_tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "multiview_stitcher_tpu"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        assert not (_imports(path) & (FORBIDDEN | {"multiview_stitcher_torch"})), path
        assert _imports(path) <= {"__future__", "itertools", "json", "math", "os", "zlib",
                                  "numpy", "torch"}, path


def test_a_run_loads_no_jax(tmp_path):
    root = make_tiny_root(tmp_path)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from portbench import harness\n"
        f"rc = harness.main(['--workload', 'grid3d_256.zarr_to_zarr', '--seed', '5', '--seconds',"
        f" '0.3'], root={str(root)!r}, device='cpu', port_root=None)\n"
        "found = sorted({m.split('.')[0] for m in sys.modules} & set("
        f"{sorted(FORBIDDEN)!r}))\n"
        "print('FOUND', found)\n"
        "sys.exit(rc)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FOUND []" in res.stdout


def test_a_run_without_the_port_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the port cannot be imported: the run fails and prints nothing."""
    root = make_tiny_root(tmp_path)
    res = subprocess.run([sys.executable, str(root / "portbench" / "run.py"), "--workload",
                          "grid3d_256.zarr_to_zarr", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
