"""Whole runs on the CPU at tiny sizes: each cell's job kind against the
plain reference, the printed line's keys, the metric readers, and the
faults and the control that the check must catch."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
BENCH_CELLS = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
HOST_READ = {"grid3d_256.zarr_to_zarr": ["plan_ms.zarr"],
             "grid2d_256.stitch": ["graph_ms.stitch", "pairwise_ms.stitch", "resolve_ms.stitch"]}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(tiny_root, run_tiny, cell):
    rc, line, err = run_tiny(tiny_root, cell)
    assert rc == 0, err
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    limits = json.loads((REPO / "portbench/cells" / f"{cell}.json").read_text())["limits"]
    assert set(line["checks"]) == set(limits)
    # each number is printed beside its limit as the last lines of stderr
    tail = err.strip().splitlines()[-len(limits):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell", ["grid3d_256.zarr_to_zarr", "grid2d_256.stitch"])
def test_a_traced_run_gives_the_layer_metrics_and_the_breakdown(tiny_root, run_tiny, cell):
    rc, line, err = run_tiny(tiny_root, cell, trace=1)
    assert rc == 0, err
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # what a tiny CPU run has to read: the port's host spans (it does not
    # stream at these sizes, and the CPU has no device trace)
    assert set(HOST_READ[cell]) <= set(line["metrics"])
    traffic = json.loads((REPO / "portbench/traffic" / f"{BENCH_CELLS[cell]}.json").read_text())
    assert line["attempted"] >= 1 + traffic["traced_jobs"]
    # the traced jobs come after the window, which stays untraced
    assert "traced jobs: wall_s" in err


def _wrap_kernels(monkeypatch, change):
    """Put ``change(result, view_idx)`` behind both translation kernels."""
    from multiview_stitcher_torch.ops import translation_fusion as tf

    for name in ("fuse_translation_2d", "fuse_translation_3d"):
        orig = getattr(tf, name)

        def wrapped(tiles, view_idx, *a, _orig=orig, **k):
            return change(_orig, tiles, view_idx, *a, **k)

        wrapped.launches = 0
        monkeypatch.setattr(tf, name, wrapped)


def _altered(orig, tiles, view_idx, *a, **k):
    out = orig(tiles, view_idx, *a, **k)
    flat = out.reshape(-1).to(torch.int32)
    flat[flat.numel() // 2] += 100
    return flat.to(out.dtype).reshape(out.shape)


def _half_left_out(orig, tiles, view_idx, *a, **k):
    view_idx = np.where(np.asarray(view_idx) % 2 == 1, -1, np.asarray(view_idx))
    return orig(tiles, view_idx.astype(np.int32), *a, **k)


def _unchanged(orig, tiles, view_idx, *a, **k):
    return torch.zeros_like(orig(tiles, view_idx, *a, **k))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged],
                         ids=["answer_altered", "half_left_out", "output_unchanged"])
def test_a_fault_in_the_fusion_is_not_correct(tiny_root, run_tiny, monkeypatch, cell, fault):
    _wrap_kernels(monkeypatch, fault)
    rc, line, err = run_tiny(tiny_root, cell)
    assert rc == 0, err
    assert line["correct"] is False


def _resolution_fault(monkeypatch, change):
    from multiview_stitcher_torch import param_resolution

    orig = param_resolution.groupwise_resolution

    def wrapped(g, **k):
        params, info = orig(g, **k)
        return {n: change(n, p) for n, p in params.items()}, info

    monkeypatch.setattr(param_resolution, "groupwise_resolution", wrapped)


def _shift_half(n, p):
    if n % 2:
        return p
    p = p.copy()
    p.data[..., 0, -1] += 1.0  # every other tile moved by a micron (spacing 0.5: two pixels)
    return p


def _identity(n, p):
    p = p.copy()
    nd = p.data.shape[-1]
    p.data[...] = np.eye(nd)
    return p


@pytest.mark.parametrize("change", [_shift_half, _identity], ids=["half_moved", "unresolved"])
def test_a_fault_in_the_registration_is_not_correct(tiny_root, run_tiny, monkeypatch, change):
    _resolution_fault(monkeypatch, change)
    rc, line, err = run_tiny(tiny_root, "grid2d_256.stitch")
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["link_px"]["value"] > line["checks"]["link_px"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell, tmp_path):
    """The control (the reference in bfloat16 in the program's place; for
    the stitch cell also registered to whole pixels) fails one of the cell's
    limits."""
    from portbench import harness

    c = harness.load_cell(tiny_root, cell)
    job = harness.job_class(c)(c.config, c.traffic, 2**31 + 3, "cpu", str(tmp_path))
    job.setup()
    nums = job.control()
    job.close()
    assert any(v > c.limits["limits"][k] for k, v in nums.items()), nums
