"""The multi-view light-sheet cell of the benchmark (``lightsheet4v``), on
the CPU at a small size: four views of (16, 32, 32) at spacing (2, 1, 1),
view k turned about y by 90 k degrees, views 1-3 under registration
corrections, all drawn from a seed by ``portbench/multiview.py``.

The port's ``fuse(device="cpu")`` (the kernels' plain versions) is held to
the benchmark's plain affine fusion (``portbench/reference/affine_fusion.py``)
within 1 count on uint16 (the f32 blend lands on either side of a
truncation tie) and to the JAX package's ``fuse`` (exact tier, interpret
mode) on float32 views within rtol 1e-4, atol 1e-3 (f32 ulps of the sample
positions). The job kind runs through the benchmark's harness in a
subprocess (the harness refuses a process that has loaded JAX, as this one
has), and the check reads planted faults and the bfloat16 control over the
cell's limits.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.utils import profiling
from multiview_stitcher_tpu import si_utils as jsi
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse
from portbench import jobkit, multiview
from portbench.reference import affine_fusion

REPO = Path(__file__).resolve().parents[1]
CELL = "lightsheet4v.fuse_views"
CONFIG = json.loads((REPO / "portbench/configs/lightsheet4v.json").read_text())
TINY = dict(CONFIG, tile=[16, 32, 32])
LIMITS = json.loads((REPO / "portbench/cells" / f"{CELL}.json").read_text())["limits"]
TRAFFIC = json.loads((REPO / "portbench/traffic/fuse_views.json").read_text())
OUT_SPACING = TRAFFIC["fuse_kwargs"]["output_spacing"]
SEEDS = [2**31 + 11, 3000007919]


def _views(seed=SEEDS[0]):
    return multiview.make_views(TINY, seed, "cpu")


def _port_fuse(views, data=None, **kw):
    sims = multiview.to_sims(views if data is None else _with(views, data), jobkit.KEY)
    tcore.clear_device_tile_cache()
    return tfuse(sims, transform_key=jobkit.KEY, device="cpu", output_spacing=OUT_SPACING, **kw)


def _with(views, data):
    return multiview.Views(views=data, affines=views.affines, spacing=views.spacing,
                           output_spacing=views.output_spacing)


def test_the_views_are_rotated_about_y_and_corrected():
    views = _views()
    assert views.views.shape == (4, 16, 32, 32) and views.views.dtype == np.uint16
    assert views.spacing == (2.0, 1.0, 1.0)
    # every map is rigid; view 0 is only shifted, the others turn by about
    # 90 k degrees about y and a correction of 0.5-2 degrees
    for k, a in enumerate(views.affines):
        lin = a[:3, :3]
        np.testing.assert_allclose(lin @ lin.T, np.eye(3), atol=1e-12)
        nominal = multiview.about_y(np.deg2rad(90 * k))
        turn = np.degrees(np.arccos(np.clip((np.trace(lin @ nominal.T) - 1) / 2, -1, 1)))
        assert (turn == 0) if k == 0 else (0.5 - 1e-9 <= turn <= 2 + 1e-9), (k, turn)
    # the same seed gives the same views
    again = _views()
    np.testing.assert_array_equal(again.views, views.views)
    np.testing.assert_array_equal(again.affines, views.affines)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("chunk", [256, 16, 8])
def test_port_fuse_matches_the_plain_reference(seed, chunk):
    views = _views(seed)
    out = _port_fuse(views, output_chunksize=chunk)
    ref, origin, shape, _ = affine_fusion.fuse(
        torch.from_numpy(views.views), views.spacing, views.affines, 1.0, chunk=chunk)
    got = np.asarray(out.data)
    assert out.dims == ("z", "y", "x") and got.shape == shape and got.dtype == np.uint16
    assert [float(out.origin[d]) for d in "zyx"] == origin.tolist()
    diff = np.abs(got.astype(np.int64) - ref.numpy().astype(np.int64))
    assert diff.max() <= 1
    assert (got > 0).mean() > 0.5  # the views fill most of the union


def test_port_fuse_takes_the_exact_general_route_on_the_card_stack():
    views = _views()
    _port_fuse(views, output_chunksize=16)
    tele = dict(tcore.last_batched_telemetry)
    assert tele["route"] == "exact" and tele["kind"] == "general"
    assert tele["host_slabs"] is False
    assert tele["stack_bytes"] == views.views.nbytes
    assert tele["K_max"] == 4 and tele["chunks"] == 27 and tele["batches"] >= 1
    assert len(tele["S_max"]) == 3


def test_the_batched_stages_are_recorded_once_a_batch():
    views = _views()
    sims = multiview.to_sims(views, jobkit.KEY)
    tcore.clear_device_tile_cache()
    counts = []
    for _ in range(2):  # the second call finds its tables on the cached plan
        profiling.reset_stage_times()
        tfuse(sims, transform_key=jobkit.KEY, device="cpu", output_spacing=OUT_SPACING,
              output_chunksize=8)
        counts.append({k: v["count"] for k, v in profiling.get_stage_times().items()})
    batches = tcore.last_batched_telemetry["batches"]
    assert counts[0] == {"fuse.plan": 1, "tiles.upload": 1, "batched.tables": 1,
                         "batched.resample": batches, "batched.blend": 2 * batches,
                         "fuse.download": 1}
    assert "batched.tables" not in counts[1] and "fuse.plan" not in counts[1]
    assert counts[1]["batched.resample"] == batches


def test_port_fuse_of_float_views_matches_jax(monkeypatch):
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    views = _views()
    data = views.views.astype(np.float32)
    jsims = []
    for v in range(len(data)):
        sim = jsi.get_sim_from_array(
            data[v], dims=("z", "y", "x"), scale=dict(zip("zyx", views.spacing)),
            translation={d: 0.0 for d in "zyx"})
        jsi.set_sim_affine(sim, views.affines[v], transform_key=jobkit.KEY)
        jsims.append(sim)
    jcore.clear_device_tile_cache()
    try:
        ref = jfuse(jsims, transform_key=jobkit.KEY, output_spacing=OUT_SPACING)
        ref_data = np.asarray(ref.data)
    finally:
        jcore.clear_device_tile_cache()
        jax.clear_caches()
    got = _port_fuse(views, data)
    assert got.dims == ref.dims and got.origin == ref.origin
    assert np.asarray(got.data).dtype == ref_data.dtype == np.float32
    np.testing.assert_allclose(np.asarray(got.data), ref_data, rtol=1e-4, atol=1e-3)


def _job(tmp_path):
    from portbench import harness

    Job = harness.load_module(REPO / "portbench/jobs/fuse_views.py", "fuse_views_job").Job
    job = Job(TINY, TRAFFIC, SEEDS[0], "cpu", str(tmp_path))
    job.setup()
    return job


def _over_limits(nums) -> list:
    return [k for k, v in nums.items() if v > LIMITS[k]]


def _checked(job, change, monkeypatch):
    """The job's check of one job run with ``change`` wrapped around the
    port's exact-affine batch."""
    orig = tcore._fuse_chunk_batch_kernel_exact

    def wrapped(data, mats, offs, extents, wgrids, wmats, woffs, view_valid, *a, **k):
        return change(orig, data, mats, offs, extents, wgrids, wmats, woffs, view_valid, *a, **k)

    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_exact", wrapped)
    job.before(0)
    out = job.run(0)["output"]
    monkeypatch.undo()
    return job.check({0: out})


def _voxel_plus_100(orig, *a, **k):
    out = orig(*a, **k)
    flat = out.reshape(-1).to(torch.int32)
    flat[flat.numel() // 2] += 100
    return flat.to(out.dtype).reshape(out.shape)


def _view_1_dropped(orig, data, mats, offs, extents, wgrids, wmats, woffs, view_valid, *a, **k):
    keep = np.asarray(view_valid) & (np.asarray(k["tile_idx"]) != 1)
    return orig(data, mats, offs, extents, wgrids, wmats, woffs, keep, *a, **k)


def test_the_job_check_passes_the_port_and_reads_planted_faults(tmp_path, monkeypatch):
    job = _job(tmp_path)
    clean = _checked(job, lambda orig, *a, **k: orig(*a, **k), monkeypatch)
    assert set(clean) == set(LIMITS) and not _over_limits(clean), clean
    assert clean["max_counts"] <= 1 and clean["origin_px"] == 0
    for fault in (_voxel_plus_100, _view_1_dropped):
        nums = _checked(job, fault, monkeypatch)
        assert _over_limits(nums), (fault.__name__, nums)
    control = job.control()
    assert set(control) == set(LIMITS) and _over_limits(control), control
    job.close()


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((REPO / "portbench/reference/affine_fusion.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names <= {"__future__", "math", "numpy", "torch", ".fusion"}, names


def test_the_cell_runs_through_the_harness(tmp_path):
    """Untraced and traced runs of the cell at the small size, through the
    benchmark's own command, in a process that loads no JAX."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "portbench/configs/lightsheet4v.json").write_text(json.dumps(TINY))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from portbench import harness\n"
        "for trace in (0, 1):\n"
        f"    rc = harness.main(['--workload', {CELL!r}, '--seed', '{2**40 + 3}', '--seconds',"
        f" '0.5', '--trace', str(trace)], root={str(root)!r}, device='cpu', port_root=None)\n"
        "    assert rc == 0, rc\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 2
    plain, traced = lines
    for line in lines:
        assert line["correct"] and line["failed"] == 0, line
        assert set(line["checks"]) == set(LIMITS)
    assert set(plain["metrics"]) == {"fuse_mvox_s", "setup_s"}
    # the CPU has no device trace: the host spans and the idle share are read
    assert {"tables_ms.views", "resample_ms.views", "blend_ms.views",
            "device_idle_pct.views"} <= set(traced["metrics"])
    assert traced["attempted"] >= 1 + TRAFFIC["traced_jobs"]
