"""The port's fusion-plan cache (``fusion._core._plan_cache``) against the
JAX package's.

Inputs are made from a seed with numpy: the 2D grids of
tests/test_torch_streaming.py (n x n tiles of 48, overlap 12, uint16 values
in [0, 3000)) and the rotated pair of tests/test_torch_fuse_affine.py (f32
values in [0, 100)). The port runs with ``device="cpu"``; the reference on the
CPU, its Pallas kernels in interpret mode, with ``MVS_TPU_EXACT_AFFINE=1`` and
``MVS_TPU_SHEAR=0`` where a view is rotated.

A repeat call plans nothing: the spies on the chunk planner and on the
table builders of the translation, tiles and batched tiers count no call.
Tolerances: a repeat call is bit-equal to its cold call; against the reference, uint16
within 1 count (truncation ties) and f32 rtol 1e-4, atol 1e-3
(tests/test_pallas_fusion.py:98).
"""

import jax
import numpy as np
import pytest

from multiview_stitcher_torch import convert, residency
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import _streaming as tstream
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_tpu import si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse

KEY = si_utils.DEFAULT_TRANSFORM_KEY


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _grid_sims(n=4, tile=48, overlap=12, seed=0, spacing=1.0):
    """n x n uint16 tiles as JAX sims."""
    rng = np.random.default_rng(seed)
    step = (tile - overlap) * spacing
    return [
        si_utils.get_sim_from_array(
            rng.integers(0, 3000, (tile, tile)).astype(np.uint16), dims=["y", "x"],
            scale={"y": spacing, "x": spacing},
            translation={"y": float(iy * step), "x": float(ix * step)},
        )
        for iy, ix in np.ndindex((n, n))
    ]


def _rotated_pair():
    """The roty2 layout of tests/test_torch_fuse_affine.py: the second view
    rotated by 0.06 rad."""
    from scipy.ndimage import gaussian_filter

    img = (gaussian_filter(np.random.default_rng(3).random((80, 80)), 1.5) * 100).astype(
        np.float32)
    c, s = np.cos(0.06), np.sin(0.06)
    rot = np.eye(3)
    rot[:2, :2] = [[c, -s], [s, c]]
    sims = []
    for data, tr, m in ((img, (0.0, 0.0), np.eye(3)), (img.copy(), (0.0, 60.0), rot)):
        sim = si_utils.get_sim_from_array(data, dims=("y", "x"),
                                          translation=dict(zip(("y", "x"), tr)))
        si_utils.set_sim_affine(sim, m, transform_key=KEY)
        sims.append(sim)
    return sims


def _assert_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(initial=0) <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.fixture
def caches():
    tcore.clear_device_tile_cache()
    jcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()
    jcore.clear_device_tile_cache()


_PLANNERS = ("_build_spatial_fusion_plan", "translation_kernel_params", "tile_view_lists",
             "_tiles_tier_tables", "exact_kernel_params", "_build_exact_batch")
_TIERS = ("_execute_fusion_plan_translation", "_execute_fusion_plan_tiles",
          "_execute_fusion_plan_batched")


def _spy(monkeypatch, names, module=tcore):
    """Counting wrappers around functions of ``module``; returns the
    counts."""
    counts = {n: 0 for n in names}
    for name in names:
        orig = getattr(module, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            counts[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return counts


def _port(sims, **kw):
    return tfuse(sims, transform_key=KEY, device="cpu", **kw).to_numpy()


def _tier_case(tier, monkeypatch):
    """(JAX sims, fuse kwargs of both packages, the port's tier)."""
    if tier == "translation":
        return _grid_sims(), {}, {}, "_execute_fusion_plan_translation"
    if tier == "streamed":
        monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
        return _grid_sims(), {}, {}, None
    if tier == "tiles":
        return (_grid_sims(), {"fusion_func": jcore.max_fusion},
                {"fusion_func": tcore.max_fusion}, "_execute_fusion_plan_tiles")
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    return _rotated_pair(), {"output_chunksize": 48}, {"output_chunksize": 48}, \
        "_execute_fusion_plan_batched"


@pytest.mark.parametrize("tier", ["translation", "streamed", "tiles", "batched"])
def test_a_repeat_call_plans_nothing(tier, caches, monkeypatch):
    """The streamed tier keeps its band plan and tables under
    ``"prep:stream"``; its repeat also reads the seeded tile stack."""
    jsims, jkw, pkw, tier_fn = _tier_case(tier, monkeypatch)
    ref = np.asarray(jfuse(jsims, transform_key=KEY, **jkw).data)
    if tier == "batched":
        jax.clear_caches()  # the reference's exact-tier traces stay at these shapes
    sims = _to_port(jsims)
    planned = _spy(monkeypatch, _PLANNERS)
    planned.update(_spy(monkeypatch, ["_stream_tables"], tstream))
    ran = _spy(monkeypatch, _TIERS)
    streamed = _spy(monkeypatch, ["execute_streaming"], tstream)
    cold = _port(sims, **pkw)
    if tier_fn is None:
        assert streamed["execute_streaming"] == 1 and not any(ran.values())
        assert tstream.last_telemetry["bands_done"] == tstream.last_telemetry["bands_total"]
    else:
        assert ran[tier_fn] == 1 and sum(ran.values()) == 1
    assert sum(planned.values()) > 0
    if tier in ("translation", "streamed"):
        assert planned["_build_spatial_fusion_plan"] == 0  # the tier needs no chunk plan
    else:
        assert planned["_build_spatial_fusion_plan"] == 1
    assert len(tcore._plan_cache) == 1
    planned.update(dict.fromkeys(planned, 0))
    repeat = _port(sims, **pkw)
    if tier_fn is None:
        assert streamed["execute_streaming"] == 2
        assert tstream.last_telemetry["up_batches_resident"] == tstream.last_telemetry["batches"]
    else:
        assert ran[tier_fn] == 2
    assert not any(planned.values()), planned
    np.testing.assert_array_equal(repeat, cold)
    _assert_close(cold, ref)


def _key_variant(name, monkeypatch):
    """(port sims, fuse kwargs) differing from the base call in one
    component of the plan key."""
    jsims, kw = _grid_sims(n=3), {}
    if name == "params":
        jsims = _grid_sims(n=3)
        m = np.eye(3)
        m[1, 2] = 1.0
        si_utils.set_sim_affine(jsims[4], m, transform_key=KEY)
    elif name == "shape":
        s = jsims[8]
        jsims[8] = si_utils.get_sim_from_array(
            np.asarray(s.data)[:40, :44], dims=["y", "x"], translation=dict(s.origin))
    elif name == "spacing":
        jsims = _grid_sims(n=3, spacing=0.5)
        kw = {"output_spacing": {"y": 1.0, "x": 1.0}}
    elif name == "origin":
        s = jsims[4]
        jsims[4] = si_utils.get_sim_from_array(
            np.asarray(s.data), dims=["y", "x"],
            translation={"y": s.origin["y"] + 1.0, "x": s.origin["x"]})
    elif name == "output":
        kw = {"output_spacing": {"y": 2.0, "x": 2.0}}
    elif name == "chunksize":
        kw = {"output_chunksize": 32}
    elif name == "overlap":
        kw = {"overlap_in_pixels": 2}
    elif name == "order":
        kw = {"interpolation_order": 0}
    elif name == "shear_margin":
        monkeypatch.setenv("MVS_TPU_SHEAR", "1")
    return _to_port(jsims), kw


@pytest.mark.parametrize("name", ["params", "shape", "spacing", "origin", "output",
                                  "chunksize", "overlap", "order", "shear_margin"])
def test_a_change_of_each_key_component_misses(name, caches, monkeypatch):
    base = _to_port(_grid_sims(n=3))
    if name == "spacing":
        # the base call at the same output grid: only the views' spacing differs
        base = _to_port(_grid_sims(n=3, spacing=1.0))
        _port(base, output_spacing={"y": 1.0, "x": 1.0})
    else:
        _port(base)
    assert len(tcore._plan_cache) == 1
    planned = _spy(monkeypatch, _PLANNERS)
    sims, kw = _key_variant(name, monkeypatch)
    _port(sims, **kw)
    assert len(tcore._plan_cache) == 2
    assert sum(planned.values()) > 0


def test_a_change_of_blending_widths_repreps_on_the_same_plan(caches, monkeypatch):
    sims = _to_port(_grid_sims())
    first = _port(sims)
    planned = _spy(monkeypatch, _PLANNERS)
    wide = _port(sims, blending_widths={"y": 20.0, "x": 20.0})
    assert len(tcore._plan_cache) == 1
    assert planned["translation_kernel_params"] == 1 and planned["tile_view_lists"] == 1
    assert planned["_build_spatial_fusion_plan"] == 0
    assert not np.array_equal(wide, first)
    plan = next(iter(tcore._plan_cache.values()))
    assert sum(1 for k in plan if isinstance(k, tuple) and k[0] == "prep:pallas") == 2
    planned.update(dict.fromkeys(planned, 0))
    np.testing.assert_array_equal(_port(sims), first)
    np.testing.assert_array_equal(_port(sims, blending_widths={"y": 20.0, "x": 20.0}), wide)
    assert not any(planned.values())


def test_the_seventeenth_plan_evicts_the_first(caches, monkeypatch):
    sims = _to_port(_grid_sims(n=2, tile=32, overlap=8))
    for chunk in range(16, 16 + tcore._PLAN_CACHE_MAX + 1):
        _port(sims, output_chunksize=chunk)
        if chunk == 16:
            first = next(iter(tcore._plan_cache))
    assert len(tcore._plan_cache) == tcore._PLAN_CACHE_MAX
    assert first not in tcore._plan_cache
    assert next(iter(tcore._plan_cache))[3] == (("x", 17), ("y", 17))
    planned = _spy(monkeypatch, _PLANNERS)
    _port(sims, output_chunksize=16)
    assert planned["translation_kernel_params"] == 1
    assert first in tcore._plan_cache and len(tcore._plan_cache) == tcore._PLAN_CACHE_MAX


def test_clear_device_tile_cache_empties_the_plan_cache(caches, monkeypatch):
    sims = _to_port(_grid_sims(n=3))
    _port(sims)
    assert tcore._plan_cache
    tcore.clear_device_tile_cache()
    assert tcore._plan_cache == {} and residency.device_tile_cache._entries == {}
    planned = _spy(monkeypatch, _PLANNERS)
    _port(sims)
    assert planned["translation_kernel_params"] == 1


def test_the_plan_count_equals_the_references(caches, monkeypatch):
    """The same calls in both packages: a grid, its repeat, another fusion
    function over the same geometry, another chunking, another grid."""
    jgrid, jother = _grid_sims(n=3), _grid_sims(n=3, seed=1, overlap=16)
    calls = [
        (jgrid, {}, {}),
        (jgrid, {}, {}),
        (jgrid, {"fusion_func": jcore.max_fusion}, {"fusion_func": tcore.max_fusion}),
        (jgrid, {"output_chunksize": 32}, {"output_chunksize": 32}),
        (jother, {}, {}),
    ]
    for jsims, jkw, pkw in calls:
        ref = np.asarray(jfuse(jsims, transform_key=KEY, **jkw).data)
        _assert_close(_port(_to_port(jsims), **pkw), ref)
    assert len(tcore._plan_cache) == len(jcore._plan_cache) == 3
