"""The port's ``fuse()`` and its host planning against the JAX package.

Inputs are made from a seed with numpy. The JAX sims are built with
``multiview_stitcher_tpu.si_utils`` and carried over to the port with
``convert.sim_from_numpy``; the reference ``fuse`` runs its Pallas
translation tier in interpret mode on the CPU, the port's ``fuse`` runs with
``device="cpu"``, which takes the kernels' plain PyTorch versions.

Tolerances: f32 outputs rtol 1e-4, atol 1e-3 (tests/test_pallas_fusion.py:98);
uint16 outputs at most 1 count, on truncation ties. The host planning is the
same float64 numpy arithmetic on both sides and must agree exactly.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import weights as tweights
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.ops import resample as tresample
from multiview_stitcher_tpu import mv_graph, si_utils, weights
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.ops import resample

KEY = si_utils.DEFAULT_TRANSFORM_KEY
REPO = Path(__file__).resolve().parent.parent


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _grid(rng, ndim, n, tile, step, dtype, frac=0.0, dims=None):
    sdims = ["z", "y", "x"][-ndim:]
    grid = (n,) * ndim if ndim == 2 else (1, n, n)
    sims = []
    for iv, idx in enumerate(np.ndindex(grid)):
        data = rng.random(tile) * 900
        translation = {
            d: float(idx[i] * step[i] + frac * ((iv + i) % 3)) for i, d in enumerate(sdims)
        }
        sims.append(si_utils.get_sim_from_array(
            data.astype(dtype), dims=dims or sdims, translation=translation,
        ))
    return sims


def _case(name):
    rng = np.random.default_rng(_CASES.index(name))
    if name == "grid2d_uint16":
        return _grid(rng, 2, 3, (48, 48), (40, 40), np.uint16)
    if name == "grid2d_float32":
        return _grid(rng, 2, 3, (48, 48), (40, 40), np.float32)
    if name == "grid3d_fractional":
        return _grid(rng, 3, 2, (12, 40, 40), (10, 33, 33), np.float32, frac=0.35)
    if name.startswith("grid3d_deep"):
        # deeper than one view-list tile of the port's 3D kernel (64 planes),
        # at fractional offsets
        dtype = np.uint16 if name.endswith("uint16") else np.float32
        return _grid(rng, 3, 2, (70, 24, 24), (60, 20, 20), dtype, frac=0.35)
    if name == "mixed_shapes_uint16":
        shapes = [(40, 48), (48, 36), (36, 40)]
        origins = [(0.0, 0.0), (30.0, 5.0), (10.0, 40.0)]
        return [
            si_utils.get_sim_from_array(
                (rng.random(s) * 900).astype(np.uint16), dims=("y", "x"),
                translation={"y": o[0], "x": o[1]},
            )
            for s, o in zip(shapes, origins)
        ]
    if name.startswith("mixed_resolution"):
        # tests/test_pallas_fusion.py:166-204: view 1 at half the spacing;
        # in 3D its z scale is 1.0 / 0.8 = 1.25
        if name.endswith("2d"):
            spacings = [{"y": 1.0, "x": 1.0}, {"y": 0.5, "x": 0.5}]
            shapes = [(40, 40), (64, 64)]
            translations = [{"y": 0.0, "x": 0.0}, {"y": 2.3, "x": 30.7}]
            dims = ("y", "x")
        else:
            spacings = [{"z": 1.0, "y": 1.0, "x": 1.0}, {"z": 0.8, "y": 0.5, "x": 0.5}]
            shapes = [(10, 32, 32), (12, 48, 48)]
            translations = [{"z": 0.0, "y": 0.0, "x": 0.0}, {"z": 1.7, "y": 2.3, "x": 22.4}]
            dims = ("z", "y", "x")
        return [
            si_utils.get_sim_from_array(
                (rng.random(shapes[i]) * 900).astype(np.uint16),
                dims=dims, scale=spacings[i], translation=translations[i],
            )
            for i in range(2)
        ]
    if name == "channels2d_uint16":
        sims = []
        for iv in range(2):
            data = (rng.random((2, 40, 40)) * 900).astype(np.uint16)
            sims.append(si_utils.get_sim_from_array(
                data, dims=("c", "y", "x"), translation={"y": 0.0, "x": 32.0 * iv},
                c_coords=["a", "b"],
            ))
        return sims
    if name == "time2d_uint16":
        # two timepoints; view 1 drifts by a per-timepoint affine
        sims = []
        for iv in range(2):
            affines = np.stack([np.eye(3), np.eye(3)])
            affines[1, :2, 2] = (3.0 * iv, -5.0 * iv)
            sims.append(si_utils.get_sim_from_array(
                (rng.random((2, 40, 40)) * 900).astype(np.uint16), dims=("t", "y", "x"),
                translation={"y": 4.0 * iv, "x": 30.0 * iv}, affine=affines,
                t_coords=[0, 1],
            ))
        return sims
    raise KeyError(name)


_CASES = [
    "grid2d_uint16",
    "grid2d_float32",
    "grid3d_fractional",
    "mixed_shapes_uint16",
    "mixed_resolution_2d",
    "mixed_resolution_3d",
    "channels2d_uint16",
    "time2d_uint16",
    "grid3d_deep_uint16",
    "grid3d_deep_float32",
]


def _assert_fused_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", _CASES)
def test_fuse_matches_jax(name, monkeypatch):
    # small reference kernel tiles keep interpret mode quick; values do not
    # depend on the tile shape
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "64,64")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_3D", "8,32,64")
    sims = _case(name)
    with warnings.catch_warnings():
        # the reference must take its Pallas translation tier, not a fallback
        warnings.filterwarnings("error", message="Pallas fusion tier failed")
        ref = jfuse(sims, transform_key=KEY)
    got = tfuse(_to_port(sims), transform_key=KEY, device="cpu")
    assert isinstance(got.data, np.ndarray)
    assert got.dims == ref.dims
    assert got.spacing == ref.spacing and got.origin == ref.origin
    for d in got.nsdims:
        np.testing.assert_array_equal(got.coords[d], ref.coords[d])
    np.testing.assert_array_equal(got.transforms[KEY].data, ref.transforms[KEY].data)
    _assert_fused_close(got.data, np.asarray(ref.data))


def test_fuse_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: fuse() runs there by default")
    sims = _to_port(_case("grid2d_uint16"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfuse(sims, transform_key=KEY)


def test_fuse_refuses_what_the_slice_does_not_cover(tmp_path, monkeypatch):
    """What the earlier slices refused now fuses, held to the reference:
    NGFF 0.5 output (zarr v3), msims level by level, and lazy tiles above
    the on-card limit that do not band, which leave the translation tier
    for the batched tier's host slabs (the reference's own fall-through)."""
    from multiview_stitcher_torch.io import zarr_backend as tzb
    from multiview_stitcher_tpu.io import zarr_backend as jzb

    jsims = _case("grid2d_uint16")
    sims = _to_port(jsims)

    def fuse(images=sims, **kw):
        return tfuse(images, transform_key=KEY, device="cpu", **kw)

    # zarr output at NGFF 0.5 (zarr v3): the reference's metadata and values
    opts = {"ngff_version": "0.5"}
    got = fuse(output_zarr_url=str(tmp_path / "out.zarr"), zarr_options=opts)
    ref = jfuse(jsims, transform_key=KEY, output_zarr_url=str(tmp_path / "ref.zarr"),
                zarr_options=opts)
    assert jzb.read_group_metadata(str(tmp_path / "out.zarr")) == jzb.read_group_metadata(
        str(tmp_path / "ref.zarr"))
    _assert_fused_close(np.asarray(got.data), np.asarray(ref.data))
    # msims are fused level by level (an msim of this grid's one level)
    fused_msim = fuse(images=[tmsi.get_msim_from_sim(s) for s in sims])
    assert tmsi.is_msim(fused_msim) and len(fused_msim.sims) == 1
    np.testing.assert_array_equal(fused_msim.sims[0].data, fuse().data)
    # lazy tiles above the on-card limit that cannot band (mixed shapes):
    # host slabs in the batched (default and max) and host (content-based)
    # tiers, against the reference on the same tiles, also lazy and past its
    # limit
    mixed = _case("mixed_shapes_uint16")
    lazy, jlazy = [], []
    for i, s in enumerate(_to_port(mixed)):
        url = str(tmp_path / f"tile_{i}.zarr")
        tzb.create_zarr_array(url, s.data.shape, s.data.shape, s.data.dtype)[...] = s.data
        lazy.append(tsi.get_sim_from_array(tzb.open_zarr_array(url), dims=s.dims,
                                           translation=dict(s.origin)))
        jlazy.append(si_utils.get_sim_from_array(jzb.open_zarr_array(url), dims=s.dims,
                                                 translation=dict(s.origin)))
    monkeypatch.setattr(tcore, "TILES_MAX_BYTES", 0)
    monkeypatch.setenv("MVS_TPU_TILES_MAX_BYTES", "0")
    for kw, jkw, tier in (
        ({}, {}, "batched"),
        ({"fusion_func": tcore.max_fusion}, {"fusion_func": jcore.max_fusion}, "batched"),
        ({"weights_func": tweights.content_based}, {"weights_func": weights.content_based},
         "host"),
    ):
        ref = np.asarray(jfuse(jlazy, transform_key=KEY, **jkw).data)
        tcore.last_slab_telemetry.clear()
        got = fuse(images=lazy, **kw).data
        assert tcore.last_slab_telemetry["tier"] == tier
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def _layout_props(rng, ndim):
    sdims = ["z", "y", "x"][-ndim:]
    props = []
    for _ in range(4):
        props.append({
            "shape": {d: int(rng.integers(8, 40)) for d in sdims},
            "spacing": {d: float(rng.choice([0.5, 0.8, 1.0, 1.3])) for d in sdims},
            "origin": {d: float(rng.normal() * 20) for d in sdims},
        })
    return sdims, props


@pytest.mark.parametrize("ndim", [2, 3])
def test_host_prep_matches_jax_exactly(ndim):
    rng = np.random.default_rng(ndim)
    sdims, props = _layout_props(rng, ndim)
    target = {
        "shape": {d: 64 for d in sdims},
        "spacing": {d: 0.7 for d in sdims},
        "origin": {d: -5.0 for d in sdims},
    }
    for p in props:
        aff = np.eye(ndim + 1)
        aff[:ndim, ndim] = rng.normal(size=ndim) * 10
        args = (
            np.linalg.inv(aff),
            np.array([p["spacing"][d] for d in sdims]),
            np.array([p["origin"][d] for d in sdims]),
            np.array([target["spacing"][d] for d in sdims]),
            np.array([target["origin"][d] for d in sdims]),
        )
        for a, b in zip(tresample.physical_to_pixel_params(*args),
                        resample.physical_to_pixel_params(*args)):
            np.testing.assert_array_equal(a, b)
        for kw in ({}, {"blending_widths": dict(zip(sdims, [2.0, 5.0, 7.0])),
                        "shrink_distance": 1.5}):
            for a, b in zip(
                tweights.blending_weights_pixel_params(target, p, aff, **kw),
                weights.blending_weights_pixel_params(target, p, aff, **kw),
            ):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["mixed_resolution_3d", "grid3d_fractional", "mixed_shapes_uint16"])
def test_translation_kernel_params_match_jax_exactly(name):
    jsims = _case(name)
    sims = _to_port(jsims)
    sdims = tsi.get_spatial_dims_from_sim(sims[0])
    osp = tcore.process_output_stack_properties(sims, transform_key=KEY)
    josp = jcore.process_output_stack_properties(jsims, transform_key=KEY)
    for k in ("shape", "spacing", "origin"):
        assert {d: float(osp[k][d]) for d in sdims} == {d: float(josp[k][d]) for d in sdims}
    plan = {"sparams": [np.asarray(s.transforms[KEY].data) for s in sims]}
    scale = tcore._views_output_scale(sims, osp, sdims)
    jscale = jcore._views_output_scale(jsims, josp, sdims)
    assert scale == jscale
    scale_arr = np.asarray(
        scale if scale is not None else tcore._views_output_scales_per_view(sims, osp, sdims)
    )
    got = tcore.translation_kernel_params(
        plan, [tsi.get_stack_properties_from_sim(s) for s in sims], osp, sdims,
        None, 0, scale_arr,
    )
    ref = jcore.translation_kernel_params(
        plan, [si_utils.get_stack_properties_from_sim(s) for s in jsims], josp, sdims,
        None, 0, scale_arr,
    )
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_tile_view_lists_match_the_reference_loop():
    """The vectorised per-tile view lists equal the reference's per-view
    AABB loop (fusion/_core.py:2094-2125): same views, ascending order."""
    from itertools import product

    rng = np.random.default_rng(7)
    V, ndim = 12, 3
    offs = (rng.normal(size=(V, ndim)) * 30).astype(np.float32)
    extents = rng.integers(5, 40, size=(V, ndim)).astype(np.float32)
    scale_arr = np.array([1.0, 1.5, 0.5])
    out_shape, tile_shape = (40, 50, 60), (4, 8, 32)
    got = tcore.tile_view_lists(offs, extents, scale_arr, out_shape, tile_shape)
    n_t = [-(-out_shape[d] // tile_shape[d]) for d in range(ndim)]
    lists = {}
    for v in range(V):
        lo = -offs[v] / scale_arr - 1
        hi = (extents[v] - offs[v]) / scale_arr + 1
        ranges = [
            range(max(0, int(np.floor(lo[d] / tile_shape[d]))),
                  min(n_t[d] - 1, int(np.floor(hi[d] / tile_shape[d]))) + 1)
            for d in range(ndim)
        ]
        for idx in product(*ranges):
            lists.setdefault(idx, []).append(v)
    K = max(len(v) for v in lists.values())
    ref = np.full(tuple(n_t) + (K,), -1, np.int32)
    for idx, vs in lists.items():
        ref[idx + (slice(0, len(vs)),)] = vs
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ndim", [2, 3])
def test_mv_graph_chunk_planning_matches_jax_exactly(ndim):
    rng = np.random.default_rng(11 + ndim)
    sdims, props = _layout_props(rng, ndim)
    array_bb = {
        "shape": {d: 100 for d in sdims},
        "spacing": {d: 0.9 for d in sdims},
        "origin": {d: 3.0 for d in sdims},
    }
    chunks = dict(zip(sdims, [17, 32, 40]))
    assert tmv.normalize_chunks([17, 32], [100, 20]) == mv_graph.normalize_chunks(
        [17, 32], [100, 20]
    )
    bbs, idx = tmv.get_chunk_bbs(array_bb, chunks)
    jbbs, jidx = mv_graph.get_chunk_bbs(array_bb, chunks)
    assert idx == jidx and bbs == jbbs
    for p in props:
        np.testing.assert_array_equal(
            tmv.get_vertices_from_stack_props(p), mv_graph.get_vertices_from_stack_props(p)
        )
        aff = np.eye(ndim + 1)
        aff[:ndim, ndim] = rng.normal(size=ndim) * 20
        for bb in bbs[:6]:
            kw = dict(additional_extent_in_pixels={d: 1 for d in sdims})
            assert tmv.get_overlap_for_bbs(bb, [p], aff, **kw) == mv_graph.get_overlap_for_bbs(
                bb, [p], aff, **kw
            )


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multiview_stitcher_torch as p\n"
        "import multiview_stitcher_torch.fusion\n"
        "import multiview_stitcher_torch.fusion._streaming\n"
        "import multiview_stitcher_torch.fusion.mv_deconv\n"
        "import multiview_stitcher_torch.metrics\n"
        "assert p.metrics.tile_pair_image_metrics and p.fusion.mv_deconv.PSFType\n"
        "import multiview_stitcher_torch.io.ngff_utils\n"
        "import multiview_stitcher_torch.io.zarr_backend\n"
        "import multiview_stitcher_torch.param_resolution\n"
        "import multiview_stitcher_torch.param_resolution.linear_two_pass\n"
        "import multiview_stitcher_torch.registration\n"
        "import multiview_stitcher_torch.registration_plugins\n"
        "import multiview_stitcher_torch.detection\n"
        "import multiview_stitcher_torch.stitch\n"
        "import multiview_stitcher_torch.ops.phase_correlation\n"
        "import multiview_stitcher_torch.ops.image_metrics\n"
        "import multiview_stitcher_torch.ops.filters\n"
        "import multiview_stitcher_torch.ops.resample\n"
        "from multiview_stitcher_torch.ops import link_codec\n"
        "assert link_codec.put_packed and link_codec.fetch_packed and link_codec.reassemble_packed\n"
        "import multiview_stitcher_torch.transformation\n"
        "import multiview_stitcher_torch.weights\n"
        "import multiview_stitcher_torch.zarr_utils\n"
        "from multiview_stitcher_torch.fusion import fuse_np, func_ignore_nan_warning\n"
        "import multiview_stitcher_torch.sample_data\n"
        "from multiview_stitcher_torch.fusion import prepare_block_fusion\n"
        "from multiview_stitcher_torch.parallel import executors, mesh, multihost, pipeline\n"
        "from multiview_stitcher_torch.utils import profiling\n"
        "from multiview_stitcher_torch import neuroglancer, vis_utils\n"
        "from multiview_stitcher_torch.io import virtual_ngff\n"
        "from multiview_stitcher_torch.service import bridge, session, specs, worker\n"
        "from multiview_stitcher_torch.service import Session, ProcessPoolBridge\n"
        "assert p.ngff_utils.serve_virtual_ome_zarrs and p.ngff_utils.VirtualOMEZarr\n"
        "assert p.spatial_image_utils.get_sim_field and p.misc_utils.ndindex_batches\n"
        "assert p.ngff_utils.read_ngff_multiscales\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'multiview_stitcher_tpu', 'networkx', 'pandas', 'tensorstore',\n"
        "     'triton', 'zarr', 'numcodecs', 'blosc', 'ants', 'itk', 'matplotlib', 'xarray'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_weighted_average_fusion_matches_jax():
    rng = np.random.default_rng(8)
    views = rng.random((3, 10, 12)).astype(np.float32)
    views[0, :2] = np.nan
    bw = rng.random((3, 10, 12)).astype(np.float32)
    fw = rng.random((3, 10, 12)).astype(np.float32)
    for f in (None, fw):
        ref = jcore.weighted_average_fusion(views, bw, f)
        got = tcore.weighted_average_fusion(
            torch.from_numpy(views), torch.from_numpy(bw),
            None if f is None else torch.from_numpy(f),
        )
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_halo_declarations_are_read_as_in_jax():
    from multiview_stitcher_torch.utils import misc as tmisc
    from multiview_stitcher_tpu.utils import misc as jmisc

    for m in (tmisc, jmisc):
        @m.requires_overlap(lambda kw: 2 * kw.get("sigma", 3))
        def func(transformed_views):
            return transformed_views

        assert m.get_required_overlap(func, {"sigma": 5}) == 10
        assert m.get_required_overlap(func, {}) == 6
        assert m.get_required_source_shrinkage(func, {}) == 0
        assert m.get_required_overlap(tcore.weighted_average_fusion, {}) == 0
