"""The port's multi-view deconvolution and registration-quality metrics
against the JAX package, in the cases of ``tests/test_metrics_and_deconv.py``
and the scene of ``examples/deconvolution.py``.

Inputs are made from a seed with numpy and go through the JAX function and
its port on the CPU (``device="cpu"``); JAX sims are carried over with
``convert.sim_from_numpy``. Tolerances:

- deconvolution outputs rtol 1e-4, atol 1e-3, dtypes equal (the same f32
  convolutions summed in another order drift by under 1e-6 relative after
  10 iterations); PSFs, compound kernels, erosions and halos exactly;
- metric values of the host loop within 1e-5 and of the batched NCC within
  1e-4 (the JAX package's own bound between its two paths), pair orders and
  comparison boxes exactly; SSIM within 1e-5;
- overlap geometry (``expand_halfspace``, ``get_mask_from_halfspace``) bit
  for bit.
"""

import networkx as nx
import numpy as np
import pytest
import torch
from scipy import ndimage, stats

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import metrics as tmetrics
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.fusion import mv_deconv as tdeconv
from multiview_stitcher_torch.ops import image_metrics as tim
from multiview_stitcher_tpu import fusion, metrics, msi_utils, mv_graph, param_utils
from multiview_stitcher_tpu import sample_data, si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import mv_deconv
from multiview_stitcher_tpu.ops import image_metrics as jim

KEY = si_utils.DEFAULT_TRANSFORM_KEY
TOL = dict(rtol=1e-4, atol=1e-3)
HOST_ATOL = 1e-5
BATCHED_ATOL = 1e-4
PSF_TYPES = ["EFFICIENT_BAYESIAN", "OPTIMIZATION_I", "OPTIMIZATION_II", "INDEPENDENT"]


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    """The JAX package's CPU defaults (no exact or shear tier) and empty
    device tile caches on both sides."""
    for var in ("MVS_TPU_EXACT_AFFINE", "MVS_TPU_SHEAR"):
        monkeypatch.delenv(var, raising=False)
    jcore.clear_device_tile_cache()
    tcore.clear_device_tile_cache()
    yield
    jcore.clear_device_tile_cache()
    tcore.clear_device_tile_cache()


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# deconvolution
# ---------------------------------------------------------------------------


def _make_views(n_views, shape, seed=0):
    """``TestMvDeconvReferenceScenarios._make_views``: Poisson ground truth
    seen by noisy views, uniform weights."""
    rng = np.random.default_rng(seed)
    gt = rng.poisson(100, shape).astype(np.float32)
    views = np.stack(
        [np.clip(gt + rng.normal(0, 5, shape), 0, None) for _ in range(n_views)]
    ).astype(np.float32)
    weights = np.ones((n_views, *shape), dtype=np.float32) / n_views
    return views, weights


def _beads(shape):
    """Two beads (three in 3D) blurred by a 1.5 px gaussian, as in
    ``TestMvDeconv.test_deconvolution_sharpens``."""
    img = np.zeros(shape, dtype=np.float32)
    if len(shape) == 2:
        img[24, 24] = 100.0
        img[10, 35] = 80.0
    else:
        img[8, 24, 24] = 100.0
        img[4, 10, 35] = 80.0
        img[12, 36, 12] = 90.0
    return img, ndimage.gaussian_filter(img, 1.5)


def _both_deconv(views, weights, **kw):
    ref = mv_deconv.multi_view_deconvolution(views, weights, **kw)
    got = tdeconv.multi_view_deconvolution(views, weights, device="cpu", **kw)
    _close(got, ref)
    return got, ref


def test_psfs_match_jax():
    for args in [(1.5, 2), (1.2, 3), (0.7, 2), ([1.0, 2.0, 0.5], None)]:
        np.testing.assert_array_equal(
            tdeconv.make_gaussian_psf(args[0], ndim=args[1]),
            mv_deconv.make_gaussian_psf(args[0], ndim=args[1]),
        )
    psf = tdeconv.make_gaussian_psf(1.5, ndim=2)
    assert psf.shape == (9, 9) and psf[4, 4] == psf.max()
    assert psf.sum() == pytest.approx(1.0, abs=1e-5)
    for spacing in ({"z": 2.0, "y": 0.5, "x": 0.5}, {"y": 1.0, "x": 1.0}):
        for na, wl in ((0.8, 0.5), (1.1, 0.6)):
            ref = mv_deconv.estimate_psf(spacing, na=na, wavelength_um=wl)
            got = tdeconv.estimate_psf(spacing, na=na, wavelength_um=wl)
            np.testing.assert_array_equal(got, ref)
            assert got.ndim == len(spacing)


@pytest.mark.parametrize("psf_type", PSF_TYPES)
def test_compound_kernels_match_jax(psf_type):
    psfs = [
        tdeconv.make_gaussian_psf(s, ndim=3, shape=(7, 7, 7)) for s in (1.0, 1.4, 0.8)
    ]
    for v in range(3):
        np.testing.assert_array_equal(
            tdeconv._compute_compound_kernel(v, psfs, tdeconv.PSFType(psf_type)),
            mv_deconv._compute_compound_kernel(v, psfs, mv_deconv.PSFType(psf_type)),
        )


@pytest.mark.parametrize("mode", ["mirror", "constant"])
@pytest.mark.parametrize("shape", [(11, 13), (3, 9), (6, 2, 10)])
def test_convolution_matches_scipy(mode, shape):
    """scipy's ``convolve``, on axes shorter than the kernel as well (the
    halo windows at a volume's edge)."""
    rng = np.random.default_rng(4)
    arr = rng.random(shape).astype(np.float32)
    kernel = rng.random((5,) * len(shape)).astype(np.float32)
    cval = 1.0 if mode == "constant" else 0.0
    ref = ndimage.convolve(arr.astype(np.float64), kernel.astype(np.float64), mode=mode,
                           cval=cval)
    got = tdeconv._jconvolve(torch.from_numpy(arr), torch.from_numpy(kernel), mode, cval)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3])
def test_erosion_is_scipy_binary_erosion(ndim):
    rng = np.random.default_rng(ndim)
    shape = (17, 23) if ndim == 2 else (9, 12, 14)
    mask = ndimage.gaussian_filter(rng.random(shape), 1.5) > 0.48
    for n in (1, 2, 3):
        ref = ndimage.binary_erosion(mask, iterations=n, border_value=1, brute_force=True)
        got = tdeconv._erode(torch.from_numpy(mask), n).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("psf_type", PSF_TYPES)
def test_deconvolution_sharpens_like_jax(psf_type, ndim):
    """``TestMvDeconv.test_deconvolution_sharpens`` in 2D and 3D: both
    packages give the same image, and the bead's peak at least doubles."""
    shape = (48, 48) if ndim == 2 else (16, 48, 48)
    img, blurred = _beads(shape)
    views = np.stack([blurred, blurred])
    weights = np.full((2,) + shape, 0.5, dtype=np.float32)
    psf = mv_deconv.make_gaussian_psf(1.5, ndim=ndim)
    got, _ = _both_deconv(views, weights, psfs=[psf, psf], psf_type=psf_type, n_iterations=10)
    peak = (24, 24) if ndim == 2 else (8, 24, 24)
    assert got[peak] > blurred[peak] * 2
    assert np.argmax(got) == np.argmax(img)


@pytest.mark.parametrize(
    "case",
    ["3d", "differing_psfs", "tikhonov", "nan_views", "output_spacing", "erosion",
     "three_views_weighted"],
)
def test_deconvolution_scenarios_match_jax(case):
    """``TestMvDeconvReferenceScenarios``, and NaN views eroded at the
    sample's boundary."""
    kw = {"n_iterations": 3}
    if case == "3d":
        views, weights = _make_views(2, (8, 24, 24))
        kw["n_iterations"] = 2
    elif case == "differing_psfs":
        views, weights = _make_views(2, (32, 32))
        kw["psfs"] = [mv_deconv.make_gaussian_psf(1.0, ndim=2),
                      mv_deconv.make_gaussian_psf(2.0, ndim=2)]
        assert kw["psfs"][0].shape != kw["psfs"][1].shape
    elif case == "tikhonov":
        views, weights = _make_views(2, (24, 24))
        kw["lambda_reg"] = 1e-3
    elif case in ("nan_views", "erosion"):
        views, weights = _make_views(2, (32, 32))
        views[0, :, 16:] = np.nan
        weights[0, :, 16:] = 0.0
        weights[1, :, 16:] = 1.0
        if case == "erosion":
            views[1, :3] = np.nan
            views[0, :3] = np.nan
            kw["sample_boundary_erosion_px"] = 2
    elif case == "output_spacing":
        views, weights = _make_views(2, (24, 24))
        kw.update(output_spacing={"y": 0.5, "x": 0.5}, na=0.8, wavelength_um=0.5,
                  n_iterations=2)
    else:
        views, weights = _make_views(3, (12, 20, 20), seed=5)
        rng = np.random.default_rng(5)
        weights = rng.random(views.shape).astype(np.float32)
        weights /= weights.sum(axis=0)
        views[2, :4] = np.nan
        kw["n_iterations"] = 10
    got, _ = _both_deconv(views, weights, **kw)
    assert got.shape == views.shape[1:] and np.all(np.isfinite(got))
    if case == "erosion":
        assert np.all(got[:5] == 0) and np.all(got[6:, :14] > 0)


def test_wrong_psf_count_raises_in_both():
    views, weights = _make_views(3, (16, 16))
    psfs = [mv_deconv.make_gaussian_psf(1.5, ndim=2)]
    for module, kw in ((mv_deconv, {}), (tdeconv, {"device": "cpu"})):
        with pytest.raises(ValueError, match="n_views"):
            module.multi_view_deconvolution(views, weights, psfs=psfs, n_iterations=1, **kw)


def test_deconvolution_keeps_tensors_and_dtypes():
    """Tensors stay tensors of their dtype; numpy arrays come back as numpy
    of theirs (uint16 truncated as numpy's ``astype`` truncates)."""
    views, weights = _make_views(2, (20, 20))
    ref = mv_deconv.multi_view_deconvolution(views.astype(np.uint16), weights, n_iterations=2)
    got = tdeconv.multi_view_deconvolution(views.astype(np.uint16), weights, n_iterations=2,
                                           device="cpu")
    assert got.dtype == ref.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    out = tdeconv.multi_view_deconvolution(torch.from_numpy(views), torch.from_numpy(weights),
                                           n_iterations=2)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    _close(out.numpy(), mv_deconv.multi_view_deconvolution(views, weights, n_iterations=2))


def test_required_overlap_matches_jax():
    for kw in ({}, None, {"output_spacing": {"z": 2.0, "y": 0.5, "x": 0.5}},
               {"output_spacing": {"y": 0.2, "x": 0.2}, "na": 0.5, "wavelength_um": 0.7}):
        assert tdeconv.multi_view_deconvolution.required_overlap(kw) == (
            mv_deconv.multi_view_deconvolution.required_overlap(kw)
        )


def _fuse_both(jsims, **kw):
    ref = fusion.fuse(jsims, fusion_func=mv_deconv.multi_view_deconvolution, **kw).to_numpy()
    got = tfuse(_to_port(jsims), fusion_func=tdeconv.multi_view_deconvolution, device="cpu",
                **kw).data
    _close(got, np.asarray(ref))
    return got


def test_deconv_through_fuse_matches_jax():
    """``TestMvDeconv.test_deconv_through_fuse``: the host tier, with the
    halo the function declares."""
    rng = np.random.default_rng(1)
    full = ndimage.gaussian_filter(rng.random((40, 70)).astype(np.float32), 1.0) * 50
    jsims = [
        si_utils.get_sim_from_array(full[:, :40], translation={"y": 0.0, "x": 0.0}),
        si_utils.get_sim_from_array(full[:, 30:], translation={"y": 0.0, "x": 30.0}),
    ]
    out = _fuse_both(jsims, transform_key=KEY, fusion_func_kwargs={"n_iterations": 3})
    assert out.shape == full.shape and out.max() > 0


@pytest.mark.parametrize("ndim", [2, 3])
def test_fuse_pipeline_matches_jax(ndim):
    """``test_fuse_pipeline``: the tiled sample dataset, dtype kept."""
    jsims = sample_data.generate_tiled_dataset(
        ndim=ndim, N_t=1, N_c=1, tile_size=20, tiles_x=2, tiles_y=2, tiles_z=1, overlap=4,
    )
    out = _fuse_both(jsims, transform_key="affine_metadata",
                     fusion_func_kwargs={"n_iterations": 3})
    assert out.dtype == jsims[0].dtype and np.all(np.isfinite(out))


def test_no_tile_border_artefacts_like_jax():
    """``test_no_tile_border_artefacts``: joint deconvolution through the
    port equals the JAX package's, and shows no seam against per-tile
    deconvolution."""
    np.random.seed(0)
    tile_size, overlap = 40, 30
    jsims = sample_data.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, overlap=overlap, tile_size=tile_size, tiles_x=2, tiles_y=1,
        tiles_z=1, shift_scale=0, drift_scale=0, zoom=10,
    )
    joint = _fuse_both(jsims, transform_key="affine_metadata").astype(np.float64)
    independent = []
    for sim in _to_port(jsims):
        dec = tfuse([sim], fusion_func=tdeconv.multi_view_deconvolution,
                    transform_key="affine_metadata", device="cpu")
        independent.append(tsi.get_sim_from_array(
            dec.data, dims=list(dec.dims), scale=tsi.get_spacing_from_sim(sim),
            translation=tsi.get_origin_from_sim(sim),
        ))
    ind = tfuse(independent, transform_key="affine_metadata", device="cpu").data.astype(
        np.float64)
    profiles = np.array([
        ind.reshape(-1, *ind.shape[-2:]).mean(0).mean(0),
        joint.reshape(-1, *joint.shape[-2:]).mean(0).mean(0),
    ])
    border_ids = np.array(
        [tile_size - overlap, tile_size, tile_size - overlap - 1, tile_size - 1])
    overlap_region_ids = np.arange(tile_size - overlap + 5, tile_size - 5)
    border_diffs = np.abs(profiles[0][border_ids] - profiles[1][border_ids])
    mean_overlap_diff = np.mean(
        np.abs(profiles[0][overlap_region_ids] - profiles[1][overlap_region_ids]))
    assert np.all(border_diffs <= 2 * mean_overlap_diff), (border_diffs, mean_overlap_diff)


def test_example_deconvolution_scene_matches_jax():
    """The scene of ``examples/deconvolution.py`` (run by
    ``tests/test_quickstart.py::test_example_deconvolution``) through both
    packages: equal deconvolved images, sharper than the weighted average."""
    rng = np.random.default_rng(0)
    truth = np.zeros((60, 90), dtype=np.float32)
    for p in rng.uniform(5, [55, 85], (40, 2)):
        truth[tuple(np.round(p).astype(int))] = 200.0
    truth += 5.0
    blurred = ndimage.gaussian_filter(truth, 1.5)
    jsims = [
        si_utils.get_sim_from_array(blurred[:, :55], translation={"y": 0.0, "x": 0.0}),
        si_utils.get_sim_from_array(blurred[:, 40:], translation={"y": 0.0, "x": 40.0}),
    ]
    psf = mv_deconv.make_gaussian_psf(1.5, ndim=2)
    deconv = _fuse_both(jsims, transform_key=KEY, fusion_func_kwargs={
        "psfs": [psf, psf], "n_iterations": 20, "psf_type": "INDEPENDENT"})
    avg = tfuse(_to_port(jsims), transform_key=KEY, device="cpu").data
    np.testing.assert_allclose(avg, fusion.fuse(jsims, transform_key=KEY).to_numpy(), **TOL)
    assert np.percentile(deconv, 99.9) > np.percentile(avg, 99.9)


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------


def _ncc_inputs(case):
    rng = np.random.default_rng(0)
    im = rng.random((20, 20))
    if case == "affine":
        a = np.random.default_rng(1).random((20, 20))
        return a, 2 * a + 3, 1.0
    if case == "affine_partial_nan":
        a = np.random.default_rng(1).random((20, 20))
        a2 = a.copy()
        a2[:5] = np.nan
        return a2, 2 * a + 3, 1.0
    if case == "identical":
        return im, im, 1.0
    if case == "anticorrelated":
        return im, -im, -1.0
    if case == "constant":
        return np.ones((20, 20)), rng.random((20, 20)), np.nan
    if case == "all_nan":
        nan = np.full((10, 10), np.nan)
        return nan, nan, np.nan
    im_nan = im.copy()
    im_nan[:5, :] = np.nan
    return im_nan, im_nan.copy(), 1.0


@pytest.mark.parametrize("case", ["affine", "affine_partial_nan", "identical",
                                  "anticorrelated", "constant", "all_nan", "partial_nan"])
def test_ncc_edge_cases_match_jax(case):
    """``TestNCCEdgeCases`` and ``TestMetrics.test_ncc``."""
    a, b, expect = _ncc_inputs(case)
    ref = metrics.normalized_cross_correlation(a, b)
    got = tmetrics.normalized_cross_correlation(a, b, device="cpu")
    if np.isnan(expect):
        assert np.isnan(got) and np.isnan(ref)
    else:
        assert got == pytest.approx(expect, abs=1e-6)
        assert got == pytest.approx(ref, abs=1e-12)


@pytest.mark.parametrize("case", ["plain", "nan", "clamped", "range", "constant", "all_nan",
                                  "3d"])
def test_structural_similarity_matches_jax(case):
    rng = np.random.default_rng(7)
    a = rng.random((30, 30)).astype(np.float32)
    b = a + 0.1 * rng.random((30, 30)).astype(np.float32)
    kw = {}
    if case == "nan":
        a[:5] = np.nan
        b[:5] = np.nan
        b[10, 10] = np.nan
    elif case == "clamped":
        a, b = a[:6], b[:6]
    elif case == "range":
        kw["data_range"] = 4.0
        kw["win_size"] = 5
    elif case == "constant":
        a, b = np.full((9, 9), 2.0), np.full((9, 9), 2.0)
    elif case == "all_nan":
        a = b = np.full((20, 20), np.nan)
    elif case == "3d":
        a = rng.random((9, 12, 14)).astype(np.float32)
        b = ndimage.gaussian_filter(a, 1.0)
    ref = metrics.structural_similarity(a, b, **kw)
    got = tmetrics.structural_similarity(a, b, device="cpu", **kw)
    if np.isnan(ref):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(ref, abs=HOST_ATOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_ssim_maps_match_jax(ndim):
    rng = np.random.default_rng(11 + ndim)
    shape = (24, 31) if ndim == 2 else (10, 14, 17)
    a = ndimage.gaussian_filter(rng.random(shape), 1.0).astype(np.float32)
    b = (a + 0.05 * rng.random(shape)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tim.ssim_map(ta, tb, 7, 1.0).numpy(),
                               np.asarray(jim.ssim_map(a, b, 7, 1.0)), rtol=1e-4, atol=1e-5)
    los, his = np.array([2, 3, 1][:ndim]), np.array([20, 13, 15][:ndim])
    ref = float(jim.ssim_mean_over_box(a, b, los, his, 5, 1.0))
    got = float(tim.ssim_mean_over_box(ta, tb, torch.from_numpy(los), torch.from_numpy(his), 5,
                                       1.0))
    assert got == pytest.approx(ref, abs=HOST_ATOL)
    assert float(tim.structural_similarity(ta, tb)) == pytest.approx(
        float(jim.structural_similarity(a, b)), abs=HOST_ATOL)


def test_masked_spearman_matches_scipy():
    """``test_masked_spearman_matches_scipy`` (marked slow for the JAX
    package; the port's runs in well under a second)."""
    rng = np.random.default_rng(7)
    checked = 0
    for trial in range(20):
        n = int(rng.integers(5, 80))
        a = rng.integers(0, int(rng.integers(2, 15)), n).astype(np.float32)
        b = rng.integers(0, int(rng.integers(2, 15)), n).astype(np.float32)
        mask = np.ones(n, bool) if trial % 2 == 0 else rng.random(n) > 0.4
        if mask.sum() < 3 or len(set(a[mask])) < 2 or len(set(b[mask])) < 2:
            continue
        ref = stats.spearmanr(a[mask], b[mask]).statistic
        got = float(tim.masked_spearman(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(mask), 1))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        checked += 1
    assert checked >= 10


# ---------------------------------------------------------------------------
# overlap geometry
# ---------------------------------------------------------------------------


def _stack_props(ndim, origin, shape, affine=None):
    sdims = ["z", "y", "x"][-ndim:]
    sp = {"origin": dict(zip(sdims, origin)), "spacing": {d: 1.0 for d in sdims},
          "shape": dict(zip(sdims, shape))}
    if affine is not None:
        sp["transform"] = affine
    return sp


def test_expand_halfspace_is_bit_equal():
    """Boxes expand in closed form to the halfspaces the reference's qhull
    object holds; a rotated pair's true halfspace intersection through
    scipy, as in the reference."""
    for ndim in (2, 3):
        lo = np.array([0.3, 1.0, -2.7][:ndim])
        up = np.array([10.1, 7.9, 3.3][:ndim])
        for d in (1e-3, 0.5, 3.0):
            got = tmv.expand_halfspace(tmv.BoxIntersection(lo, up), d)
            ref = mv_graph.expand_halfspace(mv_graph.BoxIntersection(lo, up), d)
            assert isinstance(got, tmv.BoxIntersection)
            np.testing.assert_array_equal(got.halfspaces, ref.halfspaces)
    rot = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    rot[1:3, 1:3] = [[c, -s], [s, c]]
    p1 = _stack_props(3, (0.0, 0.0, 0.0), (10, 20, 20))
    p2 = _stack_props(3, (2.0, 5.0, 4.0), (10, 20, 20), rot)
    _, t_int = tmv.get_overlap_between_pair_of_stack_props(p1, p2)
    _, j_int = mv_graph.get_overlap_between_pair_of_stack_props(p1, p2)
    assert not isinstance(t_int, tmv.BoxIntersection)
    got = tmv.expand_halfspace(t_int, 0.25)
    ref = mv_graph.expand_halfspace(j_int, 0.25)
    np.testing.assert_array_equal(got.halfspaces, ref.halfspaces)
    np.testing.assert_array_equal(got.intersections, ref.intersections)


def test_mask_from_halfspace_matches_jax():
    rng = np.random.default_rng(2)
    jsim = si_utils.get_sim_from_array(rng.random((9, 13, 11)).astype(np.float32),
                                       scale={"z": 2.0, "y": 0.5, "x": 0.7},
                                       translation={"z": 1.0, "y": -3.0, "x": 4.5})
    eqs = np.array([[0.2, -0.9, 0.3, -4.0], [-1.0, 0.0, 0.0, 6.0], [0.0, 0.6, 0.8, -6.0]])
    ref = mv_graph.get_mask_from_halfspace(jsim, eqs)
    got = tmv.get_mask_from_halfspace(_to_port([jsim])[0], eqs)
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# tile_pair_image_metrics
# ---------------------------------------------------------------------------


def _msims_both(jsims, scale_factors=()):
    sf = list(scale_factors)
    jm = [msi_utils.get_msim_from_sim(s, scale_factors=sf) for s in jsims]
    tm = [tmsi.get_msim_from_sim(s, scale_factors=sf) for s in _to_port(jsims)]
    return jm, tm


def _assert_metrics_equal(got, ref, atol):
    assert list(got["pairs"]) == list(ref["pairs"])
    for e, per_key in ref["pairs"].items():
        assert list(got["pairs"][e]) == list(per_key)
        for q, vals in per_key.items():
            assert list(got["pairs"][e][q]) == list(vals)
            for k, v in vals.items():
                g = got["pairs"][e][q][k]
                assert isinstance(g, float)
                if np.isnan(v):
                    assert np.isnan(g)
                else:
                    assert g == pytest.approx(v, abs=atol), (e, q, k)
        if ref["bboxes"][e] is None:
            assert got["bboxes"][e] is None
        else:
            for b in ("lower", "upper"):
                np.testing.assert_array_equal(got["bboxes"][e][b], ref["bboxes"][e][b])
    assert list(got["bboxes"]) == list(ref["bboxes"])
    for q, per_metric in ref["summary"].items():
        for k, v in per_metric.items():
            assert got["summary"][q][k] == pytest.approx(v, abs=atol, nan_ok=True)


def _both_metrics(jmsims, tmsims, metric_funcs=None, atol=BATCHED_ATOL, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if metric_funcs is not None:
        jkw["metric_funcs"], tkw["metric_funcs"] = metric_funcs
    ref = metrics.tile_pair_image_metrics(jmsims, **jkw)
    got = tmetrics.tile_pair_image_metrics(tmsims, device="cpu", **tkw)
    _assert_metrics_equal(got, ref, atol)
    return got, ref


def _pair_with_error(shift=(3.0, -2.0), seed=0):
    rng = np.random.default_rng(seed)
    full = ndimage.gaussian_filter(rng.random((60, 140)), 1.2) * 100
    sim0 = si_utils.get_sim_from_array(full[:, :80].astype(np.float32),
                                       translation={"y": 0.0, "x": 0.0})
    sim1 = si_utils.get_sim_from_array(full[:, 60:].astype(np.float32),
                                       translation={"y": shift[0], "x": 60.0 + shift[1]})
    return [sim0, sim1]


def test_registered_beats_metadata_like_jax():
    """``TestMetrics.test_registered_beats_metadata``: the port registers
    (on the CPU), both packages score the same keys."""
    jsims = _pair_with_error()
    jm, tm = _msims_both(jsims)
    treg.register(tm, transform_key=KEY, new_transform_key="registered",
                  pre_registration_pruning_method=None, device="cpu")
    for j, t in zip(jm, tm):
        msi_utils.set_affine_transform(
            j, param_utils.affine_to_xaffine(np.asarray(t.transforms["registered"].squeeze())),
            transform_key="registered")
    got, _ = _both_metrics(jm, tm, base_transform_key=KEY,
                           query_transform_keys=[KEY, "registered"])
    summary = got["summary"]
    assert summary["registered"]["ncc"] > summary[KEY]["ncc"]
    assert summary["registered"]["ncc"] > 0.9


@pytest.mark.parametrize("graph", ["port", "networkx"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_pairs_graph_mode_matches_jax(graph, bidirectional):
    """``TestMetrics.test_pairs_graph_mode``, with the port's graph or a
    user's networkx graph, in both directions."""
    jm, tm = _msims_both(_pair_with_error())
    jg = nx.Graph()
    jg.add_nodes_from([0, 1])
    mat = param_utils.affine_from_translation([3.0, -2.0])
    jg.add_edge(0, 1, transform=param_utils.affine_to_xaffine(mat))
    tg = nx.Graph() if graph == "networkx" else tmv.Graph()
    tg.add_nodes_from([0, 1])
    tg.add_edge(0, 1, transform=tpu.affine_to_xaffine(mat))
    kw = dict(base_transform_key=KEY, bidirectional=bidirectional)
    ref = metrics.tile_pair_image_metrics(jm, pairs_graph=jg, **kw)
    got = tmetrics.tile_pair_image_metrics(tm, pairs_graph=tg, device="cpu", **kw)
    _assert_metrics_equal(got, ref, BATCHED_ATOL)
    assert (0, 1) in got["pairs"] and got["summary"]["transform"]["ncc"] > 0.9
    with pytest.raises(ValueError, match="Exactly one"):
        tmetrics.tile_pair_image_metrics(tm, base_transform_key=KEY, device="cpu")


def _grid_3x2():
    return sample_data.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=40, tiles_x=3, tiles_y=2, overlap=10, zoom=3,
        shift_scale=1.0, drift_scale=0.0,
    )


def test_batched_ncc_matches_host_loop_and_jax():
    """``test_batched_ncc_matches_host_loop``: the port's batched NCC
    against its host loop (a wrapper that is not the default function) and
    both against the JAX package's."""
    jm, tm = _msims_both(_grid_3x2())
    kw = dict(base_transform_key=KEY, query_transform_keys=[KEY])
    batched, _ = _both_metrics(jm, tm, **kw)
    host, _ = _both_metrics(
        jm, tm, atol=HOST_ATOL,
        metric_funcs=(
            {"ncc": lambda a, b: metrics.normalized_cross_correlation(a, b)},
            {"ncc": lambda a, b: tmetrics.normalized_cross_correlation(a, b, device="cpu")},
        ),
        **kw,
    )
    assert tmetrics.last_telemetry["host_loop_s"] > 0
    assert list(batched["pairs"]) == list(host["pairs"])
    for e in batched["pairs"]:
        assert batched["pairs"][e][KEY]["ncc"] == pytest.approx(
            host["pairs"][e][KEY]["ncc"], abs=BATCHED_ATOL)
    assert batched["summary"][KEY]["ncc"] == pytest.approx(host["summary"][KEY]["ncc"],
                                                           abs=BATCHED_ATOL)


def test_bidirectional_pair_order_matches_jax():
    """Directed pairs come in DiGraph adjacency order, (i, j) and (j, i)
    under each node, as in the JAX package, on a 3 x 2 grid."""
    jm, tm = _msims_both(_grid_3x2())
    got, ref = _both_metrics(jm, tm, base_transform_key=KEY, query_transform_keys=[KEY],
                             bidirectional=True)
    pairs = list(got["pairs"])
    assert len(pairs) == 2 * len(set(tuple(sorted(p)) for p in pairs))
    assert pairs == list(ref["pairs"])
    assert pairs != sorted(pairs, key=lambda p: (min(p), max(p), p[0] > p[1]))


def _mosaic_pair(seed):
    rng = np.random.default_rng(seed)
    full = rng.random((40, 70)).astype(np.float32)
    jsims = [
        si_utils.get_sim_from_array(full[:, :40].copy(), translation={"y": 0.0, "x": 0.0}),
        si_utils.get_sim_from_array(full[:, 30:].copy(), translation={"y": 0.0, "x": 30.0}),
    ]
    return jsims, rng


def test_custom_metric_and_tolerance_match_jax():
    """``test_tile_pair_metrics_custom_metric_and_tolerance``."""
    jsims, _ = _mosaic_pair(6)
    for s in jsims:
        si_utils.set_sim_affine(s, np.eye(3), transform_key="registered")
    jm, tm = _msims_both(jsims)
    calls = {}

    def my_metric(a, b):
        calls["types"] = (type(a), type(b))
        return float(np.nanmean(np.abs(a - b)))

    got, _ = _both_metrics(jm, tm, metric_funcs=({"mad": my_metric}, {"mad": my_metric}),
                           atol=HOST_ATOL, base_transform_key=KEY,
                           query_transform_keys=["registered"], max_tolerance=2.0)
    assert calls["types"] == (np.ndarray, np.ndarray)
    assert got["pairs"]
    for per_key in got["pairs"].values():
        assert per_key["registered"]["mad"] < 1e-5
    assert "mad" in got["summary"]["registered"]


def test_importable_ssim_matches_jax():
    """``test_tile_pair_metrics_importable_ssim``: NCC and SSIM through the
    host loop (the SSIM gets the call's device)."""
    jsims, _ = _mosaic_pair(7)
    jm, tm = _msims_both(jsims)
    got, _ = _both_metrics(
        jm, tm, atol=HOST_ATOL,
        metric_funcs=(
            {"ncc": metrics.normalized_cross_correlation, "ssim": metrics.structural_similarity},
            {"ncc": tmetrics.normalized_cross_correlation,
             "ssim": tmetrics.structural_similarity},
        ),
        base_transform_key=KEY, query_transform_keys=[KEY], max_tolerance=2.0,
    )
    for per_key in got["pairs"].values():
        assert per_key[KEY]["ssim"] > 0.99 and per_key[KEY]["ncc"] > 0.99


def test_return_structure_and_single_key_match_jax():
    """``test_tile_pair_image_metrics_return_structure``."""
    jsims = sample_data.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=40, tiles_x=2, tiles_y=1, overlap=10, zoom=4,
        shift_scale=0.0, drift_scale=0.0, transform_key="gt",
    )
    jm, tm = _msims_both(jsims)
    got, _ = _both_metrics(
        jm, tm, metric_funcs=({"ncc": metrics.normalized_cross_correlation},
                              {"ncc": tmetrics.normalized_cross_correlation}),
        base_transform_key="gt", query_transform_keys="gt",
    )
    assert set(got) >= {"pairs", "summary"} and len(got["pairs"]) == 1
    ((pair, pair_metrics),) = got["pairs"].items()
    assert isinstance(pair, tuple) and len(pair) == 2
    assert isinstance(pair_metrics["gt"]["ncc"], float)


@pytest.mark.parametrize("kw", [{"max_tolerance": 1.0}, {"spacing": {"y": 1.0, "x": 1.0}},
                                {"spacing": {"y": 2.0, "x": 2.0}},
                                {"max_tolerance": {"y": 0.5, "x": 3.0}}])
def test_spacing_and_tolerance_kwargs_match_jax(kw):
    """``test_tile_pair_image_metrics_spacing_and_tolerance_kwargs``, with a
    pyramid so that ``spacing`` picks a level per pair."""
    jsims = sample_data.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=60, tiles_x=2, tiles_y=1, overlap=20, zoom=6,
        shift_scale=0.0, drift_scale=0.0, transform_key="gt",
    )
    jm, tm = _msims_both(jsims, scale_factors=[{"y": 2, "x": 2}])
    got, _ = _both_metrics(jm, tm, base_transform_key="gt", query_transform_keys=["gt"], **kw)
    assert len(got["pairs"]) == 1 and got["summary"]["gt"]["ncc"] > 0.9


def test_input_res_level_and_channel_match_jax():
    """A coarser pyramid level and a chosen channel of (c, y, x) views."""
    jsims = sample_data.generate_tiled_dataset(
        ndim=2, N_c=2, N_t=1, tile_size=48, tiles_x=2, tiles_y=2, overlap=16, zoom=4,
        shift_scale=1.0, drift_scale=0.0,
    )
    jm, tm = _msims_both(jsims, scale_factors=[{"y": 2, "x": 2}])
    c1 = np.asarray(jsims[0].coords["c"])[1]
    _both_metrics(jm, tm, base_transform_key=KEY, query_transform_keys=[KEY],
                  input_res_level=1, metric_channel=c1, n_parallel_pairs=2)
