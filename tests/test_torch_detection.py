"""The port's bead detection and point sets against the JAX package.

``log_detect`` and ``detect_beads`` of ``multiview_stitcher_torch.detection``
(the filters in torch on the CPU, ``device="cpu"``) against
``multiview_stitcher_tpu.detection`` on the same images: well-separated
Gaussian beads on noise, made from a seed with numpy. Tolerances: label
images equal, bead counts equal and centroids within 1e-4 px; point-set
selections equal.
"""

import numpy as np
import pytest
from scipy import ndimage

from multiview_stitcher_torch import detection as tdet
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.utils import misc as tmisc
from multiview_stitcher_tpu import detection as jdet
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import si_utils as jsi
from multiview_stitcher_tpu.utils import misc as jmisc

CENTROID_ATOL = 1e-4


def _bead_image(shape, n, seed, min_dist=6.0, sigma=1.2, dtype=np.float32):
    """``n`` beads at least ``min_dist`` px apart and 4 px inside, Gaussian
    blobs of ``sigma`` with amplitude 1000 +- 20 % on noise of sigma 1."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(shape)
    pos = []
    while len(pos) < n:
        p = rng.uniform(4, shape - 5)
        if all(np.linalg.norm(p - q) >= min_dist for q in pos):
            pos.append(p)
    img = np.zeros(tuple(shape), np.float32)
    for p in pos:
        img[tuple(np.round(p).astype(int))] += rng.uniform(800, 1200)
    img = ndimage.gaussian_filter(img, sigma) + rng.normal(0, 1, img.shape)
    return (img * 10 + 100).astype(dtype), np.asarray(pos)


def _sims(img, spacing, origin):
    sdims = ["z", "y", "x"][-img.ndim:]
    kw = dict(scale=dict(zip(sdims, spacing)), translation=dict(zip(sdims, origin)))
    return jsi.get_sim_from_array(img, **kw), tsi.get_sim_from_array(img, **kw)


def _assert_points_equal(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=CENTROID_ATOL, rtol=0)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_log_detect_matches_jax(ndim, dtype):
    shape = (96, 112) if ndim == 2 else (32, 48, 56)
    img, pos = _bead_image(shape, 24, seed=ndim, dtype=dtype)
    spacing = (1.0,) * ndim
    ref = jdet.log_detect(img, spacing, target_size_physical=3.0)
    got = tdet.log_detect(img, spacing, target_size_physical=3.0, device="cpu")
    assert got.max() == ref.max() == len(pos)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "kw",
    [
        dict(target_size_physical=4.0, threshold_abs=80.0),
        dict(target_size_physical=4.0, threshold_rel=0.5),
        dict(target_size_physical={"x": 8.0, "y": 4.0}, max_neigh_intensity=1e9,
             max_neigh_sigma={"x": 4.0, "y": 2.0}, max_neigh_sample_size={"x": 8.0, "y": 4.0}),
        dict(target_size_physical=4.0, max_neigh_intensity=400.0),
    ],
    ids=["threshold_abs", "threshold_rel", "dict_max_neigh", "max_neigh_intensity"],
)
def test_log_detect_options_match_jax(kw):
    img, _ = _bead_image((80, 96), 16, seed=7)
    spacing = {"y": 1.0, "x": 2.0} if isinstance(kw["target_size_physical"], dict) else (1.0, 1.0)
    ref = jdet.log_detect(img, spacing, **kw)
    got = tdet.log_detect(img, spacing, device="cpu", **kw)
    assert ref.max() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ndim,chunksize", [(2, None), (2, 40), (3, None), (3, 20)])
def test_detect_beads_matches_jax(ndim, chunksize):
    """Whole-image and chunked scans (beads on chunk borders kept once by
    the halo dedup), in intrinsic physical coordinates."""
    shape = (90, 100) if ndim == 2 else (30, 44, 50)
    img, pos = _bead_image(shape, 20, seed=10 + ndim, dtype=np.uint16)
    spacing = (0.5,) * ndim if ndim == 2 else (2.0, 0.5, 0.5)
    origin = (5.0, -2.0) if ndim == 2 else (1.0, 5.0, -2.0)
    jsim, tsim = _sims(img, spacing, origin)
    kwargs = {"target_size_physical": 1.5, "threshold_abs": 50.0}
    ref = jdet.detect_beads(jsim, detection_func_kwargs=kwargs, chunksize=chunksize)
    got = tdet.detect_beads(tsim, detection_func_kwargs=kwargs, chunksize=chunksize,
                            device="cpu")
    _assert_points_equal(got, ref)
    assert len(got) == len(pos)
    if chunksize is not None:
        whole = tdet.detect_beads(tsim, detection_func_kwargs=kwargs, device="cpu")
        assert len(whole) == len(got)


def test_detect_beads_telemetry_counts_windows():
    img, _ = _bead_image((64, 64), 8, seed=3)
    _, tsim = _sims(img, (1.0, 1.0), (0.0, 0.0))
    tdet.detect_beads(tsim, detection_func_kwargs={"target_size_physical": 3.0}, chunksize=32,
                      device="cpu")
    t = tdet.last_telemetry
    assert t["windows"] == 4 and t["voxels"] >= 64 * 64
    assert all(t[k] >= 0 for k in ("upload_s", "filters_s", "download_s", "label_s"))


def test_detect_beads_max_detection_spacing_matches_jax():
    img, _ = _bead_image((128, 128), 12, seed=5, sigma=2.5)
    jsim, tsim = _sims(img, (1.0, 1.0), (0.0, 0.0))
    jm = jmsi.get_msim_from_sim(jsim, scale_factors=[2])
    tm = tmsi.get_msim_from_sim(tsim, scale_factors=[2])
    kw = dict(detection_func_kwargs={"target_size_physical": 6.0}, max_detection_spacing=2.0)
    ref = jdet.detect_beads(jm, **kw)
    got = tdet.detect_beads(tm, device="cpu", **kw)
    _assert_points_equal(got, ref)
    assert len(got) > 5
    assert tdet.last_telemetry["voxels"] == 64 * 64  # level 1, spacing 2


def test_detect_beads_custom_detection_func_matches_jax():
    img = np.zeros((64, 64), np.float32)
    img[10, 12] = img[40, 50] = img[31, 33] = 100.0
    jsim = jsi.get_sim_from_array(img, dims=("y", "x"), scale={"y": 0.5, "x": 2.0},
                                  translation={"y": 0.0, "x": 0.0})
    tsim = tsi.get_sim_from_array(img, dims=("y", "x"), scale={"y": 0.5, "x": 2.0},
                                  translation={"y": 0.0, "x": 0.0})
    seen = []

    def my_detect(image, spacing=None, threshold=50.0):
        seen.append(type(image))
        return ndimage.label(np.asarray(image) > threshold)[0]

    kw = dict(detection_func=my_detect, chunksize=32, detection_overlap=4)
    ref = jdet.detect_beads(jsim, **kw)
    seen.clear()
    got = tdet.detect_beads(tsim, device="cpu", **kw)
    assert seen and all(t is np.ndarray for t in seen)
    _assert_points_equal(got, ref)
    assert {tuple(p) for p in np.round(got, 3)} == {(5.0, 24.0), (20.0, 100.0), (15.5, 66.0)}


def test_detect_beads_non_spatial_dims_take_the_first_coordinate():
    img, _ = _bead_image((48, 48), 6, seed=9)
    stack = np.stack([img, np.zeros_like(img)])
    jsim = jsi.get_sim_from_array(stack, dims=("c", "y", "x"))
    tsim = tsi.get_sim_from_array(stack, dims=("c", "y", "x"))
    kw = dict(detection_func_kwargs={"target_size_physical": 3.0})
    _assert_points_equal(tdet.detect_beads(tsim, device="cpu", **kw), jdet.detect_beads(jsim, **kw))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"target_size_physical": 6.0, "spacing": {"y": 1.0, "x": 2.0}},
        {"target_size_physical": 6.0, "spacing": (1.0, 2.0, 0.5)},
        {"target_size_physical": {"x": 8.0, "y": 2.0}, "spacing": {"y": 1.0, "x": 4.0}},
    ],
)
def test_required_overlap_matches_jax(kwargs):
    got = tmisc.get_required_overlap(tdet.log_detect, kwargs)
    assert got == jmisc.get_required_overlap(jdet.log_detect, kwargs)


def test_required_overlap_dict_keys_must_match():
    with pytest.raises(TypeError, match="must match spacing keys"):
        tmisc.get_required_overlap(
            tdet.log_detect,
            {"target_size_physical": {"z": 8.0}, "spacing": {"y": 1.0, "x": 4.0}},
        )


def test_extract_core_label_centroids_matches_center_of_mass():
    """The sparse centroids equal scipy's center_of_mass to the bit."""
    rng = np.random.default_rng(0)
    labels = ndimage.label(rng.random((40, 50, 30)) > 0.93)[0]
    ids = np.unique(labels)[1:]
    ref = np.asarray(ndimage.center_of_mass(labels, labels=labels, index=ids))
    got = tdet._extract_core_label_centroids(labels, (0, 0, 0), labels.shape, (0, 0, 0))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jdet._extract_core_label_centroids(labels, (0, 0, 0), labels.shape, (0, 0, 0))
    )
    with pytest.raises(TypeError, match="integer"):
        tdet._extract_core_label_centroids(labels.astype(float), (0,) * 3, labels.shape, (0,) * 3)


def test_log_detect_without_device_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: log_detect runs there by default")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.log_detect(np.zeros((8, 8), np.float32), (1.0, 1.0), target_size_physical=2.0)


# ---------------------------------------------------------------------------
# point sets
# ---------------------------------------------------------------------------


def _point_sims():
    img = np.zeros((20, 30), np.float32)
    pts = np.array([[1.0, 2.0], [5.5, 10.0], [9.0, 14.5], [3.0, 28.0]])
    kw = dict(scale={"y": 0.5, "x": 1.0}, translation={"y": 0.0, "x": 0.0})
    jsim, tsim = jsi.get_sim_from_array(img, **kw), tsi.get_sim_from_array(img, **kw)
    jsi.set_point_set(jsim, pts)
    tsi.set_point_set(tsim, pts)
    return jsim, tsim, pts


@pytest.mark.parametrize(
    "sel",
    [
        {"y": slice(2.0, 8.0)},
        {"y": slice(0.3, 9.0), "x": slice(-1.0, 14.6)},
        {"x": slice(9.9, 40.0)},
    ],
)
def test_sim_sel_coords_crops_point_sets_as_jax(sel):
    jsim, tsim, _ = _point_sims()
    ref = jsi.sim_sel_coords(jsim, sel)
    got = tsi.sim_sel_coords(tsim, sel)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(tsi.get_point_set(got), jsi.get_point_set(ref))


@pytest.mark.parametrize("sel", [{"y": slice(1.0, 5.5)}, {"x": 10.0}, {"y": 9.0, "x": 14.5}])
def test_point_set_sel_coords_matches_jax(sel):
    _, _, pts = _point_sims()
    np.testing.assert_array_equal(
        tsi.point_set_sel_coords(pts, sel, sdims=("y", "x")),
        jsi.point_set_sel_coords(pts, sel, sdims=("y", "x")),
    )


def test_point_sets_through_msims_as_jax():
    jsim, tsim, pts = _point_sims()
    jm = jmsi.get_msim_from_sim(jsim, scale_factors=[2])
    tm = tmsi.get_msim_from_sim(tsim, scale_factors=[2])
    # kept by the pyramid: every level carries the sim's point set
    for s in tm.sims:
        np.testing.assert_array_equal(tsi.get_point_set(s), pts)
    other = pts[:2] + 0.25
    jmsi.set_point_set(jm, other, points_key="other")
    tmsi.set_point_set(tm, other, points_key="other")
    np.testing.assert_array_equal(tmsi.get_point_set(tm, "other"), jmsi.get_point_set(jm, "other"))
    for key in ("beads", "other"):
        for level in ("scale0", "scale1"):
            np.testing.assert_array_equal(
                tsi.get_point_set(tm.get_scale(level), key),
                jsi.get_point_set(jm.get_scale(level), key),
            )
    # a spatial selection of every level crops their point sets
    sel = {"y": slice(2.0, 8.0)}
    jsel = jmsi.multiscale_sel_coords(jm, sel)
    tsel = tmsi.multiscale_sel_coords(tm, sel)
    for js, ts in zip(jsel.sims, tsel.sims):
        np.testing.assert_array_equal(tsi.get_point_set(ts), jsi.get_point_set(js))
