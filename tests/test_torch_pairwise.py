"""The port's per-pair registration path against the JAX package.

Marker-based registration (descriptors, matching, RANSAC, ICP), the point
sets through ``register()``, ``register_pair_of_msims`` in its three spaces
and over ``t``, the step-by-step phase correlation, ``pairwise_executor``,
the linear two-pass resolution, the ``keep_axis_aligned`` pruning, pairs from
sample masks, the registration plugins with stand-in backends and the
point-set estimators. Inputs are made from a seed with numpy and go through
the JAX function and its port on the CPU (``device="cpu"``). Tolerances:
estimators within 1e-10; marker affines within 1e-9 and qualities equal;
``register()`` and ``linear_two_pass`` params within 1e-6 on point inputs
and 1e-3 on image inputs; the per-pair phase correlation within 1e-3 px.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import networkx as nx
import numpy as np
import pytest
from scipy import ndimage

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import param_resolution as tpr
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import registration_plugins as trp
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import transforms as ttf
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import mv_graph as jmv
from multiview_stitcher_tpu import param_resolution as jpr
from multiview_stitcher_tpu import param_utils as jpu
from multiview_stitcher_tpu import registration as jreg
from multiview_stitcher_tpu import sample_data
from multiview_stitcher_tpu import si_utils as jsi
from multiview_stitcher_tpu import transforms as jtf

KEY = jsi.DEFAULT_TRANSFORM_KEY
EST_ATOL = 1e-10
MARKER_ATOL = 1e-9
POINT_PARAM_ATOL = 1e-6
IMAGE_PARAM_ATOL = 1e-3
SHIFT_ATOL = 1e-3


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _mat(x):
    m = np.asarray(x.squeeze() if hasattr(x, "squeeze") else x, dtype=float)
    return m[0] if m.ndim == 3 else m


def _rot(ndim, rng, scale=0.2):
    if ndim == 2:
        th = rng.uniform(-scale, scale)
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.uniform(-scale, scale, 3)).as_matrix()


# ---------------------------------------------------------------------------
# point-set estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", ["translation", "rigid", "similarity", "affine"])
def test_estimators_match_jax(ndim, kind):
    rng = np.random.default_rng(ndim * 10 + len(kind))
    src = rng.uniform(-50, 50, (30, ndim))
    dst = 1.1 * src @ _rot(ndim, rng).T + rng.uniform(-5, 5, ndim) + rng.normal(0, 0.1, src.shape)
    ref = jtf.estimate_transform(kind, src, dst)
    np.testing.assert_allclose(ttf.estimate_transform(kind, src, dst), ref, atol=EST_ATOL, rtol=0)
    if kind in ("rigid", "similarity"):
        fn = getattr(ttf, f"estimate_{kind}")
        np.testing.assert_allclose(fn(src, dst), getattr(jtf, f"estimate_{kind}")(src, dst),
                                   atol=EST_ATOL, rtol=0)


def test_estimators_degenerate_and_affine_fit_match_jax():
    rng = np.random.default_rng(3)
    # collinear points: rank ndim - 1, and a single point: rank 0
    line = np.outer(np.arange(5.0), [1.0, 2.0, 0.5])
    for src in (line, line[:1]):
        dst = src + 1.0
        np.testing.assert_allclose(ttf.estimate_rigid(src, dst), jtf.estimate_rigid(src, dst),
                                   atol=EST_ATOL, rtol=0, equal_nan=True)
    src = rng.uniform(0, 10, (12, 3))
    dst = src @ rng.normal(size=(3, 3)).T + 1.0
    got, ref = ttf.Affine_Fit(src, dst), jtf.Affine_Fit(src, dst)
    np.testing.assert_allclose(got.Matrix(), ref.Matrix(), atol=EST_ATOL, rtol=0)
    np.testing.assert_allclose(got.Transform(src[0]), ref.Transform(src[0]), atol=EST_ATOL)
    for bad in ((src, dst[:4]), (src[:2], dst[:2])):
        with pytest.raises(ValueError):
            ttf.Affine_Fit(*bad)


# ---------------------------------------------------------------------------
# marker-based registration
# ---------------------------------------------------------------------------


def _marker_pair(ndim, kind, seed, n=60, outliers=0, noise=0.0):
    rng = np.random.default_rng(seed)
    fixed = rng.uniform(0, 100, (n, ndim))
    lin = np.eye(ndim) if kind == "translation" else _rot(ndim, rng)
    if kind == "affine":
        lin = lin @ (np.eye(ndim) + rng.uniform(-0.05, 0.05, (ndim, ndim)))
    moving = fixed @ lin.T + rng.uniform(-6, 6, ndim) + rng.normal(0, noise, (n, ndim))
    if outliers:
        moving = np.concatenate([moving, rng.uniform(0, 100, (outliers, ndim))])
    return fixed, rng.permutation(moving)


def test_marker_helpers_match_jax():
    fixed, moving = _marker_pair(3, "rigid", seed=1, outliers=5)
    for pts in (fixed, moving):
        gv, gi = treg._marker_descriptors(pts, 3, 1)
        rv, ri = jreg._marker_descriptors(pts, 3, 1)
        np.testing.assert_allclose(gv, rv, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(gi, ri)
    assert treg._marker_auto_threshold(fixed, moving, 3, 1.5) == jreg._marker_auto_threshold(
        fixed, moving, 3, 1.5
    )
    fv, fi = jreg._marker_descriptors(fixed, 3, 1)
    mv, mi = jreg._marker_descriptors(moving, 3, 1)
    thr = jreg._marker_auto_threshold(fixed, moving, 3, 1.0)
    pairs = treg._match_descriptors(fv, fi, mv, mi, 3.0, thr)
    np.testing.assert_array_equal(pairs, jreg._match_descriptors(fv, fi, mv, mi, 3.0, thr))
    for kind, ndim in (("translation", 1), ("rigid", 3), ("affine", 4)):
        assert treg._marker_min_matches(kind, 3) == ndim == jreg._marker_min_matches(kind, 3)
    # RANSAC over every sample (few candidates) and over random draws
    for cand in (pairs[:8], pairs):
        args = (fixed, moving, cand, "rigid", 2.0, 0.1, 1.0, 100, 5)
        got, ref = treg._run_marker_ransac(*args), jreg._run_marker_ransac(*args)
        np.testing.assert_allclose(got[0], ref[0], atol=MARKER_ATOL, rtol=0)
        assert got[1] == ref[1]
    init = np.eye(4)
    init[:3, 3] = 1.0
    args = (fixed, moving, init, 0.2, "rigid", 20.0, 50, 1e-6)
    got, ref = treg._run_marker_icp(*args), jreg._run_marker_icp(*args)
    np.testing.assert_allclose(got[0], ref[0], atol=MARKER_ATOL, rtol=0)
    assert got[1] == ref[1]
    with pytest.raises(ValueError, match="Unsupported"):
        treg._marker_min_matches("projective", 2)


@pytest.mark.parametrize(
    "ndim,kind,extra",
    [
        (2, "translation", {}),
        (2, "rigid", {}),
        (3, "rigid", {}),
        (3, "affine", {}),
        (2, "translation", {"outliers": 12, "ransac_min_inlier_ratio": 0.05}),
        (3, "rigid", {"noise": 0.05, "icp": True}),
        (2, "rigid", {"noise": 0.05, "icp": True, "icp_max_error": 1.0}),
        (3, "rigid", {"outliers": 10, "ransac_num_iterations": 200, "random_state": 3}),
    ],
    ids=["t2", "r2", "r3", "a3", "outliers", "icp3", "icp2", "draws"],
)
def test_registration_marker_based_matches_jax(ndim, kind, extra):
    extra = dict(extra)
    fixed, moving = _marker_pair(ndim, kind, seed=ndim + len(kind),
                                 outliers=extra.pop("outliers", 0),
                                 noise=extra.pop("noise", 0.0))
    ref = jreg.registration_marker_based(fixed, moving, transform_type=kind, **extra)
    got = treg.registration_marker_based(fixed, moving, transform_type=kind, **extra)
    np.testing.assert_allclose(got["affine_matrix"], ref["affine_matrix"], atol=MARKER_ATOL,
                               rtol=0)
    assert got["quality"] == ref["quality"]
    assert ref["quality"] > 0.5


def test_registration_marker_based_failure_matches_jax():
    rng = np.random.default_rng(3)
    fixed = rng.uniform(0, 100, (10, 2))
    moving = rng.uniform(0, 100, (10, 2))
    with pytest.warns(UserWarning):
        ref = jreg.registration_marker_based(fixed, moving, fail_on_error=False)
    with pytest.warns(UserWarning):
        got = treg.registration_marker_based(fixed, moving, fail_on_error=False)
    np.testing.assert_array_equal(got["affine_matrix"], ref["affine_matrix"])
    assert np.isnan(got["quality"]) == np.isnan(ref["quality"])
    with pytest.raises(ValueError):
        treg.registration_marker_based(fixed, moving)
    with pytest.raises(ValueError, match="dimensionality"):
        treg.registration_marker_based(fixed, rng.uniform(0, 1, (10, 3)))
    with pytest.warns(UserWarning, match="empty"):
        out = treg.registration_marker_based(fixed[:0], moving, fail_on_error=False)
    np.testing.assert_array_equal(out["affine_matrix"], np.eye(3))


# ---------------------------------------------------------------------------
# marker points through register()
# ---------------------------------------------------------------------------


def _marker_msims(si, mi, beads, offsets):
    msims = []
    for offset in offsets:
        sim = si.get_sim_from_array(np.zeros((100, 100), np.float32),
                                    translation={"y": 0.0, "x": 0.0})
        m = mi.get_msim_from_sim(sim, scale_factors=[])
        mi.set_point_set(m, beads + offset)
        msims.append(m)
    return msims


@pytest.mark.parametrize("method", ["global_optimization", "linear_two_pass", "shortest_paths"])
def test_register_with_marker_points_matches_jax(method):
    rng = np.random.default_rng(4)
    beads = rng.uniform(5, 95, (50, 2))
    offsets = [np.zeros(2), np.array([1.5, -2.5]), np.array([-3.0, 0.75])]
    kw = dict(
        transform_key=KEY, pairwise_reg_func_kwargs={"transform_type": "translation"},
        pre_registration_pruning_method=None, groupwise_resolution_method=method,
        return_dict=True,
    )
    if method != "shortest_paths":
        kw["groupwise_resolution_kwargs"] = {"transform": "translation"}
    ref = jreg.register(_marker_msims(jsi, jmsi, beads, offsets),
                        pairwise_reg_func=jreg.registration_marker_based, **kw)
    got = treg.register(_marker_msims(tsi, tmsi, beads, offsets),
                        pairwise_reg_func=treg.registration_marker_based, device="cpu", **kw)
    for p, r in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(_mat(p), _mat(r), atol=POINT_PARAM_ATOL, rtol=0)
    # the resolved params cancel the markers' displacements
    for p, off in zip(got["params"], offsets):
        np.testing.assert_allclose(_mat(p)[:2, 2] - _mat(got["params"][0])[:2, 2], -off,
                                   atol=1e-6)
    rq = ref["pairwise_registration"]["metrics"]["qualities"]
    gq = got["pairwise_registration"]["metrics"]["qualities"]
    assert gq == rq
    assert treg.last_telemetry["route"] == "per_pair"


def test_register_marker_dummy_points_stage_offset_matches_jax():
    """Two views whose shared markers differ by a pure stage offset: high
    pairwise quality, as the reference's test asserts."""
    rng = np.random.default_rng(7)
    base_points = rng.uniform(2.0, 18.0, size=(12, 2))
    outs = []
    for si, mi, reg, extra in ((jsi, jmsi, jreg, {}), (tsi, tmsi, treg, {"device": "cpu"})):
        sims = []
        for x_origin in [0.0, 5.0]:
            sim = si.get_sim_from_array(np.zeros((20, 20)), dims=["y", "x"],
                                        translation={"y": 0.0, "x": x_origin},
                                        transform_key="stage")
            si.set_point_set(sim, base_points + np.array([0.0, x_origin]))
            sims.append(sim)
        outs.append(reg.register(
            [mi.get_msim_from_sim(s, scale_factors=[]) for s in sims], transform_key="stage",
            reg_channel_index=0, registration_binning={"y": 1, "x": 1},
            pairwise_reg_func=reg.registration_marker_based,
            pre_registration_pruning_method=None, return_dict=True, **extra,
        ))
    ref, got = outs
    gq = got["pairwise_registration"]["metrics"]["qualities"]
    assert gq == ref["pairwise_registration"]["metrics"]["qualities"]
    assert list(gq.values())[0] > 0.75
    for p, r in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(_mat(p), _mat(r), atol=POINT_PARAM_ATOL, rtol=0)


def test_register_rigid_markers_3d_with_linear_two_pass_matches_jax():
    """Rotated 3D views registered rigidly from their beads, resolved by
    global optimisation and by the linear two-pass method."""
    rng = np.random.default_rng(11)
    beads = rng.uniform(4, 36, (80, 3))
    affines = []
    for i in range(3):
        a = np.eye(4)
        a[:3, :3] = _rot(3, np.random.default_rng(20 + i), 0.05) if i else np.eye(3)
        a[:3, 3] = rng.uniform(-1, 1, 3) if i else 0.0
        affines.append(a)
    # each view holds the beads in its own frame: inv(error) of the world
    pts = [tpu.transform_pts(beads, np.linalg.inv(a)) for a in affines]
    for method in ("global_optimization", "linear_two_pass"):
        kw = dict(transform_key=KEY, pairwise_reg_func_kwargs={"transform_type": "rigid"},
                  pre_registration_pruning_method=None, groupwise_resolution_method=method,
                  groupwise_resolution_kwargs={"transform": "rigid"})
        outs = []
        for si, mi, reg, extra in ((jsi, jmsi, jreg, {}), (tsi, tmsi, treg, {"device": "cpu"})):
            msims = []
            for p in pts:
                sim = si.get_sim_from_array(np.zeros((40, 40, 40), np.float32))
                m = mi.get_msim_from_sim(sim, scale_factors=[])
                mi.set_point_set(m, p)
                msims.append(m)
            outs.append(reg.register(msims, pairwise_reg_func=reg.registration_marker_based,
                                     **kw, **extra))
        for p, r in zip(*reversed(outs)):
            np.testing.assert_allclose(_mat(p), _mat(r), atol=POINT_PARAM_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# register_pair_of_msims in its three spaces, and over t
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefilter", [False, True])
def test_register_pair_points_space_matches_jax(prefilter):
    pts_f = np.array([[1.0, 1.0], [2.0, 2.0], [3.0, 6.0], [4.0, 8.0]])
    pts_m = np.array([[1.0, 6.0], [2.0, 7.0], [3.0, 11.0], [4.0, 13.0]])
    seen = {}

    def pairwise_func(*, fixed_points, moving_points, initial_affine=None):
        seen.setdefault("calls", []).append((np.asarray(fixed_points), np.asarray(moving_points),
                                             None if initial_affine is None else _mat(
                                                 initial_affine)))
        return {"affine_matrix": np.eye(3), "quality": 0.25}

    results = []
    for si, mi, reg, extra in ((jsi, jmsi, jreg, {}), (tsi, tmsi, treg, {"device": "cpu"})):
        f = si.get_sim_from_array(np.zeros((10, 10)), dims=["y", "x"], transform_key="stage")
        m = si.get_sim_from_array(np.zeros((10, 10)), dims=["y", "x"],
                                  translation={"y": 0.0, "x": 5.0}, transform_key="stage")
        si.set_point_set(f, pts_f)
        si.set_point_set(m, pts_m)
        results.append(reg.register_pair_of_msims(
            mi.get_msim_from_sim(f, scale_factors=[]), mi.get_msim_from_sim(m, scale_factors=[]),
            transform_key="stage", registration_binning={"y": 1, "x": 1},
            pairwise_reg_func=pairwise_func, prefilter_markers=prefilter, **extra,
        ))
    (rf, rm, ri), (gf, gm, gi) = seen["calls"]
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_allclose(gi, ri, atol=1e-12)
    assert len(gf) == (2 if prefilter else 4)
    ref, got = results
    np.testing.assert_allclose(_mat(got["transform"]), _mat(ref["transform"]), atol=1e-12)
    np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-12)
    assert got["quality"] == ref["quality"] == 0.25


def test_register_pair_points_missing_raises():
    f = tsi.get_sim_from_array(np.zeros((10, 10)), dims=["y", "x"])
    with pytest.raises(ValueError, match="missing"):
        treg.register_pair_of_msims(f, f, transform_key=KEY, device="cpu",
                                    pairwise_reg_func=treg.registration_marker_based)


def _shifted_pair(rng, shape=(24, 30), shift=(2.0, -3.0), nan_rows=0):
    big = ndimage.gaussian_filter(rng.random((shape[0] + 12, shape[1] + 12)), 1.5) * 1000
    a = big[6:6 + shape[0], 6:6 + shape[1]].astype(np.float32)
    b = ndimage.shift(big, shift, order=1)[6:6 + shape[0], 6:6 + shape[1]].astype(np.float32)
    if nan_rows:
        a[:nan_rows] = np.nan
        b[-nan_rows:] = np.nan
    return a, b


def test_register_pair_physical_space_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _shifted_pair(rng)
    seen = []

    def physical(fixed_data, moving_data, *, fixed_origin, moving_origin, fixed_spacing,
                 moving_spacing, initial_affine):
        seen.append((np.asarray(fixed_data.data), np.asarray(moving_data.data), fixed_origin,
                     moving_origin, fixed_spacing, moving_spacing, _mat(initial_affine)))
        m = np.eye(3)
        m[:2, 2] = (0.5, -0.25)
        return {"affine_matrix": m, "quality": 0.5}

    results = []
    for si, mi, reg, extra in ((jsi, jmsi, jreg, {}), (tsi, tmsi, treg, {"device": "cpu"})):
        f = si.get_sim_from_array(a, scale={"y": 0.5, "x": 0.5},
                                  translation={"y": 0.0, "x": 0.0})
        m = si.get_sim_from_array(b, scale={"y": 0.5, "x": 0.5},
                                  translation={"y": 1.0, "x": 2.0})
        results.append(reg.register_pair_of_msims(f, m, transform_key=KEY,
                                                  pairwise_reg_func=physical, **extra))
    for r, g in zip(*seen):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r
    ref, got = results
    np.testing.assert_allclose(_mat(got["transform"]), _mat(ref["transform"]), atol=1e-12)
    np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-12)


def test_register_pair_pixel_space_matches_jax():
    """The default phase correlation through the per-pair path (pixel
    space, crops resampled by transform_sim), on views whose metadata
    misplace them."""
    rng = np.random.default_rng(5)
    a, b = _shifted_pair(rng, shape=(28, 32), shift=(1.5, -2.0))
    results = []
    for si, reg, extra in ((jsi, jreg, {}), (tsi, treg, {"device": "cpu"})):
        f = si.get_sim_from_array(a, translation={"y": 0.0, "x": 0.0})
        m = si.get_sim_from_array(b, translation={"y": 0.0, "x": 1.0})
        results.append(reg.register_pair_of_msims(f, m, transform_key=KEY, **extra))
    ref, got = results
    np.testing.assert_allclose(_mat(got["transform"]), _mat(ref["transform"]), atol=SHIFT_ATOL)
    assert abs(got["quality"] - ref["quality"]) < 1e-3
    # constant crops: identity and quality NaN, with the reference's warning
    f = tsi.get_sim_from_array(np.ones((10, 10), np.float32))
    with pytest.warns(UserWarning, match="constant"):
        const = treg.register_pair_of_msims(f, f, transform_key=KEY, device="cpu")
    assert np.isnan(const["quality"])
    np.testing.assert_array_equal(_mat(const["transform"]), np.eye(3))


@pytest.mark.parametrize("nan_rows", [0, 3])
def test_phase_correlation_stepwise_matches_jax(nan_rows):
    rng = np.random.default_rng(6 + nan_rows)
    a, b = _shifted_pair(rng, shape=(20, 24), shift=(1.25, -2.5), nan_rows=nan_rows)
    ref = jreg.phase_correlation_registration(a, b, use_fused_core=False)
    got = treg.phase_correlation_registration(a, b, use_fused_core=False, device="cpu")
    np.testing.assert_allclose(got["affine_matrix"], ref["affine_matrix"], atol=SHIFT_ATOL)
    assert abs(got["quality"] - ref["quality"]) < 1e-3
    # the step-by-step path finds the shift the batched core finds
    fused = treg.phase_correlation_registration(a, b, device="cpu")
    np.testing.assert_allclose(got["affine_matrix"], fused["affine_matrix"], atol=SHIFT_ATOL)


def test_register_pair_over_time_matches_jax():
    sims = sample_data.generate_tiled_dataset(ndim=2, N_t=2, N_c=1, tile_size=24, overlap=8,
                                              tiles_x=2, tiles_y=1, zoom=3, shift_scale=2)
    sims = [jsi.sim_sel_coords(s, {"c": s.coords["c"][0]}) for s in sims]
    jm = [jmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims]
    tm = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(sims)]
    ref = jreg.register_pair_of_msims_over_time(jm[0], jm[1], transform_key=KEY)
    got = treg.register_pair_of_msims_over_time(tm[0], tm[1], transform_key=KEY, device="cpu")
    assert got["transform"].has_t and list(got["transform"].t_coords) == [0, 1]
    np.testing.assert_allclose(got["transform"].data, ref["transform"].data, atol=SHIFT_ATOL)
    np.testing.assert_allclose(got["quality"], ref["quality"], atol=1e-3)
    np.testing.assert_allclose(got["bbox"], ref["bbox"], atol=1e-12)
    # register() over t on the per-pair path equals its batched path
    msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(sims)]
    batched = treg.register(msims, transform_key=KEY, device="cpu")
    per_pair = treg.register(msims, transform_key=KEY, device="cpu",
                             pairwise_reg_func_kwargs={"use_fused_core": False})
    assert treg.last_telemetry["route"] == "per_pair"
    for p, r in zip(per_pair, batched):
        np.testing.assert_allclose(p.data, r.data, atol=IMAGE_PARAM_ATOL)


def test_register_pair_over_time_of_markers_matches_jax():
    rng = np.random.default_rng(8)
    beads = rng.uniform(5, 95, (40, 2))
    results = []
    for si, mi, reg, extra in ((jsi, jmsi, jreg, {}), (tsi, tmsi, treg, {"device": "cpu"})):
        msims = []
        for off in (np.zeros(2), np.array([0.5, 1.5])):
            sim = si.get_sim_from_array(np.zeros((2, 100, 100), np.float32), dims=("t", "y", "x"))
            m = mi.get_msim_from_sim(sim, scale_factors=[])
            mi.set_point_set(m, beads + off)
            msims.append(m)
        results.append(reg.register_pair_of_msims_over_time(
            msims[0], msims[1], transform_key=KEY,
            pairwise_reg_func=reg.registration_marker_based,
            pairwise_reg_func_kwargs={"transform_type": "translation"}, **extra,
        ))
    ref, got = results
    np.testing.assert_allclose(got["transform"].data, ref["transform"].data,
                               atol=POINT_PARAM_ATOL)
    np.testing.assert_array_equal(got["quality"], ref["quality"])


# ---------------------------------------------------------------------------
# register(): the step-by-step path and an executor, on a 2 x 2 grid
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid_2x2():
    sims = sample_data.generate_tiled_dataset(ndim=2, N_t=1, N_c=1, tile_size=30, overlap=10,
                                              tiles_x=2, tiles_y=2, zoom=3, shift_scale=2)
    return [jsi.sim_sel_coords(s, {"c": s.coords["c"][0], "t": s.coords["t"][0]}) for s in sims]


def test_register_use_fused_core_false_matches_batched(grid_2x2):
    sims = _to_port(grid_2x2)
    batched = treg.register(sims, transform_key=KEY, device="cpu", return_dict=True)
    stepwise = treg.register(sims, transform_key=KEY, device="cpu", return_dict=True,
                             pairwise_reg_func_kwargs={"use_fused_core": False})
    g_b = batched["pairwise_registration"]["graph"]
    g_s = stepwise["pairwise_registration"]["graph"]
    for e in g_b.edges:
        np.testing.assert_allclose(_mat(g_s.edges[e]["transform"]),
                                   _mat(g_b.edges[e]["transform"]), atol=SHIFT_ATOL)
    for p, r in zip(stepwise["params"], batched["params"]):
        np.testing.assert_allclose(p.data, r.data, atol=IMAGE_PARAM_ATOL)


def test_pairwise_executor_runs_the_pairs(grid_2x2):
    sims = _to_port(grid_2x2)
    calls = []

    def pool_executor(msims, edges, kwargs):
        calls.append((list(edges), sorted(kwargs)))
        with ThreadPoolExecutor(max_workers=2) as ex:
            return list(ex.map(
                lambda e: treg.register_pair_of_msims(msims[e[0]], msims[e[1]], **kwargs), edges
            ))

    got = treg.register(sims, transform_key=KEY, device="cpu", pairwise_executor=pool_executor)
    assert treg.last_telemetry["route"] == "executor"
    ref = treg.register(sims, transform_key=KEY, device="cpu")
    for p, r in zip(got, ref):
        np.testing.assert_allclose(p.data, r.data, atol=IMAGE_PARAM_ATOL)
    (edges, keys), = calls
    assert "device" in keys and "device_tiles" not in keys and "pairwise_reg_func" in keys
    with pytest.raises(ValueError, match="results for"):
        treg.register(sims, transform_key=KEY, device="cpu",
                      pairwise_executor=lambda m, e, k: [])


def test_pairwise_executor_receives_jax_kwargs():
    """The executor gets the reference's kwargs, with the resolved device
    beside them."""
    rng = np.random.default_rng(4)
    beads = rng.uniform(5, 95, (40, 2))
    offsets = [np.zeros(2), np.array([1.0, 2.0])]
    seen = []

    def executor_for(reg, extra):
        def run(msims, edges, kwargs):
            seen.append(set(kwargs) - extra)
            return [reg.register_pair_of_msims(msims[i], msims[j], **kwargs) for i, j in edges]
        return run

    kw = dict(transform_key=KEY, pairwise_reg_func_kwargs={"transform_type": "translation"},
              pre_registration_pruning_method=None)
    ref = jreg.register(_marker_msims(jsi, jmsi, beads, offsets),
                        pairwise_reg_func=jreg.registration_marker_based,
                        pairwise_executor=executor_for(jreg, set()), **kw)
    got = treg.register(_marker_msims(tsi, tmsi, beads, offsets),
                        pairwise_reg_func=treg.registration_marker_based,
                        pairwise_executor=executor_for(treg, {"device"}), device="cpu", **kw)
    assert seen[0] == seen[1]
    for p, r in zip(got, ref):
        np.testing.assert_allclose(_mat(p), _mat(r), atol=POINT_PARAM_ATOL)


# ---------------------------------------------------------------------------
# linear two-pass resolution
# ---------------------------------------------------------------------------


def _grid_graphs(nx_tiles=3, ny_tiles=3, noise=0.0, seed=0, true_shift=5.0, diagonals=False,
                 rot_sigma=0.0):
    """The same grid registration graph for networkx and the port, edges
    consistent with per-node true transforms (translations, optionally
    small rotations) plus translation noise."""
    rng = np.random.default_rng(seed)
    g, tg = nx.Graph(), tmv.Graph()
    truth = {}
    for iy in range(ny_tiles):
        for ix in range(nx_tiles):
            node = iy * nx_tiles + ix
            mat = np.eye(3)
            if rot_sigma:
                th = rng.normal(0, rot_sigma)
                mat[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
            mat[:2, 2] = rng.uniform(-true_shift, true_shift, 2)
            truth[node] = mat
            sp = {"spacing": {"y": 1.0, "x": 1.0}, "origin": {"y": 10.0 * iy, "x": 10.0 * ix},
                  "shape": {"y": 12, "x": 12}}
            g.add_node(node, stack_props=sp)
            tg.add_node(node, stack_props=sp)
    for iy in range(ny_tiles):
        for ix in range(nx_tiles):
            node = iy * nx_tiles + ix
            neighbors = [(iy, ix + 1), (iy + 1, ix)]
            if diagonals:
                neighbors += [(iy + 1, ix + 1), (iy + 1, ix - 1)]
            for jy, jx in neighbors:
                if jx < 0 or jy >= ny_tiles or jx >= nx_tiles:
                    continue
                u, v = sorted((node, jy * nx_tiles + jx))
                t_uv = np.linalg.inv(truth[v]) @ truth[u]
                if noise:
                    t_uv[:2, -1] += rng.normal(0, noise, 2)
                lo = np.array([10.0 * min(iy, jy), 10.0 * min(ix, jx)])
                attrs = dict(quality=float(rng.uniform(0.5, 1.0)), overlap=1.0,
                             bbox=np.stack([lo, lo + 10.0]))
                g.add_edge(u, v, transform=jpu.affine_to_xaffine(t_uv), **attrs)
                tg.add_edge(u, v, transform=tpu.affine_to_xaffine(t_uv), **attrs)
    return g, tg, truth


def _check_linear_two_pass(g, tg, **kw):
    ref, ref_info = jpr.groupwise_resolution(g, method="linear_two_pass", **kw)
    got, got_info = tpr.groupwise_resolution(tg, method="linear_two_pass", **kw)
    for n in ref:
        np.testing.assert_allclose(_mat(got[n]), _mat(ref[n]), atol=POINT_PARAM_ATOL, rtol=0)
    rm, gm = ref_info["metrics"], got_info["metrics"]
    for col in ("u", "v", "kept_pass2", "icc"):
        np.testing.assert_array_equal(gm[col], rm[col].to_numpy())
    np.testing.assert_allclose(gm["residual"], rm["residual"].to_numpy(), atol=1e-9)
    assert got_info["used_edges"] == ref_info["used_edges"]
    return got, got_info


@pytest.mark.parametrize(
    "graph_kw,kw",
    [
        (dict(nx_tiles=3, ny_tiles=1, seed=2), dict(reference_view=0, transform="translation")),
        (dict(noise=0.1, seed=4, diagonals=True), dict(transform="translation")),
        (dict(nx_tiles=5, ny_tiles=5, rot_sigma=0.01, noise=0.2, seed=3),
         dict(reference_view=0, transform="rigid")),
        (dict(noise=0.1, seed=6), dict(mode="rigid", weight_mode="uniform", prior_lambda=0.1)),
        (dict(noise=0.1, seed=7), dict(transform="rigid", residual_threshold=0.05,
                                       keep_mst=False)),
        (dict(noise=0.1, seed=8), dict(transform="translation", weight_mode="quality",
                                       iter_lim=5)),
    ],
    ids=["chain", "diagonals", "rigid5x5", "prior", "threshold", "lsqr_kwargs"],
)
def test_linear_two_pass_matches_jax(graph_kw, kw):
    g, tg, _ = _grid_graphs(**graph_kw)
    _check_linear_two_pass(g, tg, **kw)


def test_linear_two_pass_prunes_outlier_edge_as_jax():
    g, tg, truth = _grid_graphs(nx_tiles=3, ny_tiles=3, noise=0.01, seed=4)
    for graph, pu in ((g, jpu), (tg, tpu)):
        mat = _mat(graph.edges[(0, 1)]["transform"]).copy()
        mat[:2, 2] += 40.0
        graph.edges[(0, 1)]["transform"] = pu.affine_to_xaffine(mat)
    got, _ = _check_linear_two_pass(g, tg, reference_view=0, transform="translation",
                                    weight_mode="overlap")
    for u in truth:
        for v in truth:
            if u < v:
                want = np.linalg.inv(truth[v]) @ truth[u]
                have = np.linalg.inv(_mat(got[v])) @ _mat(got[u])
                np.testing.assert_allclose(have, want, atol=0.2)


def test_linear_two_pass_edge_cases():
    g, tg, _ = _grid_graphs(nx_tiles=2, ny_tiles=1, seed=1)
    with pytest.raises(ValueError, match="Unknown transform"):
        tpr.groupwise_resolution(tg, method="linear_two_pass", transform="affine")
    with pytest.raises(ValueError, match="weight_mode"):
        tpr.groupwise_resolution(tg, method="linear_two_pass", weight_mode="nope")
    from multiview_stitcher_torch.param_resolution.linear_two_pass import (
        groupwise_resolution_linear_two_pass,
    )

    lone = tmv.Graph()
    lone.add_node(0, stack_props={"spacing": {"y": 1.0, "x": 1.0}})
    params, info = groupwise_resolution_linear_two_pass(lone)
    assert info == {"metrics": None, "used_edges": []}
    np.testing.assert_array_equal(_mat(params[0]), np.eye(3))


# ---------------------------------------------------------------------------
# keep_axis_aligned pruning, label pairs and sample masks, crops
# ---------------------------------------------------------------------------


def _stack_graphs(n=3, angle=0.0):
    g, tg = nx.Graph(), tmv.Graph()
    c, s = np.cos(angle), np.sin(angle)
    for iy in range(n):
        for ix in range(n):
            mat = np.eye(3)
            mat[:2, :2] = [[c, -s], [s, c]]
            mat[:2, 2] = (9.0 * iy, 9.0 * ix)
            sp = {"spacing": {"y": 1.0, "x": 1.0}, "origin": {"y": 0.0, "x": 0.0},
                  "shape": {"y": 12, "x": 12}, "transform": mat}
            node = iy * n + ix
            g.add_node(node, stack_props=sp, extra=node)
            tg.add_node(node, stack_props=sp, extra=node)
    for u in range(n * n):
        for v in range(u + 1, n * n):
            if abs(u // n - v // n) <= 1 and abs(u % n - v % n) <= 1:
                g.add_edge(u, v, overlap=float(u + v))
                tg.add_edge(u, v, overlap=float(u + v))
    return g, tg


@pytest.mark.parametrize("n,angle,max_angle", [(3, 0.0, 0.05), (4, 0.0, 0.05), (3, 0.3, 0.05),
                                               (3, 0.0, 0.9)])
def test_keep_axis_aligned_matches_jax(n, angle, max_angle):
    g, tg = _stack_graphs(n, angle)
    kw = {"max_angle": max_angle}
    ref = jmv.prune_view_adjacency_graph(g, method="keep_axis_aligned", pruning_method_kwargs=kw)
    got = tmv.prune_view_adjacency_graph(tg, method="keep_axis_aligned", pruning_method_kwargs=kw)
    assert list(got.nodes) == list(ref.nodes)
    assert list(got.edges) == list(ref.edges)
    assert [got.edges[e]["overlap"] for e in got.edges] == [ref.edges[e]["overlap"]
                                                            for e in ref.edges]
    assert [got.nodes[v]["extra"] for v in got.nodes] == [ref.nodes[v]["extra"]
                                                          for v in ref.nodes]


def test_register_keep_axis_aligned_matches_jax(grid_2x2):
    kw = dict(transform_key=KEY, pre_registration_pruning_method="keep_axis_aligned",
              return_dict=True)
    got = treg.register(_to_port(grid_2x2), device="cpu", **kw)
    ref = jreg.register(grid_2x2, **kw)
    # the diagonals are pruned: a 2 x 2 grid keeps its 4 sides
    assert got["pairwise_registration"]["graph"].number_of_edges() == 4
    assert list(got["pairwise_registration"]["graph"].edges) == list(
        ref["pairwise_registration"]["graph"].edges)
    for p, r in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(_mat(p), _mat(r), atol=IMAGE_PARAM_ATOL)
    batched = treg.register(_to_port(grid_2x2), device="cpu", transform_key=KEY,
                            pre_registration_pruning_method=None, return_dict=True)
    assert batched["pairwise_registration"]["graph"].number_of_edges() == 6


def test_connected_labels_and_sample_mask_pairs_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, (12, 14))
    np.testing.assert_array_equal(tmv.get_connected_labels(labels),
                                  jmv.get_connected_labels(labels))
    masks = []
    for (y, x) in ((0.0, 0.0), (0.0, 15.0), (15.0, 0.0), (40.0, 40.0)):
        m = np.zeros((20, 20), np.uint8)
        m[2:18, 2:18] = 1
        masks.append((m, {"y": y, "x": x}))
    jm = [jsi.get_sim_from_array(m, translation=t) for m, t in masks]
    tm = [tsi.get_sim_from_array(m, translation=t) for m, t in masks]
    ref_pairs, ref_fused = jreg.get_pairs_from_sample_masks(jm)
    got_pairs, got_fused = treg.get_pairs_from_sample_masks(tm, device="cpu")
    assert got_pairs == ref_pairs
    assert (0, 1) in got_pairs and all(3 not in p for p in got_pairs)
    np.testing.assert_array_equal(got_fused.to_numpy(), ref_fused.to_numpy())


def test_crop_sim_to_references_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.random((30, 40)).astype(np.float32)
    aff = jpu.affine_from_translation([2.0, -3.0])
    jbig = jsi.get_sim_from_array(data, scale={"y": 0.5, "x": 0.5},
                                  translation={"y": 0.0, "x": 0.0}, affine=aff)
    tbig = tsi.get_sim_from_array(data, scale={"y": 0.5, "x": 0.5},
                                  translation={"y": 0.0, "x": 0.0}, affine=aff)
    refs = [((5, 6), {"y": 4.0, "x": 1.0}), ((4, 4), {"y": 6.0, "x": 5.0})]
    jrefs = [jsi.get_sim_from_array(np.zeros(s), translation=t) for s, t in refs]
    trefs = [tsi.get_sim_from_array(np.zeros(s), translation=t) for s, t in refs]
    ref = jreg.crop_sim_to_references(jbig, jrefs, KEY, [KEY, KEY])
    got = treg.crop_sim_to_references(tbig, trefs, KEY, [KEY, KEY])
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert got.origin == ref.origin
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert treg.apply_recursive_dict(lambda v: v * 2, nested) == jreg.apply_recursive_dict(
        lambda v: v * 2, nested)


# ---------------------------------------------------------------------------
# registration plugins with stand-in backends
# ---------------------------------------------------------------------------


TH = 0.1
GT = np.array([[np.cos(TH), -np.sin(TH), 2.0], [np.sin(TH), np.cos(TH), -1.0], [0.0, 0.0, 1.0]])


def _apply_gt(pts):
    return pts @ GT[:2, :2].T + GT[:2, 2]


def _fake_ants(calls):
    mod = types.SimpleNamespace()
    mod.from_numpy = lambda arr, origin, spacing: types.SimpleNamespace(
        arr=arr, origin=origin, spacing=spacing)

    def registration(fixed, moving, type_of_transform, initial_transform, **kw):
        calls.append((type_of_transform, initial_transform))
        return {"fwdtransforms": f"tx_after_{type_of_transform}"}

    mod.registration = registration
    mod.apply_transforms_to_points = lambda ndim, pts_df, transforms: types.SimpleNamespace(
        values=_apply_gt(pts_df.values))
    return mod


def _phys_kwargs():
    return dict(fixed_origin={"y": 1.0, "x": -2.0}, moving_origin={"y": 0.0, "x": 0.0},
                fixed_spacing={"y": 0.5, "x": 0.5}, moving_spacing={"y": 0.5, "x": 0.5},
                initial_affine=np.eye(3))


@pytest.mark.parametrize("transform_types", [None, ["Affine"]])
def test_antspy_plugin_with_stand_in_matches_jax(monkeypatch, transform_types):
    from multiview_stitcher_tpu import registration_plugins as jrp

    fixed = np.random.default_rng(0).random((20, 24)).astype(np.float32)
    results, all_calls = [], []
    for rp in (jrp, trp):
        calls = []
        monkeypatch.setattr(rp, "ants", _fake_ants(calls))
        results.append(rp.registration_ANTsPy(fixed, np.roll(fixed, 2, axis=0),
                                              transform_types=transform_types, **_phys_kwargs()))
        all_calls.append(calls)
    assert all_calls[0] == all_calls[1]
    np.testing.assert_allclose(results[1]["affine_matrix"], results[0]["affine_matrix"],
                               atol=1e-12)
    np.testing.assert_allclose(results[1]["affine_matrix"], GT, atol=1e-8)


def test_itk_plugin_with_stand_in_matches_jax(monkeypatch):
    from multiview_stitcher_tpu import registration_plugins as jrp

    fixed = np.random.default_rng(1).random((16, 18)).astype(np.float32)
    results, maps = [], []
    for rp in (jrp, trp):
        added = []
        mod = types.SimpleNamespace(ElastixRegistrationMethod=object())
        mod.image_from_array = lambda arr: types.SimpleNamespace(
            SetSpacing=lambda s: None, SetOrigin=lambda o: None)
        mod.ParameterObject = types.SimpleNamespace(New=lambda: types.SimpleNamespace(
            AddParameterMap=added.append, GetDefaultParameterMap=lambda t: f"map:{t}"))
        mod.elastix_registration_method = lambda f, m, parameter_object, **kw: (None, "fitted")
        monkeypatch.setattr(rp, "itk", mod)
        monkeypatch.setattr(rp, "_transformix_points",
                            lambda pts, params: _apply_gt(pts[:, ::-1])[:, ::-1])
        results.append(rp.registration_ITKElastix(fixed, fixed, **_phys_kwargs()))
        maps.append(added)
    assert maps[0] == maps[1] == ["map:translation", "map:rigid", "map:affine"]
    np.testing.assert_allclose(results[1]["affine_matrix"], results[0]["affine_matrix"],
                               atol=1e-12)


@pytest.mark.parametrize("name,attr,match", [("registration_ANTsPy", "ants", "antspyx"),
                                             ("registration_ITKElastix", "itk", "itk-elastix")])
def test_plugins_raise_without_backend(monkeypatch, name, attr, match):
    monkeypatch.setattr(trp, attr, None)
    with pytest.raises(ImportError, match=match):
        getattr(trp, name)(np.zeros((4, 4)), np.zeros((4, 4)), **_phys_kwargs())
    # the plugins are exported by registration, as in the reference
    assert getattr(treg, name) is getattr(trp, name)


def test_plugin_through_register_pair_physical_space(monkeypatch):
    """A plugin registers through register_pair_of_msims's physical-space
    dispatch; the JAX package's does the same with the same stand-in."""
    from multiview_stitcher_tpu import registration_plugins as jrp

    rng = np.random.default_rng(2)
    a, b = _shifted_pair(rng)
    results = []
    for rp, si, reg, extra in ((jrp, jsi, jreg, {}), (trp, tsi, treg, {"device": "cpu"})):
        monkeypatch.setattr(rp, "ants", _fake_ants([]))
        f = si.get_sim_from_array(a, scale={"y": 0.5, "x": 0.5}, translation={"y": 0.0, "x": 0.0})
        m = si.get_sim_from_array(b, scale={"y": 0.5, "x": 0.5}, translation={"y": 0.5, "x": 1.0})
        results.append(reg.register_pair_of_msims(f, m, transform_key=KEY,
                                                  pairwise_reg_func=rp.registration_ANTsPy,
                                                  **extra))
    np.testing.assert_allclose(_mat(results[1]["transform"]), _mat(results[0]["transform"]),
                               atol=1e-12)
