"""The port's registration over time and over pyramid levels against the JAX
package: ``register()`` of time-lapse grids, the level choice of
``reg_res_level`` and ``registration_binning``, ``groupwise_resolution`` over
``t``, ``rebase_affine``'s outer join over ``t`` and ``stitch()`` of
time-lapse msims.

Inputs are made from a seed with numpy (``sample_data.generate_tiled_dataset``)
and go through the JAX function and its port on the CPU (``device="cpu"``).
Tolerances: registered and resolved parameters within 1e-3 per timepoint;
edge residuals and metrics within 1e-6; level choices and timepoints exactly;
fused outputs within 1 count (uint16, truncation ties).
"""

import networkx as nx
import numpy as np
import pytest

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import param_resolution as tpr
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.stitch import stitch as tstitch
from multiview_stitcher_tpu import (
    msi_utils, param_resolution, param_utils, registration, sample_data, si_utils,
)
from multiview_stitcher_tpu.stitch import stitch as jstitch

KEY = si_utils.DEFAULT_TRANSFORM_KEY
PARAM_ATOL = 1e-3
UINT_COUNTS = 1

# the 3D grid needs these to register to anything but identity
_GRIDS = {
    2: dict(ndim=2, tiles_x=2, tiles_y=2, tile_size=30, overlap=8),
    3: dict(ndim=3, tiles_x=2, tiles_y=2, tiles_z=1, tile_size=20, overlap=8, zoom=3,
            shift_scale=3),
}


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _timelapse(ndim, n_t=3):
    sims = sample_data.generate_tiled_dataset(N_c=1, N_t=n_t, **_GRIDS[ndim])
    return [s.isel({"c": 0}) for s in sims]


def _assert_params_close(got, ref):
    assert len(got) == len(ref)
    for p, r in zip(got, ref):
        assert p.has_t == r.has_t
        if r.has_t:
            np.testing.assert_array_equal(p.t_coords, r.t_coords)
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL, rtol=0)


@pytest.fixture(autouse=True)
def _empty_cache():
    tcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()


# ---------------------------------------------------------------------------
# register() over t
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
def test_register_over_t_matches_jax(ndim):
    jsims = _timelapse(ndim)
    ref = registration.register(jsims, transform_key=KEY)
    got = treg.register(_to_port(jsims), transform_key=KEY, device="cpu", device_tiles=True)
    _assert_params_close(got, ref)
    assert len(got[0].t_coords) == 3
    # each timepoint registers on its own: the drift makes them differ
    assert np.abs(np.diff(np.stack([p.data for p in got]), axis=1)).max() > 0.1
    # crops over t come from the host, as in the reference
    assert treg.last_telemetry["device_tiles"] is False
    assert treg.last_telemetry["units"] == 3 * treg.last_telemetry["pairs"]


def test_register_over_t_return_dict_and_new_transform_key_match_jax():
    jsims = _timelapse(2)
    jm = [msi_utils.get_msim_from_sim(s, scale_factors=[]) for s in jsims]
    tm = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(jsims)]
    kw = dict(transform_key=KEY, new_transform_key="registered", return_dict=True,
              groupwise_resolution_method="shortest_paths")
    ref = registration.register(jm, **kw)
    got = treg.register(tm, device="cpu", **kw)
    _assert_params_close(got["params"], ref["params"])
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t.transforms["registered"].data, j.transforms["registered"].data,
                                   atol=PARAM_ATOL)
        np.testing.assert_array_equal(t.transforms["registered"].t_coords,
                                      j.transforms["registered"].t_coords)
    gq, rq = (d["pairwise_registration"]["metrics"]["qualities"] for d in (got, ref))
    assert set(gq) == set(rq)
    for e in rq:
        np.testing.assert_allclose(gq[e], rq[e], atol=1e-3)
    ginfo, rinfo = got["groupwise_resolution"]["metrics"], ref["groupwise_resolution"]["metrics"]
    assert sorted(ginfo["edge_residuals"]) == sorted(rinfo["edge_residuals"]) == [0, 1, 2]
    for it, res in rinfo["edge_residuals"].items():
        for e, r in res.items():
            assert abs(ginfo["edge_residuals"][it][e] - r) <= PARAM_ATOL


def test_register_over_t_of_a_singleton_z_matches_jax():
    """3D views one plane deep with t register as 2D over t and come back
    3D."""
    jsims = []
    for s in _timelapse(2, n_t=2):
        jsims.append(si_utils.get_sim_from_array(
            np.asarray(s.data)[:, None], dims=["t", "z", "y", "x"],
            translation={"z": 0.0, **s.origin}, scale={"z": 1.0, **s.spacing},
            t_coords=s.coords["t"],
        ))
    ref = registration.register(jsims, transform_key=KEY)
    got = treg.register(_to_port(jsims), transform_key=KEY, device="cpu")
    _assert_params_close(got, ref)
    assert got[0].data.shape == (2, 4, 4)


# ---------------------------------------------------------------------------
# level choice
# ---------------------------------------------------------------------------


def _pyramid_msims(n_t=None):
    """A 2 x 1 grid of 64^2 tiles with two coarser levels, in both packages."""
    sims = sample_data.generate_tiled_dataset(ndim=2, N_c=1, N_t=n_t or 1, tiles_x=2, tiles_y=1,
                                              tile_size=64, overlap=20, zoom=4)
    sims = [s.isel({"c": 0}) if n_t else s.isel({"c": 0, "t": 0}) for s in sims]
    kw = dict(scale_factors=[{"y": 2, "x": 2}, {"y": 2, "x": 2}])
    return ([msi_utils.get_msim_from_sim(s, **kw) for s in sims],
            [tmsi.get_msim_from_sim(s, **kw) for s in _to_port(sims)])


_LEVEL_CASES = [
    (dict(), "scale0"),
    (dict(registration_binning={"y": 2, "x": 2}), "scale1"),
    (dict(registration_binning={"y": 3, "x": 3}), "scale1"),
    (dict(registration_binning={"y": 4, "x": 2}), "scale1"),
    (dict(registration_binning={"y": 4, "x": 4}), "scale2"),
    (dict(reg_res_level=1), "scale1"),
    (dict(reg_res_level=2), "scale2"),
    (dict(reg_res_level=1, registration_binning={"y": 4, "x": 2}), "scale1"),
]


@pytest.mark.parametrize("kw,level", _LEVEL_CASES)
def test_select_and_crop_pair_picks_the_level_jax_picks(kw, level):
    jm, tm = _pyramid_msims()
    ref = registration._select_and_crop_pair(jm[0], jm[1], KEY, **kw)
    got = treg._select_and_crop_pair(tm[0], tm[1], KEY, **kw)
    assert got[6]["scale_key"] == ref[6]["scale_key"] == level
    for g, r in zip(got[2], ref[2]):
        np.testing.assert_array_equal(np.asarray(g.data), r.to_numpy())
        assert g.spacing == r.spacing and g.origin == r.origin
    for k in (3, 4):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]))


def test_select_and_crop_pair_refuses_what_jax_refuses():
    jm, tm = _pyramid_msims()
    for kw, match in ((dict(reg_res_level=3), "does not exist"),
                      (dict(reg_res_level=1, registration_binning={"y": 3, "x": 2}),
                       "does not divide")):
        with pytest.raises(ValueError, match=match):
            registration._select_and_crop_pair(jm[0], jm[1], KEY, **kw)
        with pytest.raises(ValueError, match=match):
            treg._select_and_crop_pair(tm[0], tm[1], KEY, **kw)


@pytest.mark.parametrize("kw", [dict(registration_binning={"y": 2, "x": 2}),
                                dict(reg_res_level=1)])
def test_register_of_pyramids_over_t_matches_jax(kw):
    jm, tm = _pyramid_msims(n_t=2)
    ref = registration.register(jm, transform_key=KEY, **kw)
    got = treg.register(tm, transform_key=KEY, device="cpu", **kw)
    _assert_params_close(got, ref)


def test_register_of_pyramids_matches_jax_at_each_level():
    """The same pair registered at each level (host crops of the coarse
    levels, the resident stack at level 0)."""
    jm, tm = _pyramid_msims()
    for level in (0, 1, 2):
        ref = registration.register(jm, transform_key=KEY, reg_res_level=level)
        got = treg.register(tm, transform_key=KEY, reg_res_level=level, device="cpu",
                            device_tiles=True)
        _assert_params_close(got, ref)
        assert treg.last_telemetry["device_tiles"] is (level == 0)


# ---------------------------------------------------------------------------
# groupwise resolution over t
# ---------------------------------------------------------------------------


def _reg_graphs_over_t(seed, t_coords=(0, 1, 2)):
    """The same time-lapse registration graph for networkx and the port: a
    2 x 3 grid of views whose edge translations drift over t, with per-t
    qualities; one edge far off at the last timepoint."""
    rng = np.random.default_rng(seed)
    nt = len(t_coords)
    truth = rng.normal(0, 2, (nt, 6, 2))
    g, tg = nx.Graph(), tmv.Graph()
    for i in range(6):
        sp = {"spacing": {"y": 0.5, "x": 0.5}, "shape": {"y": 20, "x": 20},
              "origin": {"y": 0.0, "x": 0.0}}
        g.add_node(i, stack_props=sp)
        tg.add_node(i, stack_props=sp)
    edges = [(0, 1), (1, 2), (3, 4), (4, 5), (0, 3), (1, 4), (2, 5), (0, 4)]
    for k, (u, v) in enumerate(edges):
        mats = np.repeat(np.eye(3)[None], nt, axis=0)
        mats[:, :2, 2] = truth[:, u] - truth[:, v] + rng.normal(0, 0.05, (nt, 2))
        if k == 2:
            mats[-1, :2, 2] += 7.0
        lo = rng.uniform(0, 5, 2)
        attrs = dict(quality=rng.uniform(0.5, 1, nt),
                     bbox=np.array([lo, lo + rng.uniform(2, 6, 2)]),
                     overlap=float(rng.uniform(1, 4)))
        g.add_edge(u, v, transform=param_utils.XAffine(mats, t_coords=np.asarray(t_coords)),
                   **attrs)
        tg.add_edge(u, v, transform=tpu.XAffine(mats, t_coords=np.asarray(t_coords)), **attrs)
    return g, tg


@pytest.mark.parametrize("method", ["global_optimization", "shortest_paths"])
def test_groupwise_resolution_over_t_matches_jax(method):
    g, tg = _reg_graphs_over_t(7, t_coords=(4, 9, 12))
    ref, ref_info = param_resolution.groupwise_resolution(g, method=method)
    got, got_info = tpr.groupwise_resolution(tg, method=method)
    assert sorted(got) == sorted(ref)
    _assert_params_close([got[n] for n in sorted(ref)], [ref[n] for n in sorted(ref)])
    assert list(got[0].t_coords) == [4, 9, 12]
    assert got_info["used_edges"] == ref_info["used_edges"]
    assert sorted(got_info["edge_residuals"]) == [0, 1, 2]
    for it, res in ref_info["edge_residuals"].items():
        assert sorted(got_info["edge_residuals"][it]) == sorted(res)
        for e, r in res.items():
            assert abs(got_info["edge_residuals"][it][e] - r) <= 1e-6
    if method == "global_optimization":
        df = ref_info["metrics"]
        assert sorted(got_info["metrics"]) == sorted(df.columns)
        assert "t" in got_info["metrics"]
        for col in df.columns:
            np.testing.assert_allclose(got_info["metrics"][col], df[col].to_numpy(), atol=1e-6)
    # a timepoint alone is the resolution of the graph narrowed to it
    one, _ = tpr.groupwise_resolution(
        tpr.utils.get_reg_graph_with_single_tp_transforms(tg, 9), method=method
    )
    for n in got:
        np.testing.assert_allclose(got[n].data[1], one[n].data, atol=1e-12)


def test_single_timepoint_graph_matches_jax():
    g, tg = _reg_graphs_over_t(8)
    ref = param_resolution.utils.get_reg_graph_with_single_tp_transforms(g, 1)
    got = tpr.utils.get_reg_graph_with_single_tp_transforms(tg, 1)
    assert sorted(got.edges) == sorted(ref.edges)
    for u, v, d in ref.edges(data=True):
        gd = got.edges[u, v]
        np.testing.assert_array_equal(gd["transform"].data, d["transform"].data)
        assert not gd["transform"].has_t
        assert gd["quality"] == d["quality"]
        np.testing.assert_array_equal(gd["bbox"], d["bbox"])
    # the source graph keeps its timepoints
    assert tg.edges[0, 1]["transform"].has_t


# ---------------------------------------------------------------------------
# transforms over t
# ---------------------------------------------------------------------------


def _xaffine_cases(pkg):
    rng = np.random.default_rng(9)
    mats = rng.normal(size=(4, 3, 3))
    mats[:, 2] = (0, 0, 1)
    return {
        "plain": pkg.XAffine(mats[0]),
        "t01": pkg.XAffine(mats[:2], t_coords=np.array([0, 1])),
        "t12": pkg.XAffine(mats[2:], t_coords=np.array([1, 2])),
        "t3": pkg.XAffine(mats[3:], t_coords=np.array([3])),
    }


@pytest.mark.parametrize("a,b", [("plain", "plain"), ("t01", "plain"), ("plain", "t12"),
                                 ("t01", "t12"), ("t12", "t01"), ("t01", "t3")])
def test_rebase_affine_outer_join_matches_jax(a, b):
    jc, tc = _xaffine_cases(param_utils), _xaffine_cases(tpu)
    ref, got = param_utils.rebase_affine(jc[a], jc[b]), tpu.rebase_affine(tc[a], tc[b])
    assert got.has_t == ref.has_t
    if ref.has_t:
        np.testing.assert_array_equal(got.t_coords, ref.t_coords)
    np.testing.assert_array_equal(got.data, ref.data)
    for join in ("inner", "outer"):
        if (a, b, join) == ("t01", "t3", "inner"):
            # no common timepoint: the inner join raises in both
            for f, c in ((tpu._align_t, tc), (param_utils._align_t, jc)):
                with pytest.raises(ValueError):
                    f(c[a], c[b], join)
            continue
        for g, r in zip(tpu._align_t(tc[a], tc[b], join), param_utils._align_t(jc[a], jc[b], join)):
            np.testing.assert_array_equal(g, r)
    assert (tpu.get_non_spatial_dims_from_params(tc[a])
            == param_utils.get_non_spatial_dims_from_params(jc[a]))


# ---------------------------------------------------------------------------
# stitch() over t
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
def test_stitch_over_t_matches_jax(ndim):
    """register + fuse of time-lapse, two-channel msims, as the reference's
    diversity test stitches them."""
    tile = 32 if ndim == 3 else 48
    jsims = sample_data.generate_tiled_dataset(
        ndim=ndim, N_c=2, N_t=2, tile_size=tile, tiles_x=2, tiles_y=2, overlap=8, zoom=3,
        shift_scale=1.0, drift_scale=0.3,
    )
    jm = [msi_utils.get_msim_from_sim(s, scale_factors=[]) for s in jsims]
    tm = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(jsims)]
    rkw = dict(reg_channel_index=0, pre_registration_pruning_method=None)
    ref = jstitch(jm, register_kwargs=rkw)
    got = tstitch(tm, register_kwargs=rkw, device="cpu")
    assert got.dims == ref.dims and got.sizes["t"] == 2 and got.sizes["c"] == 2
    ref_data = np.asarray(ref.to_numpy())
    assert got.data.shape == ref_data.shape and got.data.dtype == ref_data.dtype
    assert np.abs(got.data.astype(np.int64) - ref_data.astype(np.int64)).max() <= UINT_COUNTS
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t.transforms["registered"].data,
                                   j.transforms["registered"].data, atol=PARAM_ATOL)
