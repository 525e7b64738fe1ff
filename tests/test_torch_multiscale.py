"""The port's multiscale images against the JAX package: pyramids, the msim
helpers, OME-Zarr msims and ``fuse()`` of msims.

Inputs are made from a seed with numpy and go through the JAX function and
its port on the CPU (``device="cpu"``). Tolerances: pyramid levels bit for
bit, with equal spacing and origin; fused levels within 1 count (uint16) or
rtol 1e-4 / atol 1e-3 (float32), the translation tier's tolerance; OME-Zarr
levels read through the JAX package's tensorstore reader bit for bit.
"""

import numpy as np
import pytest

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import residency
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import zarr_utils as tzu
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_tpu import (
    fusion, msi_utils, param_utils, registration, sample_data, si_utils,
)
from multiview_stitcher_tpu.io import ngff_utils, zarr_backend

KEY = si_utils.DEFAULT_TRANSFORM_KEY
UINT_COUNTS = 1
F32_TOL = dict(rtol=1e-4, atol=1e-3)


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _pair(jsim):
    """The JAX sim and its port."""
    return jsim, _to_port([jsim])[0]


def _volume(rng, ndim, dtype):
    shape = (230, 250) if ndim == 2 else (24, 216, 206)
    data = rng.random(shape) * (1000 if dtype == np.uint16 else 100)
    return data.astype(dtype)


def _assert_levels_equal(jm, tm):
    assert len(jm.sims) == len(tm.sims)
    for js, ts in zip(jm.sims, tm.sims):
        jd, td = js.to_numpy(), ts.to_numpy()
        assert td.dtype == jd.dtype and td.shape == jd.shape
        np.testing.assert_array_equal(td, jd)
        assert ts.spacing == js.spacing and ts.origin == js.origin
        assert ts.dims == js.dims


def _assert_fused_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= UINT_COUNTS
    else:
        np.testing.assert_allclose(got, ref, **F32_TOL)


# ---------------------------------------------------------------------------
# pyramids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("factors", ["default", "explicit"])
def test_pyramid_levels_match_jax_bit_for_bit(ndim, dtype, factors):
    rng = np.random.default_rng(ndim * 10 + (dtype == np.uint16))
    sdims = ("z", "y", "x")[-ndim:]
    js, ts = _pair(si_utils.get_sim_from_array(
        _volume(rng, ndim, dtype), dims=sdims,
        scale={d: s for d, s in zip(sdims, (2.0, 0.5, 0.4)[-ndim:])},
        translation={d: o for d, o in zip(sdims, (1.0, -3.5, 12.25)[-ndim:])},
    ))
    if factors == "default":
        kw = {}
    else:
        kw = dict(scale_factors=[{d: 2 for d in sdims}, {**{d: 3 for d in sdims}, sdims[0]: 1}])
    jm = msi_utils.get_msim_from_sim(js, **kw)
    tm = tmsi.get_msim_from_sim(ts, **kw)
    assert len(tm.sims) >= 2
    _assert_levels_equal(jm, tm)
    for k in tm.transforms:
        np.testing.assert_array_equal(tm.transforms[k].data, jm.transforms[k].data)


def test_calc_resolution_levels_matches_jax():
    for shape in ({"y": 90, "x": 400}, {"z": 128, "y": 512, "x": 512},
                  {"z": 30, "y": 201, "x": 999}):
        assert tmsi.calc_resolution_levels(shape) == msi_utils.calc_resolution_levels(shape)
    shape = {"y": 1000, "x": 1000}
    kw = dict(downscale_factors_per_spatial_dim={"y": 3, "x": 2}, min_shape=50)
    assert tmsi.calc_resolution_levels(shape, **kw) == msi_utils.calc_resolution_levels(shape, **kw)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tc_msims(rng, nt=3):
    """A (t, c, y, x) uint16 view with a two-level pyramid and a transform
    over t, in both packages."""
    data = (rng.random((nt, 2, 40, 36)) * 1000).astype(np.uint16)
    mats = np.stack([param_utils.affine_from_translation([t, -2.0 * t]) for t in range(nt)])
    js = si_utils.get_sim_from_array(
        data, dims=("t", "c", "y", "x"), scale={"y": 0.5, "x": 0.5},
        translation={"y": 1.0, "x": 2.0}, c_coords=["a", "b"], t_coords=[10, 20, 30][:nt],
        affine=param_utils.affine_to_xaffine(mats, t_coords=[10, 20, 30][:nt]),
    )
    ts = _to_port([js])[0]
    kw = dict(scale_factors=[{"y": 2, "x": 2}])
    return msi_utils.get_msim_from_sim(js, **kw), tmsi.get_msim_from_sim(ts, **kw)


def test_multiscale_sel_coords_with_t_stacked_transforms():
    jm, tm = _tc_msims(np.random.default_rng(1))
    for sel in ({"t": 20}, {"t": [10, 30]}, {"c": "b"}, {"t": 30, "c": "a"}):
        jsel = msi_utils.multiscale_sel_coords(jm, sel)
        tsel = tmsi.multiscale_sel_coords(tm, sel)
        _assert_levels_equal(jsel, tsel)
        assert set(tsel.transforms) == set(jsel.transforms)
        for k, jx in jsel.transforms.items():
            np.testing.assert_array_equal(tsel.transforms[k].data, jx.data)
            assert tsel.transforms[k].has_t == jx.has_t
            if jx.has_t:
                np.testing.assert_array_equal(tsel.transforms[k].t_coords, jx.t_coords)


def test_get_msim_from_sims_and_level_choice_match_jax():
    rng = np.random.default_rng(2)
    data = rng.random((64, 64)).astype(np.float32)
    js, ts = _pair(si_utils.get_sim_from_array(data, scale={"y": 1.0, "x": 1.0}))
    kw = dict(scale_factors=[{"y": 2, "x": 2}, {"y": 2, "x": 2}])
    jm, tm = msi_utils.get_msim_from_sim(js, **kw), tmsi.get_msim_from_sim(ts, **kw)
    # levels given coarse first come back finest first
    jm2 = msi_utils.get_msim_from_sims([jm.sims[2], jm.sims[0], jm.sims[1]])
    tm2 = tmsi.get_msim_from_sims([tm.sims[2], tm.sims[0], tm.sims[1]])
    _assert_levels_equal(jm2, tm2)
    with pytest.raises(ValueError, match="same dimensions"):
        tmsi.get_msim_from_sims([tm.sims[0], tsi.ensure_dim(tm.sims[1], "c")])
    for spacing in (0.1, 1.0, 2.0, 3.0, 4.0 * (1 + 1e-7), 4.0 * (1 + 1e-5), 100.0):
        sp = {"y": spacing, "x": spacing}
        assert tmsi.get_res_level_from_spacing(tm, sp) == msi_utils.get_res_level_from_spacing(
            jm, sp
        )
    for bins in ({"y": 1, "x": 1}, {"y": 2, "x": 2}, {"y": 4, "x": 2}, {"y": 4, "x": 4},
                 {"y": 3, "x": 5}, {"y": 8, "x": 8}, {}):
        assert tmsi.get_res_level_from_binning_factors(
            tm, bins
        ) == msi_utils.get_res_level_from_binning_factors(jm, bins)
    for target in (0.1, 0.75, 1.5, 10.0):
        assert tmsi.get_first_scale_above_target_spacing(
            tm, target
        ) == msi_utils.get_first_scale_above_target_spacing(jm, target)


def test_level_choice_keeps_its_tolerance_through_json_spacings(tmp_path):
    """A level read back from OME-Zarr has its spacing rounded through
    JSON: the 1e-6 relative tolerance still picks it."""
    sim = tsi.get_sim_from_array(np.zeros((300, 300), np.uint16), scale={"y": 0.1, "x": 0.1})
    back = tngff.write_msim_to_ome_zarr(tmsi.get_msim_from_sim(sim), str(tmp_path / "a.zarr"))
    assert len(back.sims) == 2
    assert tmsi.get_res_level_from_binning_factors(back, {"y": 2, "x": 2}) == "scale1"
    assert tmsi.get_res_level_from_spacing(back, {"y": 0.2, "x": 0.2}) == "scale1"


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("origin0", [0.0, 13.7])
def test_correct_multiscale_origins_matches_jax(ndim, origin0):
    dims = ("z", "y", "x")[-ndim:]
    levels = []
    for f in (1, 2, 4):
        levels.append(si_utils.get_sim_from_array(
            np.zeros((32 // f,) * ndim, np.float32), dims=dims,
            scale={d: 0.5 * f for d in dims}, translation={d: origin0 for d in dims},
        ))
    jm = msi_utils.correct_multiscale_origins(msi_utils.Msim(sims=[s.copy() for s in levels]))
    tm = tmsi.correct_multiscale_origins(tmsi.Msim(sims=_to_port(levels)))
    _assert_levels_equal(jm, tm)


def test_concat_stack_and_ensure_dim_match_jax():
    rng = np.random.default_rng(3)
    jms, tms = [], []
    for i in range(3):
        js, ts = _pair(si_utils.get_sim_from_array(
            (rng.random((1, 24, 20)) * 100).astype(np.uint16), dims=("c", "y", "x"),
            c_coords=[f"ch{i}"], translation={"y": 1.0 * i, "x": 0.0},
        ))
        kw = dict(scale_factors=[{"y": 2, "x": 2}])
        jms.append(msi_utils.get_msim_from_sim(js, **kw))
        tms.append(tmsi.get_msim_from_sim(ts, **kw))
    _assert_levels_equal(msi_utils.concat(jms, "c"), tmsi.concat(tms, "c"))
    jst = msi_utils.stack(jms, "t", coords=[5, 6, 7])
    tst = tmsi.stack(tms, "t", coords=[5, 6, 7])
    _assert_levels_equal(jst, tst)
    for k, jx in jst.transforms.items():
        np.testing.assert_array_equal(tst.transforms[k].data, jx.data)
    sel = tmsi.multiscale_sel_coords(tmsi.concat(tms, "c"), {"c": "ch2"})
    np.testing.assert_array_equal(sel.get_scale("scale1").data, tms[2].get_scale("scale1").data[0])
    for dim in ("t", "c"):
        jx = msi_utils.ensure_dim(msi_utils.multiscale_sel_coords(jms[0], {"c": "ch0"}), dim)
        tx = tmsi.ensure_dim(tmsi.multiscale_sel_coords(tms[0], {"c": "ch0"}), dim)
        _assert_levels_equal(jx, tx)
    tx = tmsi.ensure_dim(tms[0], "t")
    assert tx.transforms[KEY].has_t and list(tx.transforms[KEY].t_coords) == [0]
    assert tmsi.ensure_dim(tx, "t") is tx


def test_si_utils_concat_stack_match_jax():
    rng = np.random.default_rng(4)
    jsims = []
    for t in range(2):
        jsims.append(si_utils.get_sim_from_array(
            (rng.random((1, 12, 10)) * 100).astype(np.float32), dims=("t", "y", "x"),
            t_coords=[t], affine=param_utils.affine_to_xaffine(
                param_utils.affine_from_translation([t, 1.0])[None], t_coords=[t]
            ),
        ))
    tsims = _to_port(jsims)
    jc, tc = si_utils.concat(jsims, "t"), tsi.concat(tsims, "t")
    np.testing.assert_array_equal(tc.data, jc.to_numpy())
    np.testing.assert_array_equal(tc.coords["t"], jc.coords["t"])
    np.testing.assert_array_equal(tc.transforms[KEY].data, jc.transforms[KEY].data)
    np.testing.assert_array_equal(tc.transforms[KEY].t_coords, jc.transforms[KEY].t_coords)
    js = [s.isel({"t": 0}) for s in jsims]
    jst, tst = si_utils.stack(js, "t"), tsi.stack([s.isel({"t": 0}) for s in tsims], "t")
    np.testing.assert_array_equal(tst.data, jst.to_numpy())
    np.testing.assert_array_equal(tst.transforms[KEY].data, jst.transforms[KEY].data)
    with pytest.raises(ValueError, match="already exists"):
        tsi.stack(tsims, "t")


def test_map_blocks_and_virtual_views(tmp_path):
    data = np.arange(64, dtype=np.uint16).reshape(8, 8)
    sim = tsi.get_sim_from_array(data, translation={"y": 2.0, "x": 3.0})
    msim = tmsi.get_msim_from_sim(sim, scale_factors=[{"y": 2, "x": 2}])
    mapped = tmsi.msim_map_blocks(msim, lambda b: b * 2.0)
    np.testing.assert_array_equal(mapped.get_scale("scale0").to_numpy(), data * 2.0)
    assert set(mapped.transforms) == set(msim.transforms)
    arr = tzb.create_zarr_array(str(tmp_path / "a.zarr"), shape=(8, 8), chunks=(4, 4),
                                dtype="uint16")
    arr[...] = data
    lazy = tmsi.msim_map_blocks(
        tmsi.get_msim_from_sim(tsi.get_sim_from_array(arr), scale_factors=[]),
        lambda b: b.astype(np.float32) + 1,
    )
    assert isinstance(lazy.sims[0].data, tzu.VirtualMap)
    assert lazy.sims[0].data.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(lazy.sims[0].data[2:5, 1:7]),
                                  data[2:5, 1:7].astype(np.float32) + 1)
    with pytest.raises(ValueError):
        tmsi.sim_map_blocks(sim, lambda b: b[::2])
    # lazy stack and concat read only the windows asked for
    stacked = tzu.stack([arr, arr], axis=0)
    assert stacked.shape == (2, 8, 8) and tzu.is_stackable([arr, arr])
    np.testing.assert_array_equal(np.asarray(stacked[1, 2:4]), data[2:4])
    cat = tzu.concatenate([arr, arr[2:5]], axis=0)
    assert cat.shape == (11, 8)
    np.testing.assert_array_equal(np.asarray(cat[6:10, 1]),
                                  np.concatenate([data, data[2:5]])[6:10, 1])
    with pytest.raises(tzu.NotChunkAlignedError):
        tzu.concatenate([arr, arr[:, :3]], axis=0)


def test_get_store_decorator_caches_the_reader(tmp_path):
    calls = {"n": 0}

    @tmsi.get_store_decorator(tmp_path / "cache.ome.zarr")
    def reader():
        calls["n"] += 1
        return tmsi.get_msim_from_sim(
            tsi.get_sim_from_array(np.arange(64, dtype=np.uint16).reshape(8, 8)),
            scale_factors=[],
        )

    reader()
    again = reader()
    assert calls["n"] == 1
    assert isinstance(again.sims[0].data, tzb.LazyZarrArray)
    np.testing.assert_array_equal(again.get_scale("scale0").to_numpy(),
                                  np.arange(64, dtype=np.uint16).reshape(8, 8))
    assert tmsi.get_store_decorator(None)(len) is len


# ---------------------------------------------------------------------------
# OME-Zarr msims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["3d_uint16", "tc_2d_float32"])
def test_ome_zarr_msim_written_by_the_port_reads_as_jax_writes_it(tmp_path, case):
    rng = np.random.default_rng(5)
    if case == "3d_uint16":
        js = si_utils.get_sim_from_array(
            (rng.random((20, 230, 210)) * 4000).astype(np.uint16), dims=("z", "y", "x"),
            scale={"z": 2.0, "y": 0.5, "x": 0.5}, translation={"z": 0.0, "y": 3.0, "x": -1.0},
        )
    else:
        js = si_utils.get_sim_from_array(
            (rng.random((2, 2, 210, 240)) * 100).astype(np.float32), dims=("t", "c", "y", "x"),
            c_coords=["a", "b"], scale={"y": 0.3, "x": 0.3},
        )
    ts = _to_port([js])[0]
    jm = msi_utils.get_msim_from_sim(js)
    tm = tmsi.get_msim_from_sim(ts)
    reg = np.eye(len(js.spatial_dims) + 1)
    reg[0, -1] = 2.5
    msi_utils.set_affine_transform(jm, reg, transform_key="registered", base_transform_key=KEY)
    tmsi.set_affine_transform(tm, reg, transform_key="registered", base_transform_key=KEY)
    jurl, turl = str(tmp_path / "jax.ome.zarr"), str(tmp_path / "port.ome.zarr")
    ngff_utils.write_msim_to_ome_zarr(jm, jurl, overwrite=True)
    tback = tngff.write_msim_to_ome_zarr(tm, turl, overwrite=True)
    # both stores read through the JAX package's tensorstore reader
    jread = ngff_utils.read_msim_from_ome_zarr(jurl)
    tread = ngff_utils.read_msim_from_ome_zarr(turl)
    _assert_levels_equal(jread, tread)
    _assert_levels_equal(jm, tread)
    # the port's lazy read-back of its own store
    _assert_levels_equal(tread, tback)
    for key in ("registered", KEY):
        np.testing.assert_allclose(tread.transforms[key].data, jm.transforms[key].data)
        np.testing.assert_allclose(tback.transforms[key].data, tm.transforms[key].data)
    jattrs, _ = zarr_backend.read_group_metadata(jurl)
    tattrs, _ = tzb.read_group_metadata(turl)
    assert tattrs["multiscales"] == jattrs["multiscales"]
    assert tattrs.get("omero") == jattrs.get("omero")


def test_update_msim_transforms_zarr_round_trip(tmp_path):
    sim = tsi.get_sim_from_array(np.arange(64, dtype=np.float32).reshape(8, 8))
    url = str(tmp_path / "im.ome.zarr")
    tngff.write_sim_to_ome_zarr(sim, url, overwrite=True)
    m = np.eye(3)
    m[:2, -1] = (4.0, -2.0)
    over_t = tpu.XAffine(np.stack([m, np.eye(3)]), t_coords=np.array([3, 4]))
    tmsi.update_msim_transforms_zarr({"registered": tpu.XAffine(m), "drift": over_t}, url)
    back = tngff.read_msim_from_ome_zarr(url)
    np.testing.assert_allclose(back.transforms["registered"].data, m)
    np.testing.assert_allclose(back.transforms["drift"].data, over_t.data)
    np.testing.assert_array_equal(back.transforms["drift"].t_coords, [3, 4])
    assert "drift" in ngff_utils.read_msim_from_ome_zarr(url).transforms
    # the per-level metadata follows an msim's levels, with a key's shift
    msim = tmsi.get_msim_from_sim(sim, scale_factors=[])
    msim.sims[0].origin = {"y": 1.0, "x": 2.0}
    tngff.update_ome_zarr_multiscales_metadata(url, msim, None)
    ms = tzb.read_group_metadata(url)[0]["multiscales"][0]
    assert ms["datasets"][0]["coordinateTransformations"][1]["translation"] == [1.0, 2.0]
    tmsi.set_affine_transform(msim, m, transform_key="registered")
    tngff.update_ome_zarr_multiscales_metadata(url, msim, "registered")
    ms = tzb.read_group_metadata(url)[0]["multiscales"][0]
    assert ms["datasets"][0]["coordinateTransformations"][1]["translation"] == [5.0, 0.0]
    with pytest.raises(ValueError, match="levels"):
        tngff.update_ome_zarr_multiscales_metadata(
            url, tmsi.get_msim_from_sim(sim, scale_factors=[{"y": 2, "x": 2}]), None
        )


# ---------------------------------------------------------------------------
# fuse of msims
# ---------------------------------------------------------------------------


def _tile_msims(dtype, ndim=2, nt=None):
    """Two overlapping tiles cut from one image, as pyramids, in both
    packages."""
    rng = np.random.default_rng(6)
    shape = (256, 300) if ndim == 2 else (20, 220, 240)
    full = rng.random(shape) * (1000 if dtype == np.uint16 else 100)
    w = 170 if ndim == 2 else 140
    jsims = []
    for x0 in (0, shape[-1] - w):
        tile = full[..., x0:x0 + w].astype(dtype)
        dims = ("y", "x") if ndim == 2 else ("z", "y", "x")
        tr = {d: 0.0 for d in dims}
        tr["x"] = float(x0)
        if nt:
            tile = np.stack([tile] * nt)
            dims = ("t",) + dims
        jsims.append(si_utils.get_sim_from_array(tile, dims=dims, translation=tr))
    jm = [msi_utils.get_msim_from_sim(s) for s in jsims]
    tm = [tmsi.get_msim_from_sim(s) for s in _to_port(jsims)]
    return jm, tm


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("ndim", [2, 3])
def test_fuse_msims_in_memory_matches_jax(dtype, ndim):
    jm, tm = _tile_msims(dtype, ndim)
    ref = fusion.fuse(jm, transform_key=KEY)
    got = tfuse(tm, transform_key=KEY, device="cpu")
    assert tmsi.is_msim(got) and len(got.sims) == len(ref.sims) >= 2
    for rs, gs in zip(ref.sims, got.sims):
        assert gs.spacing == pytest.approx(rs.spacing) and gs.origin == pytest.approx(rs.origin)
        _assert_fused_close(gs.data, rs.to_numpy())


def test_fuse_msims_over_t_at_a_coarser_output_spacing_matches_jax():
    jm, tm = _tile_msims(np.uint16, 2, nt=2)
    kw = dict(transform_key=KEY, output_spacing={"y": 2.0, "x": 2.0})
    ref = fusion.fuse(jm, **kw)
    got = tfuse(tm, device="cpu", **kw)
    assert len(got.sims) == len(ref.sims)
    for rs, gs in zip(ref.sims, got.sims):
        assert gs.dims == rs.dims and list(gs.coords["t"]) == list(rs.coords["t"])
        _assert_fused_close(gs.data, rs.to_numpy())


def test_fuse_msims_to_ome_zarr_returns_an_msim(tmp_path):
    jm, tm = _tile_msims(np.uint16)
    kw = dict(transform_key=KEY, zarr_options={"ome_zarr": True})
    ref = fusion.fuse(jm, output_zarr_url=str(tmp_path / "jax.ome.zarr"), **kw)
    got = tfuse(tm, output_zarr_url=str(tmp_path / "port.ome.zarr"), device="cpu", **kw)
    assert tmsi.is_msim(got) and len(got.sims) == len(ref.sims) >= 2
    assert isinstance(got.sims[0].data, tzb.LazyZarrArray)
    for rs, gs in zip(ref.sims, got.sims):
        assert gs.spacing == pytest.approx(rs.spacing) and gs.origin == pytest.approx(rs.origin)
        _assert_fused_close(gs.to_numpy(), rs.to_numpy())
    mem = tfuse(tm, transform_key=KEY, device="cpu")
    np.testing.assert_array_equal(got.sims[0].to_numpy(), mem.sims[0].data)
    # without ome_zarr set, a one-level msim over the fused level 0
    plain = tfuse(tm, transform_key=KEY, device="cpu", output_zarr_url=str(tmp_path / "p.zarr"))
    assert len(plain.sims) == 1
    np.testing.assert_array_equal(plain.sims[0].to_numpy(), mem.sims[0].data)


def test_fuse_msims_to_zarr_uses_the_suitable_input_level(tmp_path):
    """At twice level 0's output spacing the fuse reads each input's level
    1: a sentinel constant there must reach the output."""
    jm, tm = _tile_msims(np.float32)
    msims = []
    for m in tm:
        lvl1 = m.get_scale("scale1")
        sentinel = tsi.get_sim_from_array(
            np.full(lvl1.shape, 7.0, np.float32), dims=lvl1.dims,
            scale=lvl1.spacing, translation=lvl1.origin,
        )
        msims.append(tmsi.Msim(sims=[m.get_scale("scale0"), sentinel]))
    out = tfuse(msims, transform_key=KEY, output_spacing={"y": 2.0, "x": 2.0},
                output_zarr_url=str(tmp_path / "coarse.zarr"), device="cpu")
    assert tmsi.is_msim(out)
    np.testing.assert_allclose(out.sims[0].to_numpy()[1:-1, 1:-1], 7.0, atol=1e-4)


def test_fuse_refuses_a_mix_of_sims_and_msims():
    _, tm = _tile_msims(np.uint16)
    with pytest.raises(ValueError, match="same kind"):
        tfuse([tm[0], tmsi.get_sim_from_msim(tm[1])], transform_key=KEY, device="cpu")


def test_fuse_concat_t_zarr_backed_sims(tmp_path):
    """Tiles whose timepoints are separate OME-Zarr stores, joined lazily
    along t, fuse per timepoint as the JAX package fuses them."""
    rng = np.random.default_rng(11)
    fulls = [rng.random((26, 40)).astype(np.float32) for _ in range(2)]
    jtiles, ttiles = [], []
    for tile_idx, xoff in enumerate((0, 20)):
        jper, tper = [], []
        for ti, full in enumerate(fulls):
            js = si_utils.get_sim_from_array(full[:, xoff:xoff + 20][None], dims=("t", "y", "x"),
                                             translation={"y": 0.0, "x": float(xoff)})
            jback = ngff_utils.write_sim_to_ome_zarr(
                js, str(tmp_path / f"j{tile_idx}_{ti}.ome.zarr"), overwrite=True
            )
            tback = tngff.write_sim_to_ome_zarr(
                _to_port([js])[0], str(tmp_path / f"t{tile_idx}_{ti}.ome.zarr"), overwrite=True
            )
            jback.coords["t"] = np.array([ti])
            tback.coords["t"] = np.array([ti])
            jper.append(jback)
            tper.append(tback)
        jtiles.append(si_utils.concat(jper, "t"))
        ttiles.append(tsi.concat(tper, "t"))
    assert isinstance(ttiles[0].data, tzu.VirtualConcat)
    assert list(ttiles[0].coords["t"]) == [0, 1]
    ref = fusion.fuse(jtiles, transform_key=KEY)
    got = tfuse(ttiles, transform_key=KEY, device="cpu")
    _assert_fused_close(got.data, ref.to_numpy())
    for ti, full in enumerate(fulls):
        np.testing.assert_allclose(got.data[ti], full, atol=0.51)


def test_fuse_of_msims_reads_the_level_0_stack_a_registration_left(monkeypatch):
    """register(device_tiles=True) leaves level 0 in the device tile cache;
    fuse() of the msims reads it there (level 0 is fused first) and uploads
    only the coarser levels."""
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 30)
    tcore.clear_device_tile_cache()
    _, tm = _tile_msims(np.uint16)
    treg.register(tm, transform_key=KEY, new_transform_key="reg", device_tiles=True,
                  device="cpu")
    assert treg.last_telemetry["device_tiles"] is True
    before = residency.tile_upload_bytes
    fused = tfuse(tm, transform_key="reg", device="cpu")
    coarse = sum(m.sims[k].data.nbytes for m in tm for k in range(1, len(m.sims)))
    assert residency.tile_upload_bytes - before == coarse
    assert len(fused.sims) >= 2
    tcore.clear_device_tile_cache()


def test_the_readme_quickstart_runs_through_the_port(tmp_path):
    """The README's pattern: default pyramids of (c, y, x) tiles, register
    by a channel, fuse level 0 into an OME-Zarr; as the JAX package does."""
    jsims = [s.isel({"t": 0}) for s in sample_data.generate_tiled_dataset(
        ndim=2, N_c=2, N_t=1, tiles_x=2, tiles_y=1, tile_size=220, overlap=30)]
    jm = [msi_utils.get_msim_from_sim(s) for s in jsims]
    tm = [tmsi.get_msim_from_sim(s) for s in _to_port(jsims)]
    assert len(tm[0].sims) == 2
    kw = dict(transform_key=KEY, new_transform_key="registered", reg_channel_index=0)
    registration.register(jm, **kw)
    treg.register(tm, device="cpu", **kw)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t.transforms["registered"].data, j.transforms["registered"].data,
                                   atol=1e-3)
    ref = fusion.fuse([msi_utils.get_sim_from_msim(m) for m in jm], transform_key="registered",
                      output_zarr_url=str(tmp_path / "jax.ome.zarr"))
    got = tfuse([tmsi.get_sim_from_msim(m) for m in tm], transform_key="registered",
                output_zarr_url=str(tmp_path / "port.ome.zarr"), device="cpu")
    _assert_fused_close(got.to_numpy(), ref.to_numpy())
