"""The port's general fusion path against the JAX package on the CPU: the
gather resamples, content-based weights, ``fuse_np`` and the tiers of
``fuse`` that take what the translation and exact-affine tiers do not (the
tiles tier, the gather route of the batched tier, the host tier), with the
untrimmed layout.

Inputs are made from a seed with numpy. The JAX side runs with its CPU
defaults: its gather, tiles and host tiers (and its Pallas translation tier
in interpret mode for the default blending of translation grids). The port
runs with ``device="cpu"``, where the exact-affine and translation kernels
take their plain PyTorch versions. JAX sims are carried over with
``convert.sim_from_numpy``.

Tolerances: integer outputs at most 1 count (the f32 blend lands on either
side of a truncation tie); float outputs rtol 1e-4, atol 1e-3 on data in
[0, 900) (the same f32 products summed in another order, and f32 ulps of the
sample coordinates); NaN masks exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import transformation as ttransformation
from multiview_stitcher_torch import weights as tweights
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.ops import resample as tresample
from multiview_stitcher_tpu import si_utils, transformation, weights
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.io import zarr_backend as jzb
from multiview_stitcher_tpu.ops import resample as jresample

KEY = si_utils.DEFAULT_TRANSFORM_KEY
TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    """The reference's CPU defaults (no exact or shear tier), its small
    interpret-mode translation tiles, and empty caches on both sides."""
    for var in ("MVS_TPU_EXACT_AFFINE", "MVS_TPU_SHEAR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "64,64")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_3D", "8,32,64")
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], **TOL)


def _smooth(rng, shape, scale=900.0):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(rng.random(shape), 1.5) * scale


def _grid(ndim, n, tile, step, dtype, seed):
    """n x n translation grid (one plane of them in 3D) of smooth tiles."""
    rng = np.random.default_rng(seed)
    sdims = ["z", "y", "x"][-ndim:]
    grid = (n,) * ndim if ndim == 2 else (1, n, n)
    sims = []
    for idx in np.ndindex(grid):
        sims.append(si_utils.get_sim_from_array(
            _smooth(rng, tile).astype(dtype), dims=sdims,
            translation={d: float(idx[i] * step[i]) for i, d in enumerate(sdims)},
        ))
    return sims


def _rotated(ndim, dtype, seed, nan=False):
    """Two overlapping views, each turned a little about its centre (in 3D
    about y and with a coupling of y into x); ``nan`` cuts a NaN hole into
    each view and NaN borders into the second."""
    rng = np.random.default_rng(seed)
    sdims = ["z", "y", "x"][-ndim:]
    shape = (40, 48) if ndim == 2 else (14, 20, 24)
    sims = []
    for iv in range(2):
        data = _smooth(rng, shape).astype(dtype)
        if nan:
            data[tuple(slice(s // 3, s // 3 + 3) for s in shape)] = np.nan
            if iv:
                data[..., :2] = np.nan
        th = 0.06 * (2 * iv - 1)
        lin = np.eye(ndim)
        c, s = np.cos(th), np.sin(th)
        if ndim == 2:
            lin[:] = [[c, -s], [s, c]]
        else:
            lin[0, 0], lin[0, 2], lin[2, 0], lin[2, 2] = c, -s, s, c
            lin[2, 1] = 0.02
        origin = np.zeros(ndim)
        origin[-1] = 30.0 * iv
        centre = origin + (np.array(shape) - 1) / 2
        m = np.eye(ndim + 1)
        m[:ndim, :ndim], m[:ndim, ndim] = lin, centre - lin @ centre
        sim = si_utils.get_sim_from_array(data, dims=sdims, translation=dict(zip(sdims, origin)))
        si_utils.set_sim_affine(sim, m, transform_key=KEY)
        sims.append(sim)
    return sims


def _fuse_both(sims, **kw):
    ref = jcore.fuse(sims, transform_key=KEY, **kw)
    got = tcore.fuse(_to_port(sims), transform_key=KEY, device="cpu", **kw)
    assert got.spacing == ref.spacing and got.origin == ref.origin
    return got, ref


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
@pytest.mark.parametrize("order", [0, 1])
def test_affine_resample_orders_nan_and_float64_match_jax(ndim, dtype, order):
    rng = np.random.default_rng(ndim)
    shape, out_shape = (12, 14, 10)[-ndim:], (9, 16, 11)[-ndim:]
    data = (rng.random((3,) + shape) * 900).astype(dtype)
    if dtype != np.uint16:
        data[1, 2:4] = np.nan
    mats = np.stack([np.eye(ndim) + rng.normal(0, 0.08, (ndim, ndim)) for _ in range(3)])
    mats[0] = np.eye(ndim)
    offs = rng.normal(0, 2, (3, ndim))
    offs[0] = np.round(offs[0])
    mats, offs = mats.astype(np.float32), offs.astype(np.float32)
    for cval in (np.nan, 0.0):
        ref = jresample.affine_resample_batch(data, mats, offs, out_shape, order=order, cval=cval)
        got = tresample.affine_resample_batch(_t(data), mats, offs, out_shape, order=order,
                                              cval=cval)
        assert got.numpy().dtype == np.asarray(ref).dtype
        _close(got.numpy(), ref)


def test_affine_resample_windows_equals_cut_and_padded_slabs():
    """Windows read in place from a stack give what the reference gets from
    slabs cut on the host and NaN-padded to the window."""
    rng = np.random.default_rng(3)
    stack = (rng.random((3, 20, 17)) * 900).astype(np.float32)
    stack[1, 5:7, 3:9] = np.nan
    tile_idx, window = np.array([0, 1, 2, 1]), (12, 15)
    starts = np.array([[0, 0], [4, 2], [10, 9], [15, 12]])
    extents = np.minimum(window, np.array(stack.shape[1:]) - starts)
    mats = (np.eye(2) + rng.normal(0, 0.05, (4, 2, 2))).astype(np.float32)
    offs = rng.normal(1, 2, (4, 2)).astype(np.float32)
    slabs = np.full((4,) + window, np.nan, np.float32)
    for i in range(4):
        (a, b), (ea, eb) = starts[i], extents[i]
        slabs[i, :ea, :eb] = stack[tile_idx[i], a:a + ea, b:b + eb]
    for order in (0, 1):
        ref = jresample.affine_resample_batch(slabs, mats, offs, (13, 11), order=order)
        got = tresample.affine_resample_windows(_t(stack), tile_idx, starts, extents, window,
                                                mats, offs, (13, 11), order=order)
        _close(got.numpy(), ref)


@pytest.mark.parametrize("ndim", [2, 3])
def test_translate_resample_matches_jax(ndim):
    rng = np.random.default_rng(5 + ndim)
    shape = (10, 12, 9)[-ndim:]
    image = (rng.random(shape) * 900).astype(np.float32)
    stack = (rng.random((4,) + shape) * 900).astype(np.float32)
    shifts = rng.normal(0, 2.5, (4, ndim))
    shifts[0] = np.round(shifts[0])
    for order in (0, 1):
        _close(tresample.translate_resample(_t(image), shifts[1], order=order).numpy(),
               jresample.translate_resample(image, shifts[1], order=order))
        # one image broadcast over the shifts, and one shift an item
        _close(tresample.translate_resample_batch(_t(image), shifts, order=order).numpy(),
               jresample.translate_resample_batch(image, shifts, order=order))
        _close(tresample.translate_resample_batch(_t(stack), shifts, order=order).numpy(),
               jresample.translate_resample_batch(stack, shifts, order=order))


@pytest.mark.parametrize("ndim", [2, 3])
def test_transform_sim_order_0_nan_and_float64_match_jax(ndim):
    sim = _rotated(ndim, np.float32, 11, nan=True)[1]
    osp = si_utils.get_stack_properties_from_sim(sim)
    p = np.linalg.inv(np.asarray(sim.transforms[KEY].data))
    clean = np.nan_to_num(np.asarray(sim.data))
    for data, order in ((clean, 0), (np.asarray(sim.data), 1), (np.asarray(sim.data), 0),
                        (clean.astype(np.float64), 1)):
        jsim = si_utils.get_sim_from_array(data, dims=sim.dims, translation=sim.origin)
        ref = transformation.transform_sim(jsim, p, output_stack_properties=osp, order=order)
        got = ttransformation.transform_sim(_to_port([jsim])[0], p, output_stack_properties=osp,
                                            order=order, device="cpu")
        assert got.data.dtype == np.asarray(ref.data).dtype == data.dtype
        _close(got.data, np.asarray(ref.data))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_get_blending_weights_matches_jax():
    target = {"shape": {"y": 30, "x": 40}, "spacing": {"y": 1.0, "x": 0.8},
              "origin": {"y": -3.0, "x": 2.0}}
    source = {"shape": {"y": 25, "x": 33}, "spacing": {"y": 1.1, "x": 1.0},
              "origin": {"y": 1.0, "x": 0.5}}
    aff = np.eye(3)
    aff[:2, :2] = [[np.cos(0.1), -np.sin(0.1)], [np.sin(0.1), np.cos(0.1)]]
    aff[:2, 2] = (1.5, -2.0)
    for kw in ({}, {"blending_widths": {"y": 4.0, "x": 6.0}, "shrink_distance": 1.0}):
        ref = weights.get_blending_weights(target, source, aff, **kw)
        got = tweights.get_blending_weights(target, source, aff, device="cpu", **kw)
        _close(got.numpy(), ref)


def _views_and_bw(ndim, seed):
    rng = np.random.default_rng(seed)
    shape = (3,) + ((30, 37) if ndim == 2 else (9, 14, 17))
    tv = _smooth(rng, shape).astype(np.float32)
    tv[0, ..., :4] = np.nan
    bw = rng.random(shape).astype(np.float32)
    bw[1, ..., -3:] = 0.0
    return tv, bw


def _close_weights(got, ref):
    """Weights of the port (float32) against the reference's. The tests run
    the reference with ``jax_enable_x64`` (tests/conftest.py), under which
    its NaN-aware gaussian's validity mask, ``jnp.where(nan_mask, 0.0,
    1.0)``, is float64 and so are its weights; the values are compared."""
    _close(got, np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("ndim", [2, 3])
def test_content_based_matches_jax(ndim):
    tv, bw = _views_and_bw(ndim, 20 + ndim)
    for kw in ({}, {"sigma_1": 2, "sigma_2": 4}):
        ref = np.asarray(weights.content_based(tv, bw, **kw))
        got = tweights.content_based(_t(tv), _t(bw), **kw).numpy()
        _close_weights(got, ref)
    assert tweights.content_based.required_overlap({}) == 22
    assert tweights.content_based.required_overlap({"sigma_2": 4}) == 8


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("otf", [None, 0.5])
def test_content_based_dct_matches_jax(ndim, otf):
    tv, _ = _views_and_bw(ndim, 30 + ndim)
    kw = dict(dct_size=8, otf_support_fraction=otf)
    ref = np.asarray(weights.content_based_dct(tv, **kw))
    got = tweights.content_based_dct(_t(tv), **kw).numpy()
    _close_weights(got, ref)
    chunks = dict(zip(["z", "y", "x"][-ndim:], (6, 5, 7)[-ndim:]))
    ref = np.asarray(weights.content_based_dct(tv, output_chunksize=chunks, **kw))
    got = tweights.content_based_dct(_t(tv), output_chunksize=chunks, **kw).numpy()
    _close_weights(got, ref)
    assert tweights.content_based_dct.required_overlap({"dct_size": 8}) == 8


# ---------------------------------------------------------------------------
# fuse_np and the host tier
# ---------------------------------------------------------------------------


def _custom_fusion(transformed_views, params, output_spacing, blending_weights=None,
                   fusion_weights=None):
    """Blends by ``fusion_weights`` times ``blending_weights`` (either may be
    missing: 1), plus a term of each view's translation and of the spacing,
    so that every input must arrive."""
    xp = torch if isinstance(transformed_views, torch.Tensor) else jax.numpy
    w = xp.ones_like(transformed_views)
    for extra in (blending_weights, fusion_weights):
        if extra is not None:
            w = w * extra
    valid = ~xp.isnan(transformed_views)
    w = xp.where(valid, w, 0.0)
    total = w.sum(0)
    fused = xp.where(valid, transformed_views, 0.0) * w
    shift = float(sum(np.asarray(p)[0, -1] for p in params)) + float(output_spacing["x"])
    return fused.sum(0) / xp.where(total > 0, total, 1.0) + shift


def _weights_by_view(transformed_views, blending_weights):
    """A weights function that names ``blending_weights``."""
    return blending_weights * (1.0 + 0.5 * (transformed_views > 400))


def test_fuse_np_matches_jax():
    sims = _rotated(2, np.float32, 40, nan=True)
    props = {"shape": {"y": 36, "x": 60}, "spacing": {"y": 1.0, "x": 1.0},
             "origin": {"y": 2.0, "x": 5.0}}
    params = [np.asarray(s.transforms[KEY].data) for s in sims]
    cases = [
        dict(),
        dict(fusion_func=jcore.max_fusion),
        dict(fusion_func=_custom_fusion),
        dict(fusion_func=_custom_fusion, weights_func="content_based",
             weights_func_kwargs={"sigma_1": 2, "sigma_2": 4}, trim_overlap_in_pixels=3),
        dict(fusion_func="weighted_average_fusion", weights_func=_weights_by_view),
    ]
    for kw in cases:
        jkw, tkw = dict(kw), dict(kw)
        for k, v in kw.items():
            if isinstance(v, str):
                jkw[k] = getattr(weights, v, None) or getattr(jcore, v)
                tkw[k] = getattr(tweights, v, None) or getattr(tcore, v)
        if "fusion_func" in kw and kw["fusion_func"] is jcore.max_fusion:
            tkw["fusion_func"] = tcore.max_fusion
        ref = jcore.fuse_np(sims, params, props, **jkw)
        got = tcore.fuse_np(_to_port(sims), params, props, device="cpu", **tkw)
        _close(got, ref)


def test_signature_dispatch_passes_only_named_inputs():
    """A ``functools.partial`` keeps the names it leaves open, and a
    ``**kwargs`` catch-all names nothing: it gets ``transformed_views`` only
    (as the reference's ``has_keyword`` decides)."""
    seen = {}

    def catch_all(transformed_views, **kwargs):
        seen["catch_all"] = sorted(kwargs)
        return transformed_views[0]

    def with_scale(transformed_views, params, scale):
        seen["partial"] = (len(params), scale)
        return transformed_views[0] * scale

    sims = _to_port(_rotated(2, np.float32, 41))
    props = {"shape": {"y": 20, "x": 30}, "spacing": {"y": 1.0, "x": 1.0},
             "origin": {"y": 5.0, "x": 10.0}}
    params = [np.asarray(s.transforms[KEY].data) for s in sims]
    plain = tcore.fuse_np(sims[:1], params[:1], props, fusion_func=catch_all, device="cpu")
    assert seen["catch_all"] == []
    scaled = tcore.fuse_np(sims[:1], params[:1], props,
                           fusion_func=functools.partial(with_scale, scale=2.0), device="cpu")
    assert seen["partial"] == (1, 2.0)
    np.testing.assert_allclose(scaled, 2 * plain, rtol=1e-6)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(50)
    image = rng.random((12, 15))
    image[3:5, 4:9] = np.nan
    for method in ("nearest", "linear"):
        np.testing.assert_array_equal(
            tcore.get_interpolated_image(image, method=method),
            jcore.get_interpolated_image(image, method=method),
        )
    views = np.full((2, 3), np.nan)
    assert np.isnan(tcore.func_ignore_nan_warning(np.nanmax, views, axis=0)).all()


@pytest.mark.parametrize("ndim", [2, 3])
def test_fuse_content_based_matches_jax(ndim):
    if ndim == 2:
        sims = _grid(2, 2, (48, 48), (36, 36), np.uint16, 60)
        kw = dict(output_chunksize=42)  # sigma_2 = 11: a halo of 22
    else:
        sims = _grid(3, 2, (10, 24, 24), (0, 18, 18), np.uint16, 61)
        kw = dict(output_chunksize={"z": 10, "y": 21, "x": 21},
                  weights_func_kwargs={"sigma_1": 2, "sigma_2": 3})
    ref = jcore.fuse(sims, transform_key=KEY, weights_func=weights.content_based, **kw)
    got = tcore.fuse(_to_port(sims), transform_key=KEY, weights_func=tweights.content_based,
                     device="cpu", **kw)
    _close(got.data, np.asarray(ref.data))
    plain = tcore.fuse(_to_port(sims), transform_key=KEY, device="cpu", **{
        k: v for k, v in kw.items() if k != "weights_func_kwargs"})
    assert np.abs(got.data.astype(np.int64) - plain.data.astype(np.int64)).max() > 1


def test_fuse_with_channels_through_the_host_and_batched_tiers():
    """A ``c`` dim: each channel fused on its own, with content-based
    weights (host tier) and in the untrimmed layout (batched tier)."""
    rng = np.random.default_rng(63)
    sims = [
        si_utils.get_sim_from_array(
            _smooth(rng, (2, 40, 40)).astype(np.uint16), dims=("c", "y", "x"),
            translation={"y": 0.0, "x": 30.0 * iv}, c_coords=["a", "b"],
        )
        for iv in range(2)
    ]
    for jkw, tkw in (
        (dict(weights_func=weights.content_based), dict(weights_func=tweights.content_based)),
        (dict(fusion_func=jcore.max_fusion), dict(fusion_func=tcore.max_fusion)),
    ):
        kw = dict(output_chunksize=24, overlap_in_pixels=3, trim_overlap="fusion_func" not in jkw)
        ref = jcore.fuse(sims, transform_key=KEY, **jkw, **kw)
        got = tcore.fuse(_to_port(sims), transform_key=KEY, device="cpu", **tkw, **kw)
        assert got.dims == ref.dims and got.origin == ref.origin
        _close(got.data, np.asarray(ref.data))


def test_entry_points_without_device_need_cuda():
    """Without a card the entry points raise unless asked for the CPU: none
    falls back to it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there by default")
    sims = _to_port(_rotated(2, np.float32, 64))
    params = [np.asarray(s.transforms[KEY].data) for s in sims]
    props = {"shape": {"y": 8, "x": 8}, "spacing": {"y": 1.0, "x": 1.0},
             "origin": {"y": 5.0, "x": 5.0}}
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.fuse_np(sims, params, props)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.fuse(sims, transform_key=KEY, weights_func=tweights.content_based)
    with pytest.raises(RuntimeError, match="CUDA"):
        tweights.get_blending_weights(props, props, np.eye(3))


def test_fuse_content_based_dct_and_custom_functions_match_jax():
    sims = _rotated(2, np.float32, 62)
    for jkw, tkw in (
        (dict(weights_func=weights.content_based_dct, weights_func_kwargs={"dct_size": 8}),
         dict(weights_func=tweights.content_based_dct, weights_func_kwargs={"dct_size": 8})),
        (dict(fusion_func=_custom_fusion), dict(fusion_func=_custom_fusion)),
        (dict(fusion_func=_custom_fusion, weights_func=weights.content_based,
              weights_func_kwargs={"sigma_1": 2, "sigma_2": 4}),
         dict(fusion_func=_custom_fusion, weights_func=tweights.content_based,
              weights_func_kwargs={"sigma_1": 2, "sigma_2": 4})),
        (dict(fusion_func=jcore.max_fusion, fusion_func_kwargs={}),
         dict(fusion_func=tcore.max_fusion, fusion_func_kwargs={})),
    ):
        ref = jcore.fuse(sims, transform_key=KEY, output_chunksize=24, **jkw)
        got = tcore.fuse(_to_port(sims), transform_key=KEY, output_chunksize=24, device="cpu",
                         **tkw)
        _close(got.data, np.asarray(ref.data))


# ---------------------------------------------------------------------------
# tiles tier and the gather route
# ---------------------------------------------------------------------------


def _zarr_tiles(tmp_path, sims):
    """Each tile as its own zarr v2 array (written by tensorstore), and the
    reference's and the port's lazy sims of them."""
    jsims, psims = [], []
    for i, s in enumerate(sims):
        url = str(tmp_path / "tiles" / f"tile_{i}.zarr")
        data = np.asarray(s.data)
        jzb.create_zarr_array(url, data.shape, data.shape, data.dtype,
                              compressor={"id": "zlib", "level": 1})[...] = data
        kw = dict(dims=s.dims, translation=dict(s.origin))
        jsim = si_utils.get_sim_from_array(jzb.open_zarr_array(url), **kw)
        psim = tsi.get_sim_from_array(tzb.open_zarr_array(url), **kw)
        for key, x in s.transforms.items():
            si_utils.set_sim_affine(jsim, x.data, transform_key=key)
            tsi.set_sim_affine(psim, x.data, transform_key=key)
        jsims.append(jsim)
        psims.append(psim)
    return jsims, psims


@pytest.mark.parametrize("fusion_func", ["max_fusion", "simple_average_fusion"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_builtin_fusion_of_translation_grids_matches_jax(fusion_func, ndim, monkeypatch):
    if ndim == 2:
        sims = _grid(2, 3, (32, 32), (24, 26), np.uint16, 70)
        cs = 40
    else:
        sims = _grid(3, 2, (8, 20, 20), (0, 15, 16), np.float32, 71)
        cs = {"z": 8, "y": 16, "x": 16}
    calls = []
    monkeypatch.setattr(tcore, "_resample_tiles", _spy(tcore._resample_tiles, calls))
    ref = jcore.fuse(sims, transform_key=KEY, fusion_func=getattr(jcore, fusion_func),
                     output_chunksize=cs)
    got = tcore.fuse(_to_port(sims), transform_key=KEY, fusion_func=getattr(tcore, fusion_func),
                     output_chunksize=cs, device="cpu")
    assert calls, "the tiles tier did not run"
    _close(got.data, np.asarray(ref.data))


def _spy(fn, calls):
    def wrapped(*a, **k):
        calls.append(True)
        return fn(*a, **k)

    return wrapped


@pytest.mark.parametrize("fusion_func", ["max_fusion", "simple_average_fusion"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_builtin_fusion_of_zarr_backed_grids_matches_jax(fusion_func, ndim, tmp_path):
    if ndim == 2:
        sims, cs = _grid(2, 3, (32, 32), (24, 26), np.uint16, 72), 40
    else:
        sims, cs = _grid(3, 2, (8, 20, 20), (0, 15, 16), np.uint16, 74), 16
    jsims, psims = _zarr_tiles(tmp_path, sims)
    ref = jcore.fuse(jsims, transform_key=KEY, fusion_func=getattr(jcore, fusion_func),
                     output_chunksize=cs)
    got = tcore.fuse(psims, transform_key=KEY, fusion_func=getattr(tcore, fusion_func),
                     output_chunksize=cs, device="cpu")
    _close(got.data, np.asarray(ref.data))


def test_views_above_the_kernels_scale_take_the_tiles_tier():
    """Output pixels 10x the views' (a scale the translation kernels refuse)
    go to the tiles tier, as in the reference."""
    sims = _grid(2, 2, (40, 40), (30, 30), np.uint16, 73)
    got, ref = _fuse_both(sims, output_spacing={"y": 10.0, "x": 10.0})
    _close(got.data, np.asarray(ref.data))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_views_with_nan_and_float64_views_match_jax(ndim, dtype, monkeypatch):
    """NaN-holding float32 views take the gather route (NaN pixels drop out
    of a view's contribution), as do lazy float views; float64 views without
    NaN take the exact kernels. Every builtin fusion function."""
    sims = _rotated(ndim, dtype, 80 + ndim, nan=dtype == np.float32)
    cs = 24 if ndim == 2 else 12
    gathered = []
    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_gather",
                        _spy(tcore._fuse_chunk_batch_kernel_gather, gathered))
    for name in ("weighted_average_fusion", "max_fusion", "simple_average_fusion"):
        ref = jcore.fuse(sims, transform_key=KEY, fusion_func=getattr(jcore, name),
                         output_chunksize=cs)
        got = tcore.fuse(_to_port(sims), transform_key=KEY, fusion_func=getattr(tcore, name),
                         output_chunksize=cs, device="cpu")
        assert not np.isnan(got.data).any()
        _close(got.data, np.asarray(ref.data))
    assert bool(gathered) == (dtype == np.float32)


def test_lazy_float_views_take_the_gather_route(tmp_path, monkeypatch):
    jsims, psims = _zarr_tiles(tmp_path, _rotated(2, np.float32, 85, nan=True))
    gathered = []
    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_gather",
                        _spy(tcore._fuse_chunk_batch_kernel_gather, gathered))
    ref = jcore.fuse(jsims, transform_key=KEY, output_chunksize=24)
    got = tcore.fuse(psims, transform_key=KEY, output_chunksize=24, device="cpu")
    assert gathered
    _close(got.data, np.asarray(ref.data))


@pytest.mark.parametrize("order", [0, 3])
def test_interpolation_orders_match_jax(order, monkeypatch):
    """Any order only widens (or, at 0, narrows) the planned source windows.
    Views the port resamples with the exact-affine kernels are held to the
    reference's exact tier (``MVS_TPU_EXACT_AFFINE=1``, the tier it takes on
    its accelerator): at order 0 the reference's gather tier on the CPU
    reads windows with no interpolation margin at unclamped starts and drops
    the view at chunk borders (its output there is 0, 528 counts off here),
    which its exact tier, with starts clamped into the stack, does not. NaN
    views take the gather on both sides, so they keep that behaviour."""
    cases = (
        (_rotated(3, np.float32, 91, nan=True), dict(output_chunksize=12), False),
        (_grid(2, 2, (40, 40), (30, 30), np.uint16, 92), {}, False),
        (_grid(2, 2, (40, 40), (30, 30), np.uint16, 93),
         dict(fusion_func="max_fusion", output_chunksize=32), False),
        (_rotated(2, np.uint16, 90), dict(output_chunksize=24), True),
    )
    for sims, kw, exact in cases:
        if exact:
            monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
            monkeypatch.setenv("MVS_TPU_SHEAR", "0")
        jkw, tkw = dict(kw), dict(kw)
        if "fusion_func" in kw:
            jkw["fusion_func"] = getattr(jcore, kw["fusion_func"])
            tkw["fusion_func"] = getattr(tcore, kw["fusion_func"])
        ref = jcore.fuse(sims, transform_key=KEY, interpolation_order=order, **jkw)
        got = tcore.fuse(_to_port(sims), transform_key=KEY, interpolation_order=order,
                         device="cpu", **tkw)
        _close(got.data, np.asarray(ref.data))


# ---------------------------------------------------------------------------
# trim_overlap=False: the untrimmed layout
# ---------------------------------------------------------------------------


def _untrimmed_cases():
    ramp = si_utils.get_sim_from_array(np.arange(100, dtype=np.float32).reshape(10, 10),
                                       dims=("y", "x"))
    return {
        # the reference's tests/test_fusion.py:645-720
        "ramp_max": ([ramp], "max_fusion", {"y": 5, "x": 5}, 1),
        "grid_max": (_grid(2, 2, (30, 30), (22, 22), np.uint16, 95), "max_fusion", 16, 3),
        "rotated_average": (_rotated(2, np.float32, 96), "weighted_average_fusion", 24, 2),
        "custom": ([ramp], "custom", {"y": 5, "x": 5}, 1),
    }


@pytest.mark.parametrize("name", ["ramp_max", "grid_max", "rotated_average", "custom"])
def test_untrimmed_layout_matches_jax(name, tmp_path):
    sims, func, cs, ov = _untrimmed_cases()[name]
    if func == "custom":
        jf = tf = _custom_fusion
    else:
        jf, tf = getattr(jcore, func), getattr(tcore, func)
    kw = dict(output_chunksize=cs, overlap_in_pixels=ov, trim_overlap=False)
    ref = jcore.fuse(sims, transform_key=KEY, fusion_func=jf, **kw)
    got = tcore.fuse(_to_port(sims), transform_key=KEY, fusion_func=tf, device="cpu", **kw)
    assert got.origin == ref.origin and got.data.shape == np.asarray(ref.data).shape
    _close(got.data, np.asarray(ref.data))
    for ome_zarr in (False, True):
        url = str(tmp_path / f"{name}_{ome_zarr}.zarr")
        zarr = tcore.fuse(_to_port(sims), transform_key=KEY, fusion_func=tf, device="cpu",
                          output_zarr_url=url, zarr_options={"ome_zarr": ome_zarr}, **kw)
        assert zarr.origin == ref.origin
        level0 = jzb.open_zarr_array(f"{url}/0" if ome_zarr else url).read()
        np.testing.assert_array_equal(level0, got.data)
