"""The port's exact-affine wrappers and ``transform_sim`` against the JAX package.

Inputs are made from a seed with numpy. The JAX functions run their Pallas
kernels in interpret mode on the CPU with windows from ``plan_windows_*``, as
``tests/test_exact_affine.py`` runs them; the port's wrappers are given CPU
tensors and take their plain PyTorch versions.

Tolerances: the ``cval`` masks must be identical. Values differ by f32 ulps
of the sample coordinate (the reference interpolates at window-local
coordinates, the port at the absolute coordinate it masks with): below 5e-3
on data in [0, 100), the reference's own bound against its gather tier
(tests/test_exact_affine.py:64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import transformation as ttransformation
from multiview_stitcher_torch.ops import exact_affine as tea
from multiview_stitcher_tpu import si_utils, transformation
from multiview_stitcher_tpu.ops import exact_affine as ea
from multiview_stitcher_tpu.ops import resample as jresample

VALUE_ATOL = 5e-3


def _rot2(theta, scale=1.0):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]]) * scale


def _roty(theta, yscale=1.0):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, yscale, 0], [s, 0, c]])


def _general(seed):
    """The reference's two coupled families: weak near-identity coupling and
    a strong two-axis rotation (tests/test_exact_affine.py:240-247)."""
    if seed == 0:
        return np.eye(3) + np.random.default_rng(0).normal(0, 0.02, (3, 3))
    cz, sz = np.cos(0.2), np.sin(0.2)
    return _roty(0.4) @ np.array([[1, 0, 0], [0, cz, -sz], [0, sz, cz]])


def _jax(kind, data, mats, offs, extents, out_shape, cval=np.nan):
    """The reference wrapper of ``kind`` in interpret mode."""
    args = (
        jnp.asarray(data), jnp.asarray(mats, jnp.float32), jnp.asarray(offs, jnp.float32),
        jnp.asarray(extents, jnp.float32), tuple(out_shape),
    )
    if kind == "2d":
        win = ea.plan_windows_2d(mats)
        out = ea.exact_affine_batch_2d(
            *args, tile=(8, 128), HW=win[0], WW=win[1], cval=cval, interpret=True)
    elif kind == "sepy":
        win = ea.plan_windows_3d(mats, tile=(8, 32, 128))
        out = ea.exact_affine_batch_3d_sepy(
            *args, tile=(8, 32, 128), ZS=win[0], XS=win[1], YW=win[2], cval=cval,
            interpret=True)
    else:
        win = ea.plan_windows_3d_general(mats)
        out = ea.exact_affine_batch_3d_general(
            *args, tile=(8, 4, 32), ZS=win[0], YB=win[1], XS=win[2], cval=cval,
            interpret=True)
    return np.asarray(out)


_WRAPPERS = {
    "2d": tea.exact_affine_batch_2d,
    "sepy": tea.exact_affine_batch_3d_sepy,
    "general": tea.exact_affine_batch_3d_general,
}


def _port(kind, data, mats, offs, extents, out_shape, cval=np.nan, **kw):
    out = _WRAPPERS[kind](
        torch.from_numpy(np.asarray(data)), np.asarray(mats, np.float32),
        np.asarray(offs, np.float32), np.asarray(extents, np.float32), out_shape,
        cval=cval, **kw,
    )
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


def _assert_same(got, ref, cval=np.nan):
    assert got.shape == ref.shape
    if np.isnan(cval):
        # identical out-of-domain masks
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        m = ~np.isnan(ref)
    else:
        m = np.ones(ref.shape, bool)
    assert m.any()
    assert np.abs(got[m] - ref[m]).max() < VALUE_ATOL


_SINGLE_MAPS = (
    [("2d", _rot2(th, sc), off) for th, sc, off in [
        (0.3, 1.0, (2.3, -4.7)), (0.0, 1.0, (0.5, 0.5)),
        (-0.8, 1.3, (10.0, 3.2)), (1.4, 0.7, (-3.0, 8.1)),
    ]]
    + [("sepy", _roty(th, 1.1), (1.2, -2.3, 3.4)) for th in (0.4, -0.7, 0.0, 1.2)]
    + [("general", _general(seed), (1.2, -2.3, 3.4)) for seed in (0, 1)]
)


@pytest.mark.parametrize("case", range(len(_SINGLE_MAPS)))
def test_wrapper_matches_jax_on_the_reference_maps(case):
    kind, M, off = _SINGLE_MAPS[case]
    rng = np.random.default_rng(case)
    src_shape, out_shape = ((60, 90), (50, 80)) if kind == "2d" else ((20, 30, 40), (18, 25, 35))
    data = (rng.random(src_shape) * 100).astype(np.float32)
    args = (data[None], M[None], np.array([off]), np.array([src_shape]), out_shape)
    _assert_same(_port(kind, *args), _jax(kind, *args))


def _about_centre(M, src_shape, out_shape):
    """Offset that sends the centre of the output grid to the source's."""
    return (np.asarray(src_shape) - 1) / 2 - M @ ((np.asarray(out_shape) - 1) / 2)


@pytest.mark.parametrize("kind", ["sepy", "general"])
@pytest.mark.parametrize("degrees", [47, 92, 137, -133])
def test_wrapper_matches_jax_on_steep_rotations_about_y(kind, degrees):
    """The multi-view angles of the GPU smoke test, which spread a row of
    output voxels over as many source planes; both 3D wrappers take them."""
    src_shape, out_shape = (20, 30, 40), (18, 25, 35)
    M = _roty(np.deg2rad(degrees), 1.07)
    off = _about_centre(M, src_shape, out_shape) + (0.3, -0.4, 0.2)
    data = (np.random.default_rng(abs(degrees)).random(src_shape) * 100).astype(np.float32)
    args = (data[None], M[None], off[None], np.array([src_shape]), out_shape)
    got = _port(kind, *args)
    assert 0.3 < np.mean(~np.isnan(got)) < 0.9
    _assert_same(got, _jax(kind, *args))


_SHEAR_8 = np.array([[1.0, 0, 8.0], [0, 1, 0], [0, 0, 1]])


@pytest.mark.parametrize("kind,M,off", [
    ("sepy", _SHEAR_8, (0.4, 0.3, 0.6)),
    ("general", _SHEAR_8, (0.4, 0.3, 0.6)),
    ("general", _general(1) @ _SHEAR_8, (30.0, 2.0, 3.0)),
])
def test_wrapper_matches_the_gather_tier_on_a_steep_shear(kind, M, off):
    """A shear of z by 8 x, alone and on top of the two-axis rotation: 32
    output voxels along x span some 250 source planes. The reference's
    ``plan_windows_*`` cannot window such a map (they return None), so the
    case is held against its gather tier, ``ops.resample.affine_resample``,
    whose mask and values the exact tier reproduces."""
    src_shape, out_shape = (300, 12, 40), (18, 11, 37)
    planner = ea.plan_windows_3d if kind == "sepy" else ea.plan_windows_3d_general
    assert planner(M[None]) is None
    data = (np.random.default_rng(11).random(src_shape) * 100).astype(np.float32)
    got = _port(kind, data[None], M[None], np.array([off]), np.array([src_shape]), out_shape)[0]
    ref = np.asarray(jresample.affine_resample(
        jnp.asarray(data), M, np.asarray(off), out_shape, order=1))
    assert 0.1 < np.mean(~np.isnan(got)) <= 1.0
    _assert_same(got, ref)


def _tables_as_the_device_packs_them(ndim, B, mats, offs, extents, tile_idx, starts, valid):
    """``fparams`` and ``iparams`` built with ``torch.cat``, column by column."""
    f = torch.cat([
        torch.as_tensor(mats, dtype=torch.float32).reshape(B, ndim * ndim),
        torch.as_tensor(offs, dtype=torch.float32),
        torch.as_tensor(extents, dtype=torch.float32),
    ], dim=1)
    src = torch.arange(B, dtype=torch.int32) if tile_idx is None else torch.as_tensor(
        tile_idx, dtype=torch.int32)
    st = torch.zeros((B, ndim), dtype=torch.int32) if starts is None else torch.as_tensor(
        starts, dtype=torch.int32)
    ok = torch.ones(B, dtype=torch.int32) if valid is None else torch.as_tensor(valid).to(
        torch.int32)
    return f, torch.cat([src[:, None], st, ok[:, None]], dim=1)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_host_packed_tables_equal_the_device_packed_ones(ndim, stacked, with_valid):
    """Host arrays are packed with numpy into one buffer; tensors are
    converted and concatenated with torch. Both give the same bits."""
    rng = np.random.default_rng(ndim + 2 * stacked + 4 * with_valid)
    B = 5
    # float64 tables, as fuse() hands them over: both packings round them to f32
    mats = rng.normal(0, 1, (B, ndim, ndim))
    offs = rng.normal(0, 50, (B, ndim))
    extents = rng.integers(1, 40, (B, ndim)).astype(np.float64)
    data = torch.zeros((B if not stacked else 3,) + (8,) * ndim)
    tile_idx = rng.integers(0, 3, B).astype(np.int64) if stacked else None
    starts = rng.integers(0, 4, (B, ndim)).astype(np.int64) if stacked else None
    valid = (rng.random(B) < 0.6) if with_valid else None
    out_shape = (4,) * ndim

    host = tea._check_args(ndim, data, mats, offs, extents, out_shape, 0.0,
                           tile_idx, starts, valid)
    as_tensor = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    dev = tea._check_args(ndim, data, torch.as_tensor(mats), torch.as_tensor(offs),
                          torch.as_tensor(extents), out_shape, 0.0,
                          as_tensor(tile_idx), as_tensor(starts), as_tensor(valid))
    f, i = _tables_as_the_device_packs_them(ndim, B, mats, offs, extents, tile_idx, starts, valid)
    for a in (host, dev):
        assert a.fparams.dtype == torch.float32 and a.iparams.dtype == torch.int32
        assert a.fparams.is_contiguous() and a.iparams.is_contiguous()
        # compared as bits: -0.0 and NaN payloads would count too
        assert torch.equal(a.fparams.view(torch.int32), f.view(torch.int32))
        assert torch.equal(a.iparams, i)
    # lists and a mix of arrays and tensors pack the same tables
    mixed = tea._check_args(ndim, data, mats.tolist(), torch.as_tensor(offs), extents,
                            out_shape, 0.0, tile_idx, starts, valid)
    assert torch.equal(mixed.fparams, f) and torch.equal(mixed.iparams, i)


def _batch(kind, rng):
    """Three items with different maps, offsets and true extents."""
    if kind == "2d":
        src_shape, out_shape = (48, 64), (40, 72)
        mats = np.stack([_rot2(0.2), _rot2(-0.5, 1.2), _rot2(0.9, 0.8)])
        offs = np.array([[1.5, -3.2], [12.0, 2.25], [-4.0, 20.5]])
        extents = np.array([[48, 64], [40, 50], [33, 64]])
    else:
        src_shape, out_shape = (16, 24, 32), (14, 20, 30)
        if kind == "sepy":
            mats = np.stack([_roty(0.3), _roty(-0.6, 0.9), _roty(0.0, 1.2)])
        else:
            mats = np.stack([_general(0), _general(1), _roty(0.3) @ _general(0)])
        offs = np.array([[1.2, -2.3, 3.4], [6.0, 0.5, -2.0], [-1.5, 2.0, 4.75]])
        extents = np.array([[16, 24, 32], [12, 24, 20], [16, 17, 32]])
    data = (rng.random((3,) + src_shape) * 100).astype(np.float32)
    return data, mats, offs, extents, out_shape


@pytest.mark.parametrize("kind", ["2d", "sepy", "general"])
@pytest.mark.parametrize("cval", [np.nan, 0.0])
def test_wrapper_matches_jax_on_a_batch(kind, cval):
    args = _batch(kind, np.random.default_rng(7))
    got, ref = _port(kind, *args, cval=cval), _jax(kind, *args, cval=cval)
    _assert_same(got, ref, cval)
    if cval == 0.0:
        # the mask shows as exact zeros on strictly positive data
        np.testing.assert_array_equal(got == 0.0, ref == 0.0)


@pytest.mark.parametrize("kind", ["2d", "sepy", "general"])
def test_wrapper_reads_nan_and_inf_as_the_reference_does(kind):
    data, mats, offs, extents, out_shape = _batch(kind, np.random.default_rng(8))
    # source positions that every item's map reaches
    at_inf, at_ninf = ((25, 30), (10, 40)) if kind == "2d" else ((12, 15), (11, 14))
    data[0, ..., 10, 12] = np.nan
    data[(1, ...) + at_inf] = np.inf
    data[(2, ...) + at_ninf] = -np.inf
    got = _port(kind, data, mats, offs, extents, out_shape)
    ref = _jax(kind, data, mats, offs, extents, out_shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    m = ~np.isnan(ref)
    assert np.isfinite(got[m]).all() and np.isfinite(ref[m]).all()
    # NaN reads as 0 and +-inf as +-3.4e38. A pixel whose stencil touches an
    # inf is huge in both, with the same sign, but there the f32 ulps of the
    # lerp weight scale with 3.4e38, so values are compared elsewhere only
    big_got, big_ref = np.abs(got[m]) > 1e6, np.abs(ref[m]) > 1e6
    both = big_got & big_ref
    assert both.sum() >= 0.9 * max(big_got.sum(), big_ref.sum()) > 0
    np.testing.assert_array_equal(np.sign(got[m][both]), np.sign(ref[m][both]))
    small = ~(big_got | big_ref)
    assert np.abs(got[m][small] - ref[m][small]).max() < VALUE_ATOL


@pytest.mark.parametrize("kind", ["2d", "sepy", "general"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_wrapper_reads_integer_sources_natively(kind, dtype):
    data, mats, offs, extents, out_shape = _batch(kind, np.random.default_rng(9))
    data = data.astype(dtype)
    got = _port(kind, data, mats, offs, extents, out_shape)
    ref = _jax(kind, data.astype(np.float32), mats, offs, extents, out_shape)
    _assert_same(got, ref)


@pytest.mark.parametrize("kind", ["2d", "sepy", "general"])
def test_tile_idx_and_starts_sample_the_stack_like_slabs(kind):
    """Sampling item b from ``stack[tile_idx[b]]`` at ``starts[b]`` equals
    sampling the slab sliced out of the stack, padding slots give ``cval``."""
    rng = np.random.default_rng(10)
    data, mats, offs, extents, out_shape = _batch(kind, rng)
    ndim = len(out_shape)
    stack = (rng.random((2,) + tuple(s + 9 for s in data.shape[1:])) * 100).astype(np.float32)
    tile_idx = np.array([1, 0, 1, 0], np.int32)
    starts = np.array([[3, 5, 2], [0, 9, 4], [9, 0, 9], [0, 0, 0]], np.int32)[:, -ndim:]
    mats = np.concatenate([mats, np.eye(ndim)[None]])
    offs = np.concatenate([offs, np.zeros((1, ndim))])
    extents = np.concatenate([extents, np.ones((1, ndim))])
    valid = np.array([True, True, True, False])
    got = _port(kind, stack, mats, offs, extents, out_shape,
                tile_idx=tile_idx, starts=starts, valid=valid)
    slabs = np.stack([
        stack[(tile_idx[b],) + tuple(slice(st, st + n) for st, n in zip(starts[b], data.shape[1:]))]
        for b in range(3)
    ])
    ref = _port(kind, slabs, mats[:3], offs[:3], extents[:3], out_shape)
    np.testing.assert_array_equal(got[:3], ref)
    assert np.isnan(got[3]).all()
    zeros = _port(kind, stack, mats, offs, extents, out_shape, cval=0.0,
                  tile_idx=tile_idx, starts=starts, valid=valid)
    assert (zeros[3] == 0).all()


def test_wrappers_check_their_arguments():
    data = torch.zeros((2, 8, 8))
    eye, z, e = np.eye(2)[None].repeat(2, 0), np.zeros((2, 2)), np.full((2, 2), 8.0)
    with pytest.raises(ValueError, match="data must be"):
        tea.exact_affine_batch_3d_general(data, eye, z, e, (4, 4, 4))
    with pytest.raises(ValueError, match="mats must be"):
        tea.exact_affine_batch_2d(data, np.eye(3)[None], z, e, (4, 4))
    with pytest.raises(ValueError, match="offs must be"):
        tea.exact_affine_batch_2d(data, eye, z[:1], e, (4, 4))
    with pytest.raises(ValueError, match="go together"):
        tea.exact_affine_batch_2d(data, eye, z, e, (4, 4), tile_idx=[0, 1])
    with pytest.raises(ValueError, match="tile_idx must lie"):
        tea.exact_affine_batch_2d(data, eye, z, e, (4, 4), tile_idx=[0, 2], starts=z)
    # a tensor of indices is not read back on the host: the item gives cval
    out = tea.exact_affine_batch_2d(
        data, eye, z, e, (4, 4), tile_idx=torch.tensor([0, 2]), starts=z
    )
    assert not torch.isnan(out[0]).any() and torch.isnan(out[1]).all()
    with pytest.raises(TypeError, match="torch.Tensor"):
        tea.exact_affine_batch_2d(data.numpy(), eye, z, e, (4, 4))
    for fn in _WRAPPERS.values():
        assert fn.launches == 0  # CPU tensors never count as launches


def test_is_y_decoupled_matches_jax():
    th = 0.3
    coupled = np.eye(3)
    coupled[1:3, 1:3] = _rot2(th)
    ok = np.array([[0.9, 0, -0.1], [0, 1, 0], [0.1, 0, 0.9]])
    almost = ok.copy()
    almost[0, 1] = 5e-10
    for mats in (coupled[None], ok[None], np.stack([ok, coupled]), almost[None],
                 _roty(0.7, 1.1)[None], _general(0)[None], _general(1)[None]):
        assert tea.is_y_decoupled(mats) == ea.is_y_decoupled(mats)
    assert tea.is_y_decoupled(almost[None], atol=1e-12) == ea.is_y_decoupled(almost[None], atol=1e-12)
    assert tea.is_y_decoupled(ok[None]) and not tea.is_y_decoupled(coupled[None])


def test_hat_matches_jax():
    x = np.linspace(-2.5, 2.5, 41).astype(np.float32)
    np.testing.assert_array_equal(tea.hat(torch.from_numpy(x)).numpy(), np.asarray(ea.hat(x)))


# ---------------------------------------------------------------------------
# transform_sim
# ---------------------------------------------------------------------------


def _transform_case(name):
    rng = np.random.default_rng(["2d", "sepy", "general", "2d_uint16"].index(name))
    if name.startswith("2d"):
        data = rng.random((40, 50)) * 100
        m = np.eye(3)
        m[:2, :2] = _rot2(0.05, 1.02)
        m[:2, 2] = (1.3, -2.1)
        dims = ("y", "x")
        osp = {"origin": {"y": -2.0, "x": 1.5}, "spacing": {"y": 1.0, "x": 0.8},
               "shape": {"y": 44, "x": 60}}
    else:
        data = rng.random((16, 24, 28)) * 100
        m = np.eye(4)
        m[:3, :3] = _roty(0.07, 1.05) if name == "sepy" else _general(0)
        m[:3, 3] = (0.7, -1.2, 2.4)
        dims = ("z", "y", "x")
        osp = {"origin": {"z": -1.0, "y": 0.5, "x": 0.0},
               "spacing": {"z": 1.0, "y": 1.0, "x": 1.25},
               "shape": {"z": 18, "y": 22, "x": 26}}
    data = data.astype(np.uint16 if name.endswith("uint16") else np.float32)
    return data, dims, m, osp


@pytest.mark.parametrize("name", ["2d", "sepy", "general", "2d_uint16"])
def test_transform_sim_matches_jax(name, monkeypatch):
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    data, dims, m, osp = _transform_case(name)
    spacing = {d: 1.0 for d in dims}
    origin = {d: 0.5 for d in dims}
    ref = transformation.transform_sim(
        si_utils.get_sim_from_array(data, dims=dims, scale=spacing, translation=origin),
        np.linalg.inv(m), output_stack_properties=osp, order=1,
    )
    got = ttransformation.transform_sim(
        tsi.get_sim_from_array(data, dims=dims, scale=spacing, translation=origin),
        np.linalg.inv(m), output_stack_properties=osp, order=1, device="cpu",
    )
    assert isinstance(got.data, np.ndarray) and got.data.dtype == np.float32
    assert got.dims == ref.dims and got.spacing == ref.spacing and got.origin == ref.origin
    _assert_same(got.data, np.asarray(ref.data, dtype=np.float32))


def test_transform_sim_noop_returns_the_data():
    data, dims, _, _ = _transform_case("2d")
    sim = tsi.get_sim_from_array(data, dims=dims)
    osp = tsi.get_stack_properties_from_sim(sim)
    out = ttransformation.transform_sim(
        sim, output_stack_properties=osp, keep_transform_keys=True, device="cpu"
    )
    assert out.data is sim.data
    assert set(out.transforms) == set(sim.transforms)


def test_transform_sim_refuses_what_needs_the_gather_tier():
    """What the exact kernels do not take (order 0, float64, NaN data) now
    takes the port's gather resample and gives the reference's output
    (tests/test_torch_general_fusion.py holds more cases); orders above 1
    are refused, as the reference's gather refuses them."""
    data, dims, m, osp = _transform_case("2d")

    def run(arr, **kw):
        return ttransformation.transform_sim(
            tsi.get_sim_from_array(arr, dims=dims), np.linalg.inv(m),
            output_stack_properties=osp, device="cpu", **kw,
        )

    with pytest.raises(NotImplementedError, match="order"):
        run(data, order=3)
    holed = data.copy()
    holed[10:14, 10:18] = np.nan
    for arr, kw in ((data, {"order": 0}), (data.astype(np.float64), {}), (holed, {})):
        got = run(arr, **kw).data
        ref = np.asarray(transformation.transform_sim(
            si_utils.get_sim_from_array(arr, dims=dims), np.linalg.inv(m),
            output_stack_properties=osp, **kw,
        ).data)
        assert got.dtype == ref.dtype == arr.dtype
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], rtol=1e-4, atol=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttransformation.transform_sim(
                tsi.get_sim_from_array(data, dims=dims), np.linalg.inv(m),
                output_stack_properties=osp,
            )


def test_transform_pts_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(7, 3)) * 10
    aff = np.eye(4)
    aff[:3, :3] = _general(1)
    aff[:3, 3] = (1.0, -2.0, 3.0)
    np.testing.assert_array_equal(
        ttransformation.transform_pts(pts, aff), transformation.transform_pts(pts, aff)
    )
