"""The port's shear tier (``ops/shear.py`` and ``MVS_TPU_SHEAR=1`` in
``fuse``) against the JAX package.

The planning is the reference's numpy in float64 and must give the same
plans and coefficient tables; the passes are torch in float32 where the
reference contracts dense lerp matrices, so resampled values agree within
1e-4 on data of magnitude 1-6. ``fuse()`` with ``MVS_TPU_SHEAR=1`` on both
sides (monkeypatched env) agrees within 1 count on uint16 views (the f32
blend lands on either side of a truncation tie). The port's two sources of
the shear tier, the tile stack on the device and host slabs (lazy views past
``TILES_MAX_BYTES``, monkeypatched to 0), give the same output bit for bit,
as the reference's test_shear_devtiles_mixed_shapes_match_host_slabs asks of
its own two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.ops import shear as tshear
from multiview_stitcher_tpu import si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.ops import shear as jshear

KEY = "affine"


def _smooth(shape):
    g = np.meshgrid(*[np.linspace(0, 3 * np.pi, s) for s in shape], indexing="ij")
    return (sum(np.sin(gg + k) for k, gg in enumerate(g)) + 3.0).astype(np.float32)


def _rot2(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])


def _rot3(th, axes):
    m = np.eye(3)
    i, j = axes
    m[i, i], m[i, j], m[j, i], m[j, j] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    return m


_MAPS = {
    "axis_aligned_2d": (np.diag([0.7, 1.3]), [2.3, -1.7], (40, 44), (36, 38)),
    "rot_2d": (_rot2(0.3), [3.0, -2.0], (64, 64), (48, 48)),
    "rot_69deg_2d": (_rot2(1.2), [0.0, 0.0], (64, 64), (48, 48)),
    "axis_aligned_3d": (np.diag([0.8, 1.1, 0.95]), [1.2, -2.0, 0.7], (32, 36, 40), (30, 30, 34)),
    "rot_x_3d": (_rot3(0.2, (1, 2)) @ np.diag([0.9, 1.1, 1.0]), [1.0, 2.0, -1.0], (40, 40, 40),
                 (36, 36, 36)),
    "rot_y_3d": (_rot3(0.7, (0, 2)), [4.0, 1.0, -3.0], (30, 24, 36), (28, 24, 30)),
    "coupled_3d": (np.eye(3) + np.array([[0.02, -0.03, 0.01], [0.015, 0.01, -0.02],
                                         [-0.01, 0.025, 0.03]]), [0.5, -1.5, 2.0],
                   (24, 28, 32), (22, 26, 30)),
}


@pytest.mark.parametrize("name", list(_MAPS))
def test_plan_shear_equals_the_reference(name):
    M, o, in_shape, out_shape = _MAPS[name]
    M = np.asarray(M, float)
    mats = np.stack([M, M @ np.diag(np.linspace(0.95, 1.05, len(o)))])
    offs = np.stack([np.asarray(o, float), np.asarray(o, float) + 0.5])
    ref = jshear.plan_shear(mats, offs, in_shape, out_shape)
    got = tshear.plan_shear(mats, offs, in_shape, out_shape)
    assert (ref is None) == (got is None) and got is not None
    (jp, jc, jco), (tp, tc, tco) = ref, got
    assert (tp.perm, tp.passes, tp.out_shape, tp.n_passes) == (
        jp.perm, jp.passes, jp.out_shape, jp.n_passes)
    for f in ("perm", "structure", "designated", "out_era", "e_era", "in_era", "ndim"):
        assert getattr(tc, f) == getattr(jc, f), f
    np.testing.assert_array_equal(tco, jco)
    # padded batches (identity maps) re-derive the same tables; under a plan
    # that permutes the axes the identity does not factor, and both raise
    padded_m = np.concatenate([mats, np.eye(len(o))[None]])
    padded_o = np.concatenate([offs, np.zeros((1, len(o)))])
    if tp.perm == tuple(range(len(o))):
        np.testing.assert_array_equal(tc.coeffs(padded_m, padded_o),
                                      jc.coeffs(padded_m, padded_o))
    else:
        for ctx in (tc, jc):
            with pytest.raises(ValueError, match="factor"):
                ctx.coeffs(padded_m, padded_o)
    L, U, ok = tshear._lu_nopivot_batch(mats)
    jL, jU, jok = jshear._lu_nopivot_batch(mats)
    np.testing.assert_array_equal(L, jL)
    np.testing.assert_array_equal(U, jU)
    np.testing.assert_array_equal(ok, jok)


def test_unfactorable_maps_are_refused_as_in_the_reference():
    singular = np.array([[1.0, 0.0], [1.0, 0.0]])
    assert tshear.plan_shear(singular[None], np.zeros((1, 2)), (32, 32), (32, 32)) is None
    assert jshear.plan_shear(singular[None], np.zeros((1, 2)), (32, 32), (32, 32)) is None
    steep = np.array([[1.0, 4.0], [0.0, 1.0]])  # shear beyond max_shear in every order
    for mod in (tshear, jshear):
        assert mod.plan_shear(steep[None], np.zeros((1, 2)), (32, 32), (32, 32)) is None


@pytest.mark.parametrize("name", list(_MAPS))
def test_shear_resample_matches_the_reference(name):
    M, o, in_shape, out_shape = _MAPS[name]
    M, o = np.asarray(M, float), np.asarray(o, float)
    plan, _, coeffs = jshear.plan_shear(M[None], o[None], in_shape, out_shape)
    data = _smooth(in_shape)
    ref = np.asarray(jshear.shear_resample(
        jnp.asarray(data), jnp.asarray(coeffs[0]), jnp.asarray(M, dtype=jnp.float32),
        jnp.asarray(o, dtype=jnp.float32), jnp.asarray(in_shape, dtype=jnp.float32), plan,
    ))
    tplan = tshear.plan_shear(M[None], o[None], in_shape, out_shape)[0]
    got = tshear.shear_resample(
        torch.from_numpy(data), coeffs[0], M.astype(np.float32), o.astype(np.float32),
        np.asarray(in_shape, np.float32), tplan,
    ).numpy()
    assert (np.isnan(got) == np.isnan(ref)).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, equal_nan=True)
    # the batch of three (one item with its own map) against item by item
    batch = tshear.shear_resample_batch(
        torch.from_numpy(np.stack([data] * 2)), np.stack([coeffs[0]] * 2),
        np.stack([M] * 2).astype(np.float32), np.stack([o] * 2).astype(np.float32),
        np.tile(np.asarray(in_shape, np.float32), (2, 1)), tplan, 0.0,
    ).numpy()
    np.testing.assert_array_equal(batch[1], np.where(np.isnan(got), 0.0, got))


def test_refine_grid_and_valid_mask_match_the_reference():
    rng = np.random.default_rng(0)
    for shape in ((5, 5), (5, 5, 5)):
        g = rng.random(shape, dtype=np.float32)
        ref = np.asarray(jshear.refine_grid(jnp.asarray(g), 4))
        np.testing.assert_allclose(tshear.refine_grid(torch.from_numpy(g), 4).numpy(), ref,
                                   atol=1e-6)
        # a batch of grids, refined along their last ndim axes
        both = tshear.refine_grid(torch.from_numpy(np.stack([g, g])), 4, ndim=g.ndim).numpy()
        np.testing.assert_array_equal(both[0], both[1])
    M = (_rot3(0.4, (0, 2)) * 1.1).astype(np.float32)
    o = np.array([-3.0, 1.5, 7.25], np.float32)
    ext = np.array([20.0, 18.0, 25.0], np.float32)
    ref = np.asarray(jshear.affine_valid_mask(jnp.asarray(M), jnp.asarray(o), jnp.asarray(ext),
                                              (22, 19, 24)))
    got = tshear.affine_valid_mask(M, o, ext, (22, 19, 24)).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# fuse() with MVS_TPU_SHEAR=1
# ---------------------------------------------------------------------------


def _rotated_sims(ndim):
    """The reference's test_shear layouts, as uint16 views."""
    if ndim == 2:
        img = (_smooth((80, 80)) * 100).astype(np.uint16)
        R = np.eye(3)
        R[:2, :2] = _rot2(0.06)
        ms = [np.eye(3), R]
        arrays, trs = [img, img.copy()], [{"y": 0.0, "x": 0.0}, {"y": 0.0, "x": 60.0}]
    else:
        vol = (_smooth((40, 48, 48)) * 100).astype(np.uint16)
        R = np.eye(4)
        R[1:3, 1:3] = _rot2(0.05)
        ms = [np.eye(4), R]
        arrays = [vol, vol.copy()]
        trs = [{"z": 0.0, "y": 0.0, "x": 0.0}, {"z": 0.0, "y": 0.0, "x": 36.0}]
    sims = []
    for a, tr, m in zip(arrays, trs, ms):
        sim = si_utils.get_sim_from_array(a, translation=tr)
        si_utils.set_sim_affine(sim, m, transform_key=KEY)
        sims.append(sim)
    return sims


def _mixed_shape_sims():
    """The reference's _mixed_shape_sims: two overlapping views of different
    shapes, one rotated."""
    rng = np.random.default_rng(1)
    R = np.eye(3)
    R[:2, :2] = _rot2(0.05)
    sims = []
    for i, (shp, org) in enumerate([((40, 80), (0.0, 0.0)), ((60, 60), (20.0, 30.0))]):
        sim = si_utils.get_sim_from_array(
            rng.integers(100, 1100, size=shp).astype(np.uint16), dims=("y", "x"),
            translation={"y": org[0], "x": org[1]},
        )
        si_utils.set_sim_affine(sim, R if i % 2 else np.eye(3), transform_key=KEY)
        sims.append(sim)
    return sims


def _to_port(sims):
    return [
        convert.sim_from_numpy(s.data, s.dims, s.spacing, s.origin,
                               {k: v.data for k, v in s.transforms.items()}, coords=s.coords)
        for s in sims
    ]


def _lazy(tmp_path, sims):
    out = []
    for i, s in enumerate(sims):
        url = str(tmp_path / f"view_{i}.zarr")
        tzb.create_zarr_array(url, s.data.shape, (16,) * s.data.ndim, s.data.dtype)[...] = s.data
        sim = tsi.get_sim_from_array(tzb.open_zarr_array(url), dims=s.dims,
                                     translation=dict(s.origin))
        tsi.set_sim_affine(sim, s.transforms[KEY].data, transform_key=KEY)
        out.append(sim)
    return out


@pytest.fixture
def shear_on(monkeypatch):
    monkeypatch.setenv("MVS_TPU_SHEAR", "1")
    monkeypatch.delenv("MVS_TPU_EXACT_AFFINE", raising=False)
    jcore.clear_device_tile_cache()
    tcore.clear_device_tile_cache()
    calls = []
    orig = tcore._fuse_chunk_batch_kernel_shear

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return orig(*a, **k)

    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_shear", spy)
    yield calls
    jcore.clear_device_tile_cache()


def _within_one(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("ndim,cs", [(2, 48), (3, 32)])
def test_fuse_with_the_shear_switch_matches_the_reference(ndim, cs, shear_on):
    sims = _rotated_sims(ndim)
    ref = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=cs).data)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=cs, device="cpu").data
    assert shear_on, "the shear tier did not run"
    _within_one(got, ref)


def test_shear_device_stack_and_host_slabs_are_bit_equal(tmp_path, monkeypatch, shear_on):
    """The reference's mixed-shape case: the tile stack (edge-padded to the
    common shape) and host slabs (lazy views past the limit, edge-padded
    windows) give one output, within 1 count of the reference's."""
    sims = _mixed_shape_sims()
    ref = np.asarray(jfuse(sims, transform_key=KEY).data)
    dev = tfuse(_to_port(sims), transform_key=KEY, device="cpu").data
    assert shear_on
    n_dev = len(shear_on)
    monkeypatch.setattr(tcore, "TILES_MAX_BYTES", 0)
    tcore.last_slab_telemetry.clear()
    slabs = tfuse(_lazy(tmp_path, _to_port(sims)), transform_key=KEY, device="cpu").data
    assert len(shear_on) > n_dev
    assert (tcore.last_slab_telemetry["tier"], tcore.last_slab_telemetry["route"]) == (
        "batched", "shear")
    np.testing.assert_array_equal(dev, slabs)
    _within_one(dev, ref)


def test_unfactorable_plans_take_the_gather_route(monkeypatch, shear_on):
    """Where ``plan_shear`` returns None the gather route takes the plan, in
    both packages."""
    monkeypatch.setattr(tshear, "plan_shear", lambda *a, **k: None)
    monkeypatch.setattr(jshear, "plan_shear", lambda *a, **k: None)
    gathered = []
    orig = tcore._fuse_chunk_batch_kernel_gather
    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_gather",
                        lambda *a, **k: gathered.append(1) or orig(*a, **k))
    sims = _rotated_sims(2)
    ref = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=48).data)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=48, device="cpu").data
    assert gathered and not shear_on
    _within_one(got, ref)


def test_the_switch_widens_the_source_windows(monkeypatch):
    """``MVS_TPU_SHEAR=1`` widens every source window by 2 * ndim + 1
    pixels, in the port's plan as in the reference's."""
    for value, margin in (("1", 5), ("0", 0), ("auto", 0)):
        monkeypatch.setenv("MVS_TPU_SHEAR", value)
        assert tcore._shear_source_margin(2) == margin
        assert tcore._shear_source_margin(3) == (7 if margin else 0)
        assert jcore._shear_source_margin(2) == margin


def test_permuted_plans_fuse_where_the_reference_raises(monkeypatch, shear_on):
    """Views rotated by 60-75 degrees factor only with the axes permuted;
    chunks that fewer views reach pad their slots with identity maps, which
    do not factor under that plan. The reference's ``ShearCtx.coeffs``
    raises there (a fault of the reference, ROADMAP.md queue 3); the port
    derives the padding slots' coefficients from a real slot, masks them,
    and its output stays within the reference's shear tolerance of the exact
    kernels' (tests/test_shear.py: 99th percentile under 3 counts, mean
    under 0.5, under 0.2 % of pixels off by more than 5 % of the maximum)."""
    img = (_smooth((80, 80)) * 100).astype(np.uint16)
    sims = []
    for i, th in enumerate((1.1, 1.2, 1.3)):
        R = np.eye(3)
        R[:2, :2] = _rot2(th)
        sim = si_utils.get_sim_from_array(img.copy(), translation={"y": 0.0, "x": 50.0 * i})
        si_utils.set_sim_affine(sim, R, transform_key=KEY)
        sims.append(sim)
    with pytest.raises(ValueError, match="does not factor"):
        jfuse(sims, transform_key=KEY, output_chunksize=32)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=32, device="cpu").data
    assert shear_on
    monkeypatch.delenv("MVS_TPU_SHEAR")
    exact = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=32, device="cpu").data
    d = np.abs(got.astype(float) - exact.astype(float))
    assert np.percentile(d, 99) < 3.0 and d.mean() < 0.5
    assert (d > 0.05 * exact.max()).mean() < 0.002
