"""The port's translation-fusion kernels against the Pallas kernels.

The same tables, made from a seed with numpy, go through
``multiview_stitcher_tpu.ops.pallas_fusion.fuse_translation_{2d,3d}`` (Pallas
in interpret mode, as tests/test_pallas_fusion.py runs it on the CPU) and
through the port's wrappers on CPU tensors, which take the plain PyTorch
versions. The CUDA kernels themselves are compared with the plain versions
on the card by ``chip_smoke.py``.

Tolerances: f32 outputs rtol 1e-4, atol 1e-3 (tests/test_pallas_fusion.py:98;
the two sides sum the lerps and the hat expansion in different op orders,
and the reference adds an atlas origin to fractional offsets in f32, which
moves a sample by up to one ulp of the atlas extent). Integer outputs: at
most 1 count, on truncation ties (a single-view pixel fuses to w*a/w, which
f32 can round just below the integer a).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.ops import translation_fusion as tf
from multiview_stitcher_tpu.ops import pallas_fusion


def _layout(ndim, case, rng):
    """Views of a small translation grid and their kernel tables.

    Returns (tiles f32 (V, *tile), tables dict, out_shape, scale_arr, scales)
    for the case: "unit", "scaled" (uniform non-unit scale; z = 2 in 3D) or
    "per_view" (views at different spacings; z = 1.25 for one view in 3D).
    """
    if ndim == 2:
        tile, step = (24, 40), (18, 30)
        grid = (2, 2)
        frac = np.array([0.3, 0.7])
    else:
        tile, step = (10, 16, 40), (8, 12, 32)
        grid = (2, 1, 2)
        frac = np.array([0.4, 0.3, 0.7])
    sdims = ["z", "y", "x"][-ndim:]
    sims = []
    for iv, idx in enumerate(np.ndindex(grid)):
        spacing = {d: 1.0 for d in sdims}
        if case == "per_view" and iv % 2:
            spacing = dict(zip(sdims, [0.8, 0.5, 0.5][-ndim:]))
        shape = tile if not (case == "per_view" and iv % 2) else tuple(
            int(t * 1.5) for t in tile
        )
        translation = {
            d: float(idx[i] * step[i] + (frac[i] if iv == 1 else 0.0))
            for i, d in enumerate(sdims)
        }
        sims.append(
            tsi.get_sim_from_array(
                (rng.random(shape) * 100).astype(np.float32),
                dims=sdims, scale=spacing, translation=translation,
            )
        )
    osp = tcore.process_output_stack_properties(
        sims, transform_key=tsi.DEFAULT_TRANSFORM_KEY,
        output_spacing=(
            dict(zip(sdims, [2.0, 1.5, 1.5][-ndim:])) if case == "scaled" else None
        ),
    )
    osp = {k: {d: (int(v[d]) if k == "shape" else float(v[d])) for d in sdims}
           for k, v in osp.items()}
    if case == "per_view":
        scales = tcore._views_output_scales_per_view(sims, osp, sdims)
        scale_arr = scales
    else:
        scales = None
        scale_arr = np.asarray(tcore._views_output_scale(sims, osp, sdims))
    views_bb = [tsi.get_stack_properties_from_sim(s) for s in sims]
    plan = {"sparams": [np.eye(ndim + 1)] * len(sims)}
    offs, extents, wdiags, woffs, wgrids = tcore.translation_kernel_params(
        plan, views_bb, osp, sdims, None, 0, scale_arr
    )
    shapes = [s.data.shape for s in sims]
    max_shape = tuple(max(s[i] for s in shapes) for i in range(ndim))
    tiles = np.stack([
        np.pad(s.data, [(0, m - n) for n, m in zip(s.data.shape, max_shape)], mode="edge")
        for s in sims
    ])
    tables = dict(offs=offs, extents=extents, wdiags=wdiags, woffs=woffs, wgrids=wgrids)
    out_shape = tuple(osp["shape"][d] for d in sdims)
    return tiles, tables, out_shape, scale_arr, scales


def _kernel_scale(ndim, scale_arr):
    scale = tuple(float(x) for x in np.max(np.atleast_2d(scale_arr), axis=0))
    if ndim == 3:
        scale = (int(np.ceil(scale[0])),) + scale[1:]
    return scale


def _run_both(ndim, tiles, tables, out_shape, scale_arr, scales, tile_shape,
              out_dtype=np.float32, band=None):
    view_idx = tcore.tile_view_lists(
        tables["offs"], tables["extents"], np.asarray(scale_arr, np.float64),
        out_shape, tile_shape,
    )
    origin = None
    if band is not None:
        # a band of whole tiles along the first axis, through ``origin``
        t0, nt = band
        view_idx = view_idx[t0:t0 + nt]
        origin = np.zeros(ndim, np.int32)
        origin[0] = t0 * tile_shape[0]
        out_shape = (min(nt * tile_shape[0], out_shape[0] - origin[0]),) + out_shape[1:]
    K = view_idx.shape[-1]
    scale = _kernel_scale(ndim, scale_arr)
    sc = None if scales is None else np.asarray(scales, np.float32)
    jax_fn = pallas_fusion.fuse_translation_3d if ndim == 3 else pallas_fusion.fuse_translation_2d
    ref = np.asarray(jax_fn(
        jnp.asarray(tiles), view_idx, *tables.values(),
        out_shape=out_shape, tile_shape=tile_shape, K=K, interpret=True,
        out_dtype=out_dtype, origin=origin, scale=scale, scales=sc,
    ))
    port_fn = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
    got = port_fn(
        torch.from_numpy(tiles), view_idx, *tables.values(),
        out_shape=out_shape, tile_shape=tile_shape, K=K,
        out_dtype=torch.from_numpy(np.empty(0, out_dtype)).dtype,
        origin=origin, scale=scale, scales=sc,
    )
    assert got.device.type == "cpu"
    return ref, got.numpy()


_TILES = {2: (16, 128), 3: (4, 16, 128)}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("case", ["unit", "scaled", "per_view"])
def test_plain_matches_pallas(ndim, case):
    tiles, tables, out_shape, scale_arr, scales = _layout(
        ndim, case, np.random.default_rng(10 * ndim + len(case))
    )
    ref, got = _run_both(ndim, tiles, tables, out_shape, scale_arr, scales, _TILES[ndim])
    assert got.shape == ref.shape == out_shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("ndim", [2, 3])
def test_plain_matches_pallas_banded_origin(ndim):
    """A band of whole tiles through a nonzero ``origin`` equals the
    reference's band, and the port's own full output at that band."""
    tiles, tables, out_shape, scale_arr, scales = _layout(
        ndim, "unit", np.random.default_rng(3)
    )
    tile_shape = (8, 128) if ndim == 2 else (4, 16, 128)
    ref, got = _run_both(ndim, tiles, tables, out_shape, scale_arr, scales,
                         tile_shape, band=(1, 1))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    view_idx = tcore.tile_view_lists(
        tables["offs"], tables["extents"], scale_arr, out_shape, tile_shape
    )
    port_fn = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
    full = port_fn(
        torch.from_numpy(tiles), view_idx, *tables.values(), out_shape=out_shape,
        tile_shape=tile_shape, K=view_idx.shape[-1], scale=_kernel_scale(ndim, scale_arr),
    ).numpy()
    np.testing.assert_array_equal(got, full[tile_shape[0]:2 * tile_shape[0]])


@pytest.mark.parametrize("ndim", [2, 3])
def test_plain_matches_pallas_uint16_output(ndim):
    tiles, tables, out_shape, scale_arr, scales = _layout(
        ndim, "unit", np.random.default_rng(4)
    )
    tiles = tiles * 9  # counts up to ~900
    ref, got = _run_both(ndim, tiles, tables, out_shape, scale_arr, scales,
                         _TILES[ndim], out_dtype=np.uint16)
    assert got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_plain_output_does_not_depend_on_tile_shape():
    """The port lists views at its own (smaller) tiles; a listed view that
    is not valid at a pixel adds exactly 0, so the output is the same."""
    tiles, tables, out_shape, scale_arr, scales = _layout(
        3, "unit", np.random.default_rng(5)
    )
    outs = []
    for tile_shape in (tf.TILE_SHAPE_3D, (8, 16, 64)):
        view_idx = tcore.tile_view_lists(
            tables["offs"], tables["extents"], scale_arr, out_shape, tile_shape
        )
        outs.append(tf.fuse_translation_3d(
            torch.from_numpy(tiles), view_idx, *tables.values(),
            out_shape=out_shape, tile_shape=tile_shape, K=view_idx.shape[-1],
        ).numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-3)


def test_wrappers_validate_inputs():
    tiles, tables, out_shape, scale_arr, _ = _layout(3, "unit", np.random.default_rng(6))
    view_idx = tcore.tile_view_lists(
        tables["offs"], tables["extents"], scale_arr, out_shape, tf.TILE_SHAPE_3D
    )
    with pytest.raises(ValueError, match="integer z scale"):
        tf.fuse_translation_3d(
            torch.from_numpy(tiles), view_idx, *tables.values(),
            out_shape=out_shape, K=view_idx.shape[-1], scale=(1.5, 1.0, 1.0),
        )
    with pytest.raises(ValueError, match="view_idx must be"):
        tf.fuse_translation_3d(
            torch.from_numpy(tiles), view_idx[:1], *tables.values(),
            out_shape=out_shape, K=view_idx.shape[-1],
        )
