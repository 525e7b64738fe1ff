"""Boolean views through the port's ``fuse`` against the JAX package.

The cast at the end of every tier is jnp's ``astype`` after ``nan_to_num``;
for a boolean output that is "the blended value is not zero". The port's
``ops.translation_fusion._cast`` is held to jnp's cast on edge values, and
``fuse()`` of two boolean 48 x 48 tiles at x = 0 and x = 40 is held to the
JAX package's in each tier on the CPU: translation (the default weighted
average of translation-placed views), tiles (``max_fusion``) and affine
(both views turned 0.1 rad about the image centre). The JAX side runs with
its CPU defaults for the first two and with ``MVS_TPU_EXACT_AFFINE=1`` /
``MVS_TPU_SHEAR=0`` for the third (its exact tier in interpret mode, as
``tests/test_torch_fuse_affine.py`` runs it); the port with
``device="cpu"``. Tolerance: the boolean images are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.ops import translation_fusion as ttf
from multiview_stitcher_tpu import si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse

KEY = si_utils.DEFAULT_TRANSFORM_KEY


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _bool_tiles(rotate=0.0):
    """Two 48 x 48 tiles at x = 0 and x = 40: the first two tiles of the
    uint16 test grid of ``tests/test_torch_fuse.py`` (values in [0, 900)
    from ``default_rng(0)``), thresholded at 450; with ``rotate``, each turned
    by that angle about the centre of the pair."""
    rng = np.random.default_rng(0)
    sims = []
    for x in (0.0, 40.0):
        data = (rng.random((48, 48)) * 900).astype(np.uint16) > 450
        sim = si_utils.get_sim_from_array(data, dims=("y", "x"), translation={"y": 0.0, "x": x})
        if rotate:
            c, s = np.cos(rotate), np.sin(rotate)
            centre = np.array([23.5, 43.5])
            aff = np.eye(3)
            aff[:2, :2] = [[c, -s], [s, c]]
            aff[:2, 2] = centre - aff[:2, :2] @ centre
            si_utils.set_sim_affine(sim, aff, transform_key=KEY)
        sims.append(sim)
    return sims


def test_cast_to_bool_matches_jnp_astype():
    vals = np.array(
        [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30, -1e-30, 0.4, -0.6, 1.0, 255.5, 3e38],
        dtype=np.float32,
    )
    ref = np.asarray(jnp.nan_to_num(jnp.asarray(vals)).astype(bool))
    got = ttf._cast(torch.from_numpy(vals), torch.bool)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_translation_kernels_write_bool():
    """Both plain translation versions (what the wrappers take on the CPU)
    return the cast of their float32 blend."""
    rng = np.random.default_rng(3)
    for ndim in (2, 3):
        shape = (6, 20, 24)[-ndim:]
        tiles = torch.from_numpy(rng.random((2,) + shape).astype(np.float32) > 0.5)
        view_idx = np.zeros((1,) * ndim + (2,), np.int32)
        view_idx[..., 1] = 1
        offs = np.zeros((2, ndim), np.float32)
        offs[1, -1] = 7.0
        extents = np.tile(np.array(shape, np.float32), (2, 1))
        wdiags = np.ones((2, ndim), np.float32)
        woffs = np.zeros((2, ndim), np.float32)
        wgrids = np.ones((2,) + (5,) * ndim, np.float32)
        out_shape = shape[:-1] + (shape[-1] + 7,)
        fn = ttf.fuse_translation_3d if ndim == 3 else ttf.fuse_translation_2d
        kw = dict(out_shape=out_shape, tile_shape=out_shape, K=2, scale=(1.0,) * ndim)
        as_bool = fn(tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                     out_dtype=torch.bool, **kw)
        as_f32 = fn(tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
                    out_dtype=torch.float32, **kw)
        assert as_bool.dtype == torch.bool
        torch.testing.assert_close(as_bool, as_f32 != 0)


@pytest.mark.parametrize("tier", ["translation", "tiles", "affine"])
def test_fuse_bool_views_matches_jax(tier, monkeypatch):
    if tier == "affine":
        monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
        monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    else:
        monkeypatch.delenv("MVS_TPU_EXACT_AFFINE", raising=False)
        monkeypatch.delenv("MVS_TPU_SHEAR", raising=False)
    jcore.clear_device_tile_cache()
    tcore.clear_device_tile_cache()
    sims = _bool_tiles(rotate=0.1 if tier == "affine" else 0.0)
    kw = {"fusion_func": jcore.max_fusion} if tier == "tiles" else {}
    tkw = {"fusion_func": tcore.max_fusion} if tier == "tiles" else {}
    ref = np.asarray(jfuse(sims, transform_key=KEY, **kw).to_numpy())
    got = tfuse(_to_port(sims), transform_key=KEY, device="cpu", **tkw).data
    assert ref.dtype == got.dtype == np.bool_
    assert got.shape == ref.shape
    if tier == "translation":
        # the case recorded with the fault
        assert ref.shape == (48, 88) and int(ref.sum()) == 2208
    np.testing.assert_array_equal(got, ref)
