"""Synthetic sample data with known ground truth.

The port's copy of ``multiview_stitcher_tpu.sample_data``: tile grids cut
from one zoomed random volume with known per-tile shifts and per-timepoint
drift, the registration oracle of the tests. The same arguments give the
JAX package's arrays and transforms bit for bit (the same numpy draws from
the global generator, seeded with 0, and the same scipy resampling).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
from scipy import ndimage

from multiview_stitcher_torch import si_utils

METADATA_TRANSFORM_KEY = si_utils.DEFAULT_TRANSFORM_KEY


def generate_tiled_dataset(
    ndim: int = 2,
    N_c: int = 2,
    N_t: int = 20,
    tile_size: int = 30,
    tiles_x: int = 2,
    tiles_y: int = 2,
    tiles_z: int = 1,
    overlap: int = 5,
    zoom: float = 6,
    random_data: bool = False,
    dtype=np.uint16,
    spacing_x: float = 0.5,
    spacing_y: float = 0.5,
    spacing_z: float = 2.0,
    shift_scale: float = 2.0,
    drift_scale: float = 2.0,
    transform_key: str = METADATA_TRANSFORM_KEY,
):
    """A list of tile sims with dims (c, t, [z,] y, x) cut from one
    ground-truth volume.

    Tiles at grid positions overlap nominally by ``overlap`` pixels; each
    tile's content is further displaced by a random per-tile shift (scale
    ``shift_scale``) and a cumulative per-timepoint drift (scale
    ``drift_scale``), the quantities registration must recover.
    """
    spatial_dims = ["z", "y", "x"][-ndim:]
    spacing = [spacing_z, spacing_y, spacing_x][-ndim:]
    tile_grid = [tiles_z, tiles_y, tiles_x][-ndim:]
    tile_shape = (tile_size,) * ndim

    np.random.seed(0)
    nblocks = (N_t,) + tuple(tile_grid)
    shifts = (np.random.random(nblocks + (ndim,)) - 0.5) * shift_scale
    drifts = np.cumsum(np.ones(nblocks + (ndim,)) * drift_scale, axis=0)

    # per-channel ground truth volumes (zoomed up when sampling)
    gt_shape = [max(2, int(2 * f * tile_size // zoom)) for f in tile_grid]
    im_gts = [np.random.randint(0, 100, gt_shape).astype(np.float64) for _ in range(N_c)]

    eff_shape = np.array(tile_shape) - overlap

    sims = []
    for tile_index in np.ndindex(tuple(tile_grid)):
        tile_index_arr = np.array(tile_index)
        data = np.empty((N_c, N_t) + tile_shape, dtype=dtype)
        for c in range(N_c):
            for t in range(N_t):
                if random_data:
                    data[c, t] = np.random.randint(0, 200, tile_shape).astype(dtype)
                    continue
                block_loc = (t,) + tile_index
                offset = (tile_index_arr * eff_shape + drifts[block_loc] + shifts[block_loc]) / zoom
                data[c, t] = ndimage.affine_transform(
                    im_gts[c],
                    matrix=np.eye(ndim) / zoom,
                    offset=offset,
                    output_shape=tile_shape,
                    mode="reflect",
                    order=1,
                ).astype(dtype)

        origin = (
            tile_index_arr * tile_size * np.array(spacing)
            - overlap * tile_index_arr * np.array(spacing)
        )
        sims.append(si_utils.get_sim_from_array(
            data,
            dims=["c", "t"] + spatial_dims,
            scale={d: spacing[i] for i, d in enumerate(spatial_dims)},
            translation={d: origin[i] for i, d in enumerate(spatial_dims)},
            c_coords=["channel " + str(c) for c in range(N_c)],
            t_coords=np.arange(N_t),
            transform_key=transform_key,
        ))
    return sims


def get_mosaic_sample_data_path():
    """Path of the 2-tile mosaic CZI that the upstream multiview-stitcher
    package ships (``test-datasets/mosaic_test.czi`` inside it). Raises
    ``FileNotFoundError`` where that package, or the file, is absent."""
    spec = importlib.util.find_spec("multiview_stitcher")
    if spec is not None and spec.origin is not None:
        path = Path(spec.origin).parent / "test-datasets" / "mosaic_test.czi"
        if path.exists():
            return path
    raise FileNotFoundError("mosaic_test.czi sample not available in this environment.")
