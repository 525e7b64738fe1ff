"""Multiscale images: the test that recognises one, and the pyramid plan and
block-mean downsampling that OME-Zarr output writes its levels with.

This package has no multiscale image type yet (ROADMAP.md, queue 1: msims).
An msim is any non-:class:`~.si_utils.Sim` object with the multiscale
interface of ``multiview_stitcher_tpu.msi_utils.Msim`` (a ``sims`` list of
scales and ``get_scale``), so that ``fuse`` can refuse one with a clear error.
:func:`calc_resolution_levels` and :func:`_coarsen_mean` are copies of the
reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from multiview_stitcher_torch.si_utils import Sim


def is_msim(image) -> bool:
    return (
        not isinstance(image, Sim)
        and hasattr(image, "sims")
        and hasattr(image, "get_scale")
    )


def _coarsen_mean(data: np.ndarray, factors: Sequence[int]) -> np.ndarray:
    """Block-mean downsample with boundary='trim', cast back to the input
    dtype (truncating for integers)."""
    data = np.asarray(data)
    trimmed = tuple(slice(0, (s // f) * f) for s, f in zip(data.shape, factors))
    data = data[trimmed]
    new_shape = []
    mean_axes = []
    for i, (s, f) in enumerate(zip(data.shape, factors)):
        new_shape.extend([s // f, f])
        mean_axes.append(2 * i + 1)
    out = data.reshape(new_shape).mean(axis=tuple(mean_axes))
    return out.astype(data.dtype)


def calc_resolution_levels(
    spatial_shape: Dict[str, int],
    downscale_factors_per_spatial_dim: Optional[Dict[str, int]] = None,
    min_shape: int = 100,
):
    """Pyramid plan: 2x per dim until a dim would fall below ``min_shape``.

    Returns (shapes, relative factors, absolute factors), including level 0.
    """
    sdims = list(spatial_shape.keys())
    if downscale_factors_per_spatial_dim is None:
        downscale_factors_per_spatial_dim = {d: 2 for d in sdims}

    res_shapes = [dict(spatial_shape)]
    res_rel_factors = [{d: 1 for d in sdims}]
    res_abs_factors = [{d: 1 for d in sdims}]
    while True:
        new_rel = {
            d: downscale_factors_per_spatial_dim[d]
            if res_shapes[-1][d] // downscale_factors_per_spatial_dim[d] > min_shape
            else 1
            for d in sdims
        }
        if not any(new_rel[d] > 1 for d in sdims):
            break
        res_shapes.append({d: res_shapes[-1][d] // new_rel[d] for d in sdims})
        res_rel_factors.append(new_rel)
        res_abs_factors.append({d: res_abs_factors[-1][d] * new_rel[d] for d in sdims})
    return res_shapes, res_rel_factors, res_abs_factors
