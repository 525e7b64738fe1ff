"""Blending weights of the weighted-average fusion.

Copy of the linear-blending host helpers of ``multiview_stitcher_tpu.weights``.
A view's blending weight is the cosine-tapered, resampled EDT of a 5^ndim
proxy mask whose border ring is 0. For that mask the anisotropic EDT has the
closed form ``min_d(min(i_d, 4-i_d) * s_d)``, so the grid is built on the
host; the fusion kernels resample it by hat expansion.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from multiview_stitcher_torch import param_utils
from multiview_stitcher_torch.ops import resample as resample_ops

BoundingBox = Dict[str, Dict[str, Union[float, int]]]

DEFAULT_BLENDING_WIDTHS = {"z": 3.0, "y": 10.0, "x": 10.0}


def normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """Normalize per-view weights to sum 1 where any view contributes."""
    wsum = torch.nansum(weights, dim=0)
    return weights / torch.where(wsum == 0, torch.ones_like(wsum), wsum)


def _shrink_source_bb(source_bb: BoundingBox, shrink_distance) -> BoundingBox:
    """Shrink a bbox inward by a physical distance per side."""
    sdims = list(source_bb["origin"].keys())
    if isinstance(shrink_distance, (int, float)):
        shrink_distance = {d: float(shrink_distance) for d in sdims}
    return {
        "origin": {
            d: source_bb["origin"][d] + shrink_distance.get(d, 0) for d in sdims
        },
        "spacing": dict(source_bb["spacing"]),
        "shape": {
            d: source_bb["shape"][d]
            - 2 * shrink_distance.get(d, 0) / source_bb["spacing"][d]
            for d in sdims
        },
    }


def get_blending_support_grid(
    source_bb: BoundingBox,
    blending_widths: Optional[Dict[str, float]] = None,
    shrink_distance=0,
):
    """Host-side 5^ndim EDT proxy grid + its stack properties.

    Returns (grid ndarray of shape (5,)*ndim, grid_stack_properties) where the
    grid values equal ``distance_transform_edt(mask, sampling=s)`` for the
    border-ring mask, computed in closed form.
    """
    if blending_widths is None:
        blending_widths = dict(DEFAULT_BLENDING_WIDTHS)
    sdims = sorted(source_bb["origin"].keys())[::-1]
    if shrink_distance:
        source_bb = _shrink_source_bb(source_bb, shrink_distance)
    ndim = len(sdims)

    # singleton dims can't taper: give them a flat unit-weight profile
    def _support(d):
        n = source_bb["shape"][d]
        if n <= 1:
            return source_bb["spacing"][d]
        return (n - 1) / 4 * source_bb["spacing"][d]

    support_spacing = {d: _support(d) for d in sdims}
    # slight enlargement so the taper transitions smoothly at shared borders
    edt_support_spacing = {
        d: (
            support_spacing[d]
            * (source_bb["shape"][d] - 1 + 2)
            / (source_bb["shape"][d] - 1)
            if source_bb["shape"][d] > 1
            else support_spacing[d]
        )
        for d in sdims
    }
    edt_support_origin = {
        d: source_bb["origin"][d] - source_bb["spacing"][d] for d in sdims
    }

    sampling = np.array(
        [
            # singleton dims contribute no border taper: their axis
            # distance is made large so the min-reduce ignores them
            1e6
            if source_bb["shape"][d] <= 1
            else edt_support_spacing[d] / blending_widths[d]
            for d in sdims
        ]
    )
    axis_dist = [
        np.minimum(np.arange(5), 4 - np.arange(5)).astype(float) * sampling[i]
        for i in range(ndim)
    ]
    grid = np.minimum.reduce(np.meshgrid(*axis_dist, indexing="ij"))

    grid_props = {
        "origin": edt_support_origin,
        "spacing": edt_support_spacing,
        "shape": {d: 5 for d in sdims},
    }
    return grid.astype(np.float32), grid_props


def cosine_weights(x: torch.Tensor) -> torch.Tensor:
    """Cosine taper of distance values < 1, clipped to [0, 1]."""
    shaped = (torch.cos((1 - x) * np.pi) + 1) / 2
    return torch.clamp(torch.where(x < 1, shaped, x), 0, 1)


def blending_weights_pixel_params(
    target_bb: BoundingBox,
    source_bb: BoundingBox,
    affine,
    blending_widths: Optional[Dict[str, float]] = None,
    shrink_distance=0,
):
    """Host-side precomputation for the fusion kernels.

    Returns (grid, matrix, offset): the 5^ndim proxy grid and the pixel-space
    affine mapping target pixels -> grid pixels, so that the kernels can
    resample and cosine-shape the weight on the device.
    """
    sdims = sorted(source_bb["origin"].keys())[::-1]
    grid, grid_props = get_blending_support_grid(
        source_bb, blending_widths=blending_widths, shrink_distance=shrink_distance
    )
    affine_mat = np.asarray(param_utils.to_xaffine(affine).squeeze())
    if affine_mat.ndim == 3:
        affine_mat = affine_mat[0]
    matrix, offset = resample_ops.physical_to_pixel_params(
        np.linalg.inv(affine_mat),
        input_spacing=np.array([grid_props["spacing"][d] for d in sdims]),
        input_origin=np.array([grid_props["origin"][d] for d in sdims]),
        output_spacing=np.array([target_bb["spacing"][d] for d in sdims]),
        output_origin=np.array([target_bb["origin"][d] for d in sdims]),
    )
    return grid, matrix, offset
