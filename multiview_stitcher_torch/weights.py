"""Fusion weights: the blending weights of the weighted-average fusion and
the content-based fusion weights.

The port of ``multiview_stitcher_tpu.weights``. A view's blending weight is
the cosine-tapered, resampled EDT of a 5^ndim proxy mask whose border ring
is 0. For that mask the anisotropic EDT has the closed form
``min_d(min(i_d, 4-i_d) * s_d)``, so the grid is built on the host; the
fusion kernels resample it by hat expansion, the gather tiers by
``ops.resample``.

Content-based weights take the stacked resampled views of one output chunk
(a (V, *chunk) tensor on the device) and give one weight a view and voxel:
``content_based`` is Preibisch's local variance ``G_s2 * (I - G_s1 * I)^2``
(NaN-aware gaussians, ``ops.filters``), ``content_based_dct`` Royer's DCT
Shannon entropy over blocks, interpolated back to the voxels. Each declares
the halo it needs (``requires_overlap``), which ``fusion.fuse`` reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from multiview_stitcher_torch import param_utils
from multiview_stitcher_torch.ops import filters as filter_ops
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.utils.misc import requires_overlap, resolve_device

BoundingBox = Dict[str, Dict[str, Union[float, int]]]

DEFAULT_BLENDING_WIDTHS = {"z": 3.0, "y": 10.0, "x": 10.0}


def normalize_weights(weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Normalize per-view weights (views along ``dim``) to sum 1 where any
    view contributes."""
    wsum = torch.nansum(weights, dim=dim, keepdim=True)
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


def get_blending_weights(
    target_bb: BoundingBox,
    source_bb: BoundingBox,
    affine,
    blending_widths: Optional[Dict[str, float]] = None,
    shrink_distance=0,
    device=None,
) -> torch.Tensor:
    """Blending weights of one view over ``target_bb``: its proxy grid
    resampled through the inverse of ``affine`` (source intrinsic-physical
    -> target world coordinates, a resolved view param), 0 outside, then
    cosine-tapered. Runs on ``device`` (the CUDA device by default)."""
    device = resolve_device(device)
    sdims = sorted(source_bb["origin"].keys())[::-1]
    grid, matrix, offset = blending_weights_pixel_params(
        target_bb, source_bb, affine, blending_widths=blending_widths,
        shrink_distance=shrink_distance,
    )
    out_shape = tuple(int(target_bb["shape"][d]) for d in sdims)
    target_weights = resample_ops.affine_resample(
        torch.from_numpy(grid).to(device), np.asarray(matrix, np.float32),
        np.asarray(offset, np.float32), out_shape, order=1, cval=0.0,
    )
    return cosine_weights(target_weights)


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


# ---------------------------------------------------------------------------
# content-based weights
# ---------------------------------------------------------------------------


@requires_overlap(lambda kwargs: 2 * kwargs.get("sigma_2", 11))
def content_based(
    transformed_views: torch.Tensor,
    blending_weights: torch.Tensor,
    sigma_1: float = 5,
    sigma_2: float = 11,
) -> torch.Tensor:
    """Preibisch content-based weights ``W = G_s2 * (I - G_s1 * I)^2`` of
    each view, on the view masked (NaN) where its blending weight is below
    1e-7, normalised over the views."""
    tv = transformed_views.to(torch.float32)
    tv = torch.where(blending_weights < 1e-7, torch.nan, tv)
    ndim = tv.dim() - 1
    inner = filter_ops.nan_gaussian_filter(tv, sigma_1, mode="reflect", ndim=ndim)
    w = filter_ops.nan_gaussian_filter((tv - inner) ** 2, sigma_2, mode="reflect", ndim=ndim)
    return normalize_weights(w)


def _nanmin0(x: torch.Tensor) -> torch.Tensor:
    """``np.nanmin`` over axis 0: NaN only where every entry is NaN."""
    nan = torch.isnan(x)
    low = torch.where(nan, torch.inf, x).amin(dim=0)
    return torch.where(nan.all(dim=0), torch.nan, low)


@requires_overlap(lambda kwargs: kwargs.get("dct_size", 32))
def content_based_dct(
    transformed_views: torch.Tensor,
    dct_size: Union[int, Dict[str, int]] = 32,
    exponent: float = 1.0,
    otf_support_fraction: Optional[float] = 0.5,
    output_chunksize=None,
) -> torch.Tensor:
    """Royer-2016 DCT Shannon-entropy quality weights: the quality of each
    non-overlapping ``dct_size`` block (``ops.filters.dct_entropy_quality``,
    blocks no larger than ``output_chunksize`` or the chunk), less its
    minimum over the views, normalised, then interpolated back to the voxels
    (linear, clamped at the edges) and normalised again."""
    tv = transformed_views.to(torch.float32)
    spatial_shape = tuple(tv.shape[1:])
    ndim = len(spatial_shape)
    sdims = ["z", "y", "x"][-ndim:]
    if isinstance(dct_size, dict):
        dct_sizes = tuple(dct_size[d] for d in sdims)
    else:
        dct_sizes = (int(dct_size),) * ndim
    if output_chunksize is not None:
        dct_sizes = tuple(
            int(min(ds, output_chunksize[d], s)) for ds, d, s in zip(dct_sizes, sdims, spatial_shape)
        )
    else:
        dct_sizes = tuple(int(min(ds, s)) for ds, s in zip(dct_sizes, spatial_shape))

    quality = filter_ops.dct_entropy_quality(
        tv, dct_sizes, otf_support_fraction=otf_support_fraction, exponent=exponent
    )
    quality = normalize_weights(quality - _nanmin0(quality))
    scale = np.diag([1.0 / ds for ds in dct_sizes])
    offset = np.array([-(ds - 1) / (2.0 * ds) for ds in dct_sizes])
    full = torch.stack([
        _resample_nearest_edge(quality[i], scale, offset, spatial_shape)
        for i in range(quality.shape[0])
    ])
    return normalize_weights(full)


def _resample_nearest_edge(grid: torch.Tensor, matrix, offset, out_shape) -> torch.Tensor:
    """Linear resample of ``grid`` with its coordinates clamped to the grid
    (scipy's ``mode="nearest"`` at order 1)."""
    ndim = grid.dim()
    dev = grid.device
    coords = resample_ops._coords(
        torch.as_tensor(np.asarray(matrix), dtype=torch.float32, device=dev)[None],
        torch.as_tensor(np.asarray(offset), dtype=torch.float32, device=dev)[None],
        tuple(out_shape),
    )
    clamped = [coords[d][0].clamp(0, grid.shape[d] - 1) for d in range(ndim)]
    floors = [torch.floor(c) for c in clamped]
    fracs = [(c - f).to(grid.dtype) for c, f in zip(clamped, floors)]
    base = [f.to(torch.int64) for f in floors]
    vals = torch.zeros(tuple(out_shape), dtype=grid.dtype, device=dev)
    for corner in range(2**ndim):
        bits = [(corner >> d) & 1 for d in range(ndim)]
        idx = tuple(torch.clamp(base[d] + bits[d], 0, grid.shape[d] - 1) for d in range(ndim))
        w = None
        for d in range(ndim):
            f = fracs[d] if bits[d] else 1 - fracs[d]
            w = f if w is None else w * f
        vals = vals + w * grid[idx]
    return vals


def nan_gaussian_filter(ar: torch.Tensor, sigma, mode: str = "reflect") -> torch.Tensor:
    """NaN-aware gaussian filter over every axis (``ops.filters``)."""
    return filter_ops.nan_gaussian_filter(ar, sigma, mode=mode)
