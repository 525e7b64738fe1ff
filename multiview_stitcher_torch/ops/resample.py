"""Resampling: host-side pixel parameters (numpy float64) and the linear
resamples that registration runs on its crops (torch, batched).

The port of ``multiview_stitcher_tpu.ops.resample`` for order 1 and a
constant ``cval``, scipy's ``affine_transform(order=1, mode="constant")``:
output index ``i`` samples input coordinate ``matrix @ i + offset``;
coordinates outside ``[0, size - 1]`` give exactly ``cval``; corners of
weight 0 contribute exactly 0 even where the input is NaN. Other orders are
not ported yet (ROADMAP.md, queue 1: item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from multiview_stitcher_torch.param_utils import transform_pts  # noqa: F401


def _check_order(order: int) -> None:
    if order != 1:
        raise NotImplementedError(
            f"order={order}: only linear resampling is ported (ROADMAP.md, queue 1: item 6)"
        )


def affine_resample_batch(data: torch.Tensor, matrices, offsets, out_shape: tuple,
                          order: int = 1, cval=float("nan")) -> torch.Tensor:
    """Resample each item of ``data`` (B, *shape) onto a grid of
    ``out_shape`` at its own affine: ``matrices`` (B, ndim, ndim) and
    ``offsets`` (B, ndim) map output indices to input indices. Integer data
    is read as float32."""
    _check_order(order)
    ndim = len(out_shape)
    B = data.shape[0]
    dev = data.device
    vals_in = data if data.is_floating_point() else data.to(torch.float32)
    mats = torch.as_tensor(matrices, dtype=torch.float32, device=dev)
    offs = torch.as_tensor(offsets, dtype=torch.float32, device=dev)
    sizes = tuple(data.shape[1:])
    idx = [
        torch.arange(out_shape[d], dtype=torch.float32, device=dev).reshape(
            (1,) + (1,) * d + (-1,) + (1,) * (ndim - d - 1)
        )
        for d in range(ndim)
    ]
    per_item = (B,) + (1,) * ndim
    coords = []
    for d in range(ndim):
        c = offs[:, d].reshape(per_item).expand((B,) + tuple(out_shape))
        for j in range(ndim):
            c = c + mats[:, d, j].reshape(per_item) * idx[j]
        coords.append(c)
    valid = None
    for d in range(ndim):
        v = (coords[d] >= 0) & (coords[d] <= sizes[d] - 1)
        valid = v if valid is None else valid & v
    floors = [torch.floor(c) for c in coords]
    fracs = [c - f for c, f in zip(coords, floors)]
    base = [f.to(torch.int64) for f in floors]
    strides = [int(np.prod(sizes[d + 1:])) for d in range(ndim)]
    flat = vals_in.reshape(B, -1)
    vals = torch.zeros((B,) + tuple(out_shape), dtype=vals_in.dtype, device=dev)
    for corner in range(2**ndim):
        bits = [(corner >> d) & 1 for d in range(ndim)]
        lin = None
        w = None
        for d in range(ndim):
            i = torch.clamp(base[d] + bits[d], 0, sizes[d] - 1) * strides[d]
            lin = i if lin is None else lin + i
            f = fracs[d] if bits[d] else 1.0 - fracs[d]
            w = f if w is None else w * f
        g = flat.gather(1, lin.reshape(B, -1)).reshape(vals.shape)
        vals = vals + torch.where(w > 0, w * g, 0.0)
    return torch.where(valid, vals, torch.as_tensor(cval, dtype=vals.dtype, device=dev))


def affine_resample(data: torch.Tensor, matrix, offset, out_shape: tuple, order: int = 1,
                    cval=float("nan")) -> torch.Tensor:
    """:func:`affine_resample_batch` of one image."""
    return affine_resample_batch(
        data[None], torch.as_tensor(matrix)[None], torch.as_tensor(offset)[None],
        out_shape, order=order, cval=cval,
    )[0]


def separable_axis_aligned_resample(data: torch.Tensor, diag, offset, out_shape: tuple,
                                    cval=float("nan"), valid_extent=None) -> torch.Tensor:
    """Linear resample of each item of ``data`` (B, *shape) at an axis-aligned
    map ``in_d = diag[d] * out_d + offset[d]`` (``diag``/``offset``: (B, ndim)
    or (ndim,)), one axis at a time from its two taps. Outputs whose
    coordinate leaves ``[0, valid_extent - 1]`` on any axis are ``cval``.
    ``data`` must hold no NaN: validity is tracked from the coordinates."""
    ndim = len(out_shape)
    B = data.shape[0]
    dev = data.device
    vals = data if data.is_floating_point() else data.to(torch.float32)
    diag = torch.as_tensor(diag, dtype=torch.float32, device=dev).expand(B, ndim)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=dev).expand(B, ndim)
    extent = (
        [float(s) for s in data.shape[1:]] if valid_extent is None
        else [float(v) for v in valid_extent]
    )
    valid = None
    for d in range(ndim):
        n_in = vals.shape[1 + d]
        i = torch.arange(out_shape[d], dtype=torch.float32, device=dev)
        c = diag[:, d, None] * i[None, :] + offset[:, d, None]  # (B, out_d)
        f = torch.floor(c)
        w1 = c - f
        fi = f.to(torch.int64)
        shape = [B] + [1] * ndim
        shape[1 + d] = out_shape[d]
        i0 = torch.clamp(fi, 0, n_in - 1).reshape(shape)
        i1 = torch.clamp(fi + 1, 0, n_in - 1).reshape(shape)
        w1 = w1.reshape(shape)
        v0 = torch.take_along_dim(vals, i0, dim=1 + d)
        v1 = torch.take_along_dim(vals, i1, dim=1 + d)
        vals = (1.0 - w1) * v0 + torch.where(w1 > 0, w1 * v1, 0.0)
        v = ((c >= 0) & (c <= extent[d] - 1)).reshape(shape)
        valid = v if valid is None else valid & v
    return torch.where(valid, vals, torch.as_tensor(cval, dtype=vals.dtype, device=dev))


def physical_to_pixel_params(
    p: np.ndarray,
    input_spacing: np.ndarray,
    input_origin: np.ndarray,
    output_spacing: np.ndarray,
    output_origin: np.ndarray,
):
    """Convert a physical-space affine into pixel-space (matrix, offset).

    ``p`` maps output physical coordinates -> input physical coordinates; the
    returned (matrix, offset) map output pixel indices -> input pixel indices.
    Rounds to 10 decimals and snaps near-integer offsets, so that float error
    in the physical parameters does not leave a translation a hair off the
    pixel grid.
    """
    p = np.asarray(p, dtype=float)
    ndim = p.shape[-1] - 1
    matrix = p[:ndim, :ndim]
    offset = p[:ndim, ndim]

    Sx = np.diag(np.asarray(output_spacing, dtype=float))
    Sy = np.asarray(input_spacing, dtype=float)
    Ox = np.asarray(output_origin, dtype=float)
    Oy = np.asarray(input_origin, dtype=float)

    matrix_prime = (matrix @ Sx) / Sy[:, None]
    local_input_origin = Oy - Ox
    local_offset = offset + (matrix - np.eye(ndim)) @ Ox
    offset_prime = (local_offset - local_input_origin) / Sy

    decimals = 10
    matrix_prime = np.around(matrix_prime, decimals=decimals)
    offset_prime = np.around(offset_prime, decimals=decimals)

    nearest_integer = np.round(offset_prime)
    near = np.isclose(offset_prime, nearest_integer, rtol=0, atol=1e-6)
    offset_prime[near] = nearest_integer[near]

    return matrix_prime, offset_prime
