"""Resampling: host-side pixel parameters (numpy float64) and the gather
resamples of the general fusion path and of registration (torch, batched).

The port of ``multiview_stitcher_tpu.ops.resample``, scipy's
``affine_transform(order=0 or 1, mode="constant")``: output index ``i``
samples input coordinate ``matrix @ i + offset``, computed in float32;
coordinates outside ``[0, size - 1]`` give exactly ``cval``. Order 0 takes
the nearest sample (ties to even), order 1 the multilinear interpolation, in
the compute dtype of the data (float data keeps its dtype, float64 included;
other data is read as float32); a corner of weight 0 contributes exactly 0
even where the input is NaN, so NaN spreads only through corners that carry
weight.
"""

from __future__ import annotations

import numpy as np
import torch

from multiview_stitcher_torch.param_utils import transform_pts  # noqa: F401


def _check_order(order: int) -> None:
    if order not in (0, 1):
        raise NotImplementedError(f"order={order}: the gather resamples take orders 0 and 1")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _coords(mats: torch.Tensor, offs: torch.Tensor, out_shape: tuple) -> list:
    """Per-dim (B, *out_shape) float32 input coordinates of every output
    index, summed in the reference's order (offset, then each column)."""
    B, ndim = offs.shape
    dev = offs.device
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
    return coords


def _gather_resample(src, item_base, strides, sizes, matrices, offsets, out_shape, order,
                     cval, extents=None) -> torch.Tensor:
    """The resample of B items that read the flat ``src`` (in the compute
    dtype): item b's sample at index ``j`` (each ``j_d`` in ``[0,
    sizes[d])``) is ``src[item_base[b] + sum_d j_d * strides[d]]``, or NaN
    where some ``j_d >= extents[b, d]`` (a NaN-padded window)."""
    _check_order(order)
    ndim = len(out_shape)
    B = item_base.shape[0]
    dev = src.device
    dtype = src.dtype
    mats = torch.as_tensor(matrices, dtype=torch.float32, device=dev).reshape(B, ndim, ndim)
    offs = torch.as_tensor(offsets, dtype=torch.float32, device=dev).reshape(B, ndim)
    coords = _coords(mats, offs, out_shape)
    per_item = (B,) + (1,) * ndim
    # per-dim index arithmetic in int32 where the source allows it (half the
    # bytes of every index pass); the flat index of a read in int64
    itype = torch.int32 if src.numel() < 2**31 else torch.int64
    base = item_base.reshape(per_item).to(itype)
    if extents is not None:
        ext = torch.as_tensor(extents, device=dev).reshape(B, ndim).to(itype)
        ext = [ext[:, d].reshape(per_item) for d in range(ndim)]

    def tap(i, d):
        """The strided offset of index ``i`` along ``d``, clamped into the
        window, and (for windows) whether it lies inside the extent; a
        sample past a window's extent is its NaN padding, read at the
        window's last sample (inside the tile; its first for an empty
        window) and masked."""
        i = i.clamp(0, sizes[d] - 1)
        inside = None
        if extents is not None:
            inside = i < ext[d]
            i = torch.minimum(i, ext[d] - 1).clamp(min=0)
        return i * strides[d], inside

    def read(taps):
        lin = base
        inside = None
        for off, ins in taps:
            lin = lin + off
            if ins is not None:
                inside = ins if inside is None else inside & ins
        v = src.take(lin.to(torch.int64))
        return v if inside is None else torch.where(inside, v, torch.nan)

    valid = None
    for d in range(ndim):
        v = (coords[d] >= 0) & (coords[d] <= sizes[d] - 1)
        valid = v if valid is None else valid & v
    if order == 0:
        vals = read([tap(torch.round(c).to(itype), d) for d, c in enumerate(coords)])
    else:
        # each dim's two taps and weights once, combined per corner
        taps, wts = [], []
        for d, c in enumerate(coords):
            f = torch.floor(c)
            frac = c - f
            i0 = f.to(itype)
            taps.append((tap(i0, d), tap(i0 + 1, d)))
            wts.append(((1.0 - frac).to(dtype), frac.to(dtype)))
        del coords
        vals = torch.zeros((B,) + tuple(out_shape), dtype=dtype, device=dev)
        for corner in range(2**ndim):
            bits = [(corner >> d) & 1 for d in range(ndim)]
            w = wts[0][bits[0]]
            for d in range(1, ndim):
                w = w * wts[d][bits[d]]
            g = read([taps[d][bits[d]] for d in range(ndim)])
            vals = vals + torch.where(w > 0, w * g, 0.0)
    return torch.where(valid, vals, torch.as_tensor(cval, dtype=dtype, device=dev))


def _c_strides(shape) -> list:
    return [int(np.prod(shape[d + 1:], dtype=np.int64)) for d in range(len(shape))]


def affine_resample_batch(data: torch.Tensor, matrices, offsets, out_shape: tuple,
                          order: int = 1, cval=float("nan")) -> torch.Tensor:
    """Resample each item of ``data`` (B, *shape) onto a grid of
    ``out_shape`` at its own affine: ``matrices`` (B, ndim, ndim) and
    ``offsets`` (B, ndim) map output indices to input indices."""
    B = data.shape[0]
    sizes = tuple(data.shape[1:])
    src = data.to(_compute_dtype(data.dtype)).reshape(-1)
    step = int(np.prod(sizes, dtype=np.int64))
    item_base = torch.arange(B, device=data.device) * step
    return _gather_resample(src, item_base, _c_strides(sizes), sizes, matrices, offsets,
                            tuple(out_shape), order, cval)


def affine_resample(data: torch.Tensor, matrix, offset, out_shape: tuple, order: int = 1,
                    cval=float("nan")) -> torch.Tensor:
    """:func:`affine_resample_batch` of one image."""
    return affine_resample_batch(
        data[None], torch.as_tensor(matrix)[None], torch.as_tensor(offset)[None],
        out_shape, order=order, cval=cval,
    )[0]


def affine_resample_windows(stack: torch.Tensor, tile_idx, starts, extents, window: tuple,
                            matrices, offsets, out_shape: tuple, order: int = 1,
                            cval=float("nan")) -> torch.Tensor:
    """:func:`affine_resample_batch` of B windows of the (V, *T) ``stack``
    without cutting them out: item b is the slab of shape ``window`` read
    from ``stack[tile_idx[b]]`` at the integer ``starts[b]``, NaN beyond its
    ``extents[b]``, which is what the reference resamples after it cuts a
    slab on the host and NaN-pads it to ``window``. The map is relative to
    the window's start."""
    T = tuple(stack.shape[1:])
    strides = _c_strides(T)
    dev = stack.device
    tile_idx = torch.as_tensor(np.asarray(tile_idx), dtype=torch.int64, device=dev)
    starts = torch.as_tensor(np.asarray(starts), dtype=torch.int64, device=dev)
    item_base = tile_idx * int(np.prod(T, dtype=np.int64)) + (
        starts * torch.as_tensor(strides, dtype=torch.int64, device=dev)
    ).sum(dim=1)
    src = stack.to(_compute_dtype(stack.dtype)).reshape(-1)
    return _gather_resample(src, item_base, strides, tuple(window), matrices, offsets,
                            tuple(out_shape), order, cval,
                            extents=np.asarray(extents, dtype=np.int64))


def translate_resample(data: torch.Tensor, shift, order: int = 1, cval=float("nan")) -> torch.Tensor:
    """Pure-translation resample onto the input's grid: ``out[i] = in[i + shift]``."""
    return translate_resample_batch(data, torch.as_tensor(shift)[None], order, cval)[0]


def translate_resample_batch(data: torch.Tensor, shifts, order: int = 1,
                             cval=float("nan")) -> torch.Tensor:
    """Translations of a stack: ``data`` (B, *spatial) takes one shift an
    item, or one image (*spatial) is resampled at every one of the (B,
    ndim) ``shifts`` without copying it."""
    shifts = torch.as_tensor(shifts, dtype=torch.float32, device=data.device)
    B, ndim = shifts.shape
    sizes = tuple(data.shape[-ndim:])
    src = data.to(_compute_dtype(data.dtype)).reshape(-1)
    step = 0 if data.dim() == ndim else int(np.prod(sizes, dtype=np.int64))
    item_base = torch.arange(B, device=data.device) * step
    mats = torch.eye(ndim, dtype=torch.float32, device=data.device).expand(B, ndim, ndim)
    return _gather_resample(src, item_base, _c_strides(sizes), sizes, mats, shifts, sizes,
                            order, cval)


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
