"""Image filters on torch tensors: gaussian, Laplacian of gaussian, NaN-aware
gaussian, min/max, box, and the DCT entropy quality of content-based weights.

The port of ``multiview_stitcher_tpu.ops.filters``. Kernels and boundary
modes are scipy.ndimage's (truncate 4.0, ``radius = int(truncate * sigma +
0.5)``; ``reflect``, ``mirror``, ``nearest``, ``wrap``, ``constant``), and a
pad longer than its axis reflects or wraps as often as it must, as numpy's
``pad`` does. Each filter works on the last ``ndim`` axes of a tensor (all
axes by default), so leading batch axes (views) pass through.

A 1-D correlation is one ``conv2d`` over the padded axis (cuDNN on the card)
and the DCTs are small matmuls, all at full float32 precision: TF32 is off
for the call (:func:`~multiview_stitcher_torch.utils.misc.full_f32`), as the
reference computes them in float32. ``uniform_filter`` (SSIM's box filter)
is one average pool an axis over a reflect-padded copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from multiview_stitcher_torch.utils.misc import full_f32

_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MODES = ("reflect", "mirror", "nearest", "wrap", "constant")


def _pad_index(n: int, left: int, right: int, mode: str, device) -> torch.Tensor:
    """Indices of an axis of length ``n`` padded by ``left`` / ``right`` in
    scipy's ``mode`` (not "constant"), periodic for pads longer than the axis:
    "reflect" repeats the edge sample (d c b a | a b c d), "mirror" does not
    (d c b | a b c d), "nearest" repeats it, "wrap" wraps around."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "reflect":
        i = i % (2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    if mode == "mirror":
        if n == 1:
            return torch.zeros_like(i)
        i = i % (2 * n - 2)
        return torch.where(i >= n, 2 * n - 2 - i, i)
    if mode == "nearest":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


def _pad_axis(data: torch.Tensor, axis: int, left: int, right: int, mode: str, cval) -> torch.Tensor:
    if mode != "constant":
        return data.index_select(axis, _pad_index(data.shape[axis], left, right, mode, data.device))
    shape = list(data.shape)
    shape[axis] += left + right
    out = torch.full(shape, cval, dtype=data.dtype, device=data.device)
    out.narrow(axis, left, data.shape[axis]).copy_(data)
    return out


def _per_axis(value, ndim: int) -> list:
    return [value] * ndim if np.isscalar(value) else list(value)


def gaussian_kernel_1d(sigma: float, order: int = 0, truncate: float = 4.0) -> np.ndarray:
    """1-D gaussian (order 0) or second-derivative (order 2) kernel, as
    scipy's, in float64."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=float)
    sigma2 = float(sigma) * float(sigma)
    phi = np.exp(-0.5 / sigma2 * x**2)
    phi = phi / phi.sum()
    if order == 0:
        return phi
    if order == 2:
        kern = (x**2 / sigma2 - 1.0) / sigma2 * phi
        kern -= kern.mean()
        # scipy normalizes so that sum(x^2 / 2 * kern) == 1
        return kern / ((x**2 * kern).sum() / 2.0)
    raise NotImplementedError(f"gaussian kernels of order {order}")


def _correlate_along_axis(data: torch.Tensor, kernel, axis: int, mode: str = "reflect",
                          cval=0.0) -> torch.Tensor:
    """Correlate ``data`` with an odd 1-D ``kernel`` along ``axis``: one
    ``conv2d`` over the axis padded in ``mode``, the axes before it as the
    batch and those after it as the width."""
    k = torch.as_tensor(np.asarray(kernel), dtype=data.dtype, device=data.device)
    r = (k.shape[0] - 1) // 2
    padded = _pad_axis(data, axis, r, r, mode, cval)
    n = data.shape[axis]
    before = int(np.prod(data.shape[:axis], dtype=np.int64))
    after = int(np.prod(data.shape[axis + 1:], dtype=np.int64))
    if after == 1:
        # the last axis: one image of ``before`` rows
        x, w = padded.reshape(1, 1, before, n + 2 * r), k.reshape(1, 1, 1, -1)
    else:
        x, w = padded.reshape(before, 1, n + 2 * r, after), k.reshape(1, 1, -1, 1)
    with full_f32():
        out = F.conv2d(x, w)
    return out.reshape(data.shape)


def _filter_axes(data: torch.Tensor, ndim: Optional[int]) -> range:
    ndim = data.dim() if ndim is None else ndim
    return range(data.dim() - ndim, data.dim())


def _as_float(data: torch.Tensor) -> torch.Tensor:
    return data if data.is_floating_point() else data.to(torch.float32)


def gaussian_filter(data: torch.Tensor, sigma, mode: str = "reflect", truncate: float = 4.0,
                    order: Union[int, Sequence[int]] = 0, ndim: Optional[int] = None) -> torch.Tensor:
    """Separable gaussian filter over the last ``ndim`` axes, as
    ``scipy.ndimage.gaussian_filter``; axes whose sigma is 0 are left as
    they are. Integer data is filtered as float32."""
    out = _as_float(data)
    axes = _filter_axes(out, ndim)
    sigmas, orders = _per_axis(sigma, len(axes)), _per_axis(order, len(axes))
    for i, ax in enumerate(axes):
        if sigmas[i] == 0:
            continue
        kern = gaussian_kernel_1d(sigmas[i], order=orders[i], truncate=truncate)
        out = _correlate_along_axis(out, kern, ax, mode=mode)
    return out


def gaussian_laplace(data: torch.Tensor, sigma, mode: str = "reflect", truncate: float = 4.0,
                     ndim: Optional[int] = None) -> torch.Tensor:
    """Laplacian of gaussian: the sum over axes of the second-derivative
    filters along each."""
    data = _as_float(data)
    n = len(_filter_axes(data, ndim))
    out = torch.zeros_like(data)
    for i in range(n):
        orders = [0] * n
        orders[i] = 2
        out = out + gaussian_filter(data, sigma, mode=mode, truncate=truncate, order=orders,
                                    ndim=n)
    return out


def nan_gaussian_filter(ar: torch.Tensor, sigma, mode: str = "reflect",
                        ndim: Optional[int] = None) -> torch.Tensor:
    """Gaussian filter that ignores NaN: the filtered zero-filled data over
    the filtered validity mask; NaN stays NaN."""
    ar = _as_float(ar)
    nan_mask = torch.isnan(ar)
    vv = gaussian_filter(torch.where(nan_mask, 0.0, ar), sigma, mode=mode, ndim=ndim)
    ww = gaussian_filter((~nan_mask).to(ar.dtype), sigma, mode=mode, ndim=ndim)
    ww = torch.where(nan_mask, 1.0, ww)
    return torch.where(nan_mask, torch.nan, vv / ww)


def uniform_filter(data: torch.Tensor, size: int, ndim: int = None,
                   mode: str = "reflect") -> torch.Tensor:
    """Box filter of odd ``size`` over the last ``ndim`` axes (all axes by
    default), padded at the borders in scipy's ``mode`` ("constant" pads
    zeros). Each axis is one average pool, which sums the window and divides
    by its size (the reference's separable correlation with taps ``1/size``
    agrees to a rounding of the last bit)."""
    if size % 2 != 1:
        raise ValueError(f"uniform_filter takes odd sizes, got {size}")
    ndim = data.dim() if ndim is None else ndim
    if ndim not in _POOLS:
        raise ValueError(f"uniform_filter takes 1 to 3 axes, got {ndim}")
    r = (size - 1) // 2
    lead = data.shape[: data.dim() - ndim]
    out = data.reshape((-1, 1) + tuple(data.shape[data.dim() - ndim:]))
    for ax in range(ndim):
        axis = 2 + ax
        out = _pad_axis(out, axis, r, r, mode, 0.0)
        kernel = [1] * ndim
        kernel[ax] = size
        out = _POOLS[ndim](out, kernel_size=tuple(kernel), stride=1)
    return out.reshape(lead + tuple(out.shape[2:]))


def _extremum_filter(data: torch.Tensor, size, mode: str, is_max: bool, cval,
                     ndim: Optional[int]) -> torch.Tensor:
    """Box maximum or minimum, one axis at a time (exact: the box is the
    product of its axis windows). The window of an even size reaches one
    sample further right than left, as the reference's."""
    axes = _filter_axes(data, ndim)
    sizes = _per_axis(size, len(axes))
    if cval is None:
        if data.is_floating_point():
            cval = -torch.inf if is_max else torch.inf
        else:
            info = torch.iinfo(data.dtype)
            cval = info.min if is_max else info.max
    op = torch.maximum if is_max else torch.minimum
    out = data
    for ax, s in zip(axes, sizes):
        r = (s - 1) // 2
        n = out.shape[ax]
        padded = _pad_axis(out, ax, r, s - 1 - r, mode, cval)
        acc = padded.narrow(ax, 0, n)
        for j in range(1, s):
            acc = op(acc, padded.narrow(ax, j, n))
        out = acc.contiguous()
    return out


def maximum_filter(data: torch.Tensor, size, mode: str = "reflect", cval=None,
                   ndim: Optional[int] = None) -> torch.Tensor:
    """Box maximum of ``size`` (an int or one per axis) over the last ``ndim``
    axes; ``constant`` mode pads with ``cval`` (-inf by default)."""
    return _extremum_filter(data, size, mode, True, cval, ndim)


def minimum_filter(data: torch.Tensor, size, mode: str = "reflect", cval=None,
                   ndim: Optional[int] = None) -> torch.Tensor:
    """Box minimum, as :func:`maximum_filter` (``cval`` +inf by default)."""
    return _extremum_filter(data, size, mode, False, cval, ndim)


# ---------------------------------------------------------------------------
# DCT entropy quality (Royer et al. 2016)
# ---------------------------------------------------------------------------


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows are frequencies), float64."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    C = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    C[0] /= np.sqrt(2.0)
    return C


def _plogp(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0)


def dct_entropy_quality(views: torch.Tensor, dct_sizes: Tuple[int, ...],
                        otf_support_fraction: Optional[float] = 0.5,
                        exponent: float = 1.0) -> torch.Tensor:
    """Per-block DCT Shannon-entropy quality of each view.

    ``views`` (V, *spatial); returns (V, *n_blocks). The blocks tile each
    axis from 0; the last block of an axis holds what is left of it and is
    transformed with the DCT of its own size (zero-padded to the block size,
    so only its own samples and coefficients take part), and the L1
    normalisation counts its own elements. NaN samples of a block are filled
    with the block's smallest value (0 where that is at most 1e-4), and a
    block with under 20 % valid samples has quality 0. With
    ``otf_support_fraction`` the entropy is taken over the coefficients
    inside that fraction of the block's L1 ball, normalised by their L2 norm.
    """
    V = views.shape[0]
    spatial_shape = tuple(views.shape[1:])
    ndim = len(spatial_shape)
    dev = views.device
    n_blocks = tuple(-(-s // ds) for s, ds in zip(spatial_shape, dct_sizes))
    remainders = tuple(s - (nb - 1) * ds for s, nb, ds in zip(spatial_shape, n_blocks, dct_sizes))

    padded = torch.full((V,) + tuple(nb * ds for nb, ds in zip(n_blocks, dct_sizes)),
                        torch.nan, dtype=views.dtype, device=dev)
    padded[(slice(None),) + tuple(slice(0, s) for s in spatial_shape)] = views
    shape = (V,)
    for nb, ds in zip(n_blocks, dct_sizes):
        shape += (nb, ds)
    perm = (0,) + tuple(1 + 2 * i for i in range(ndim)) + tuple(2 + 2 * i for i in range(ndim))
    blocked = padded.reshape(shape).permute(perm)  # (V, *nb, *ds)

    nan_mask = torch.isnan(blocked)
    block_axes = tuple(range(1 + ndim, 1 + 2 * ndim))
    n_valid = (~nan_mask).sum(dim=block_axes)
    trunc_size = np.ones((1,) + n_blocks, dtype=np.float32)
    for i, (nb, ds, r) in enumerate(zip(n_blocks, dct_sizes, remainders)):
        ext = np.full(nb, float(ds), dtype=np.float32)
        ext[-1] = float(r)
        sh = [1] * (1 + ndim)
        sh[1 + i] = nb
        trunc_size = trunc_size * ext.reshape(sh)
    trunc_size = torch.from_numpy(trunc_size).to(dev)

    fill = torch.where(nan_mask, torch.inf, blocked).amin(dim=block_axes, keepdim=True)
    fill = torch.where(torch.isfinite(fill), fill, 0.0)
    fill = torch.where(fill > 0.0001, fill, 0.0)
    d = torch.where(nan_mask, fill, blocked)

    with full_f32():
        for i, (ds, r) in enumerate(zip(dct_sizes, remainders)):
            C = torch.as_tensor(dct_matrix(ds), dtype=d.dtype, device=dev)
            d_ax = d.movedim(1 + ndim + i, -1)
            d_full = d_ax @ C.T
            if r < ds:
                Cr = np.zeros((ds, ds), dtype=np.float64)
                Cr[:r, :r] = dct_matrix(r)
                d_r = d_ax @ torch.as_tensor(Cr, dtype=d.dtype, device=dev).T
                is_last = torch.arange(n_blocks[i], device=dev).reshape(
                    [1] * (1 + i) + [n_blocks[i]] + [1] * (ndim - 1 - i + ndim)
                ) == n_blocks[i] - 1
                d_full = torch.where(is_last, d_r, d_full)
            d = d_full.movedim(-1, 1 + ndim + i)

    absd = d.abs()
    first = (Ellipsis,) + (0,) * ndim
    if otf_support_fraction is not None:
        r_o = otf_support_fraction * min(dct_sizes)
        grids = np.meshgrid(*[np.arange(ds) for ds in dct_sizes], indexing="ij")
        otf_mask = torch.from_numpy(sum(grids) < r_o).to(dev)
        l2 = torch.sqrt((d**2).sum(dim=block_axes, keepdim=True))
        p = torch.where(otf_mask, absd, 0.0) / torch.where(l2 == 0, 1.0, l2)
        entropy = -_plogp(p).sum(dim=block_axes)
        quality = (2.0 / r_o**2) * entropy
        quality = torch.where(l2[first] == 0, 0.0, quality)
        quality = torch.sign(quality) * quality.abs() ** exponent
    else:
        dsl1 = absd.sum(dim=block_axes, keepdim=True) / trunc_size.reshape(
            (1,) + n_blocks + (1,) * ndim
        )
        p = absd / torch.where(dsl1 == 0, 1.0, dsl1)
        entropy = -_plogp(p).sum(dim=block_axes)
        quality = (dsl1[first] * entropy) ** exponent
        quality = torch.where(dsl1[first] == 0, 0.0, quality)
    return torch.where(n_valid < 0.2 * trunc_size, 0.0, quality)
