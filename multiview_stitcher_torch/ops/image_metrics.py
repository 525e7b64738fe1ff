"""Image-quality metrics on torch tensors: SSIM maps, SSIM over a box and
over a whole image, masked Spearman correlation, NaN-aware NCC.

The port of ``multiview_stitcher_tpu.ops.image_metrics``. Every function
takes images with leading batch axes and ``ndim`` spatial axes last. As in
the reference, SSIM (skimage's, with uniform windows) is computed over the
whole image and averaged over the interior of a box, so that boxes of any
extent keep static shapes: windows wholly inside the box read the pixels
that slicing the box first would.
"""

from __future__ import annotations

import torch

from multiview_stitcher_torch.ops.filters import uniform_filter

K1, K2 = 0.01, 0.03


def _spatial(x: torch.Tensor, ndim: int) -> tuple:
    return tuple(range(x.dim() - ndim, x.dim()))


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-item value (leading axes) broadcast over ``ndim`` spatial axes."""
    return v.reshape(tuple(v.shape) + (1,) * ndim)


def nan_aware_ncc(im0: torch.Tensor, im1: torch.Tensor, ndim: int = None) -> torch.Tensor:
    """Normalised cross-correlation over the pixels where neither is NaN."""
    ndim = im0.dim() if ndim is None else ndim
    axes = _spatial(im0, ndim)
    mask = ~(torch.isnan(im0) | torch.isnan(im1))
    n = mask.sum(axes)
    n_safe = torch.clamp_min(n, 1)
    a = torch.where(mask, im0, 0.0)
    b = torch.where(mask, im1, 0.0)
    ma = a.sum(axes) / n_safe
    mb = b.sum(axes) / n_safe
    da = im0 - _bcast(ma, ndim)
    db = im1 - _bcast(mb, ndim)
    va = torch.where(mask, da**2, 0.0).sum(axes) / n_safe
    vb = torch.where(mask, db**2, 0.0).sum(axes) / n_safe
    cov = torch.where(mask, da * db, 0.0).sum(axes) / n_safe
    denom = torch.sqrt(va * vb)
    return torch.where((n > 1) & (denom > 0), cov / denom, torch.nan)


def _bbox_bounds_from_mask(mask: torch.Tensor, ndim: int):
    """Per-dim (lo, hi) index bounds of the True region, (..., ndim) each;
    (n, -1) along a dim where nothing is True."""
    axes = _spatial(mask, ndim)
    los, his = [], []
    for k, ax in enumerate(axes):
        line = mask.any(dim=tuple(a for a in axes if a != ax)) if ndim > 1 else mask
        n = line.shape[-1]
        idx = torch.arange(n, device=mask.device)
        los.append(torch.where(line, idx, n).amin(-1))
        his.append(torch.where(line, idx, -1).amax(-1))
    return torch.stack(los, -1), torch.stack(his, -1)


def _box_mask(shape, los: torch.Tensor, his: torch.Tensor) -> torch.Tensor:
    """(..., *shape) mask of the boxes [lo, hi] (inclusive) per item."""
    ndim = len(shape)
    mask = None
    for ax in range(ndim):
        idx = torch.arange(shape[ax], device=los.device).reshape(
            (1,) * ax + (-1,) + (1,) * (ndim - ax - 1)
        )
        lo = _bcast(los[..., ax], ndim)
        hi = _bcast(his[..., ax], ndim)
        m = (idx >= lo) & (idx <= hi)
        mask = m if mask is None else mask & m
    return mask


def ssim_fixed_maps(im0: torch.Tensor, win_size: int, ndim: int):
    """The fixed image's filter maps (ux, uxx), shared by every moving image
    it is compared with."""
    return uniform_filter(im0, win_size, ndim), uniform_filter(im0 * im0, win_size, ndim)


def ssim_map_precomputed(im0, ux, uxx, im1, win_size: int, data_range, ndim: int):
    """Per-pixel SSIM against ``im1`` from the fixed maps; ``data_range`` is
    a per-item tensor (or a number)."""
    NP = win_size**ndim
    cov_norm = NP / (NP - 1)
    uy = uniform_filter(im1, win_size, ndim)
    uyy = uniform_filter(im1 * im1, win_size, ndim)
    uxy = uniform_filter(im0 * im1, win_size, ndim)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    if isinstance(data_range, torch.Tensor):
        data_range = _bcast(data_range, ndim)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux * ux + uy * uy + C1
    B2 = vx + vy + C2
    return (A1 * A2) / (B1 * B2)


def ssim_map(im0, im1, win_size: int, data_range, ndim: int = None):
    """Per-pixel SSIM of two images (skimage's, uniform windows and the
    sample covariance ``NP / (NP - 1)``), in float32."""
    ndim = im0.dim() if ndim is None else ndim
    im0 = im0.to(torch.float32)
    im1 = im1.to(torch.float32)
    ux, uxx = ssim_fixed_maps(im0, win_size, ndim)
    return ssim_map_precomputed(im0, ux, uxx, im1, win_size, data_range, ndim)


def _mean_over_box_interior(smap, los, his, win_size: int, ndim: int):
    pad = (win_size - 1) // 2
    shape = tuple(smap.shape[smap.dim() - ndim:])
    interior = _box_mask(shape, los + pad, his - pad)
    axes = _spatial(smap, ndim)
    n = interior.sum(axes)
    total = torch.where(interior, smap, 0.0).sum(axes)
    return torch.where(n > 0, total / torch.clamp_min(n, 1), -1.0)


def ssim_mean_over_box(im0, im1, los, his, win_size: int, data_range, ndim: int = None):
    """Mean SSIM over the interior of the boxes [lo, hi]; equal to the SSIM
    of the images cut to the box wherever the box admits the window."""
    ndim = im0.dim() if ndim is None else ndim
    smap = ssim_map(im0, im1, win_size, data_range, ndim)
    return _mean_over_box_interior(smap, los, his, win_size, ndim)


def ssim_mean_over_box_precomputed(im0, ux, uxx, im1, los, his, win_size: int, data_range, ndim):
    """Mean SSIM over the interior of the boxes [lo, hi] (the window's
    half-width in from each side); -1 where the interior is empty."""
    smap = ssim_map_precomputed(im0, ux, uxx, im1, win_size, data_range, ndim)
    return _mean_over_box_interior(smap, los, his, win_size, ndim)


def structural_similarity(im0: torch.Tensor, im1: torch.Tensor, win_size: int = 7,
                          data_range=None) -> torch.Tensor:
    """Mean SSIM of two whole images, over the pixels a full window covers
    (skimage's mean); ``data_range`` defaults to the joint range."""
    if data_range is None:
        data_range = float(
            torch.maximum(im0.max(), im1.max()) - torch.minimum(im0.min(), im1.min())
        )
    pad = (win_size - 1) // 2
    smap = ssim_map(im0, im1, win_size, data_range)
    return smap[tuple(slice(pad, s - pad) for s in im0.shape)].mean()


def _average_ranks_sorted(v_sorted: torch.Tensor) -> torch.Tensor:
    """Tie-averaged 1-based ranks of vectors sorted ascending along the last
    axis: within a run of equal values, the mean of its first and last
    positions."""
    n = v_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=v_sorted.device).expand_as(v_sorted)
    start = torch.ones(v_sorted.shape, dtype=torch.bool, device=v_sorted.device)
    start[..., 1:] = v_sorted[..., 1:] != v_sorted[..., :-1]
    first = torch.cummax(torch.where(start, idx, -1.0), dim=-1).values
    next_start = torch.full(v_sorted.shape, float(n), device=v_sorted.device)
    next_start[..., :-1] = torch.where(start[..., 1:], idx[..., 1:], float(n))
    last = torch.flip(torch.cummin(torch.flip(next_start, (-1,)), dim=-1).values, (-1,)) - 1.0
    return (first + last) / 2.0 + 1.0


def masked_spearman(im0: torch.Tensor, im1: torch.Tensor, mask: torch.Tensor, ndim: int):
    """Spearman's rho of im0[mask] against im1[mask] per item (tie-averaged
    ranks, as scipy's ``spearmanr``); NaN where it is undefined."""
    lead = im0.shape[: im0.dim() - ndim]
    a = im0.reshape(lead + (-1,))
    b = im1.reshape(lead + (-1,))
    m = mask.reshape(lead + (-1,))
    n = m.sum(-1)

    def ranks(x):
        xv = torch.where(m, x, torch.inf)
        xs, order = torch.sort(xv, dim=-1, stable=True)
        r = torch.empty_like(xs).scatter_(-1, order, _average_ranks_sorted(xs))
        return torch.where(m, r, 0.0)

    ra = ranks(a)
    rb = ranks(b)
    nf = torch.clamp_min(n, 1).to(torch.float32)
    ma = ra.sum(-1) / nf
    mb = rb.sum(-1) / nf
    da = torch.where(m, ra - ma[..., None], 0.0)
    db = torch.where(m, rb - mb[..., None], 0.0)
    cov = (da * db).sum(-1)
    denom = torch.sqrt((da * da).sum(-1) * (db * db).sum(-1))
    return torch.where((n > 1) & (denom > 0), cov / denom, torch.nan)
