"""Phase correlation on torch tensors, batched over pairs.

The port of ``multiview_stitcher_tpu.ops.phase_correlation``: the
Kuglin-Hines cross-power spectrum and its argmax, with the Guizar-Sicairos
upsampled matrix DFT for subpixel refinement, and the Padfield masked
normalised cross-correlation (skimage's masked variant). The FFTs are
``torch.fft`` (cuFFT on the card), as they are XLA's in the reference. Every
function takes a leading pair axis and ``ndim`` spatial axes. Ties of an
argmax take the first index, as ``jnp.argmax`` does. The DFT kernels of the
refinement are built in float64 and cast to complex64, and their products
run at full float32 precision (TF32 off for the call).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multiview_stitcher_torch.utils.misc import full_f32

EPS32 = float(np.finfo(np.float32).eps)


def _axes(ndim: int) -> tuple:
    return tuple(range(1, ndim + 1))


def nanmin(x: torch.Tensor) -> torch.Tensor:
    """Per-item minimum over the non-NaN values of (B, ...); NaN where an
    item holds no other value."""
    flat = x.reshape(x.shape[0], -1)
    nan = torch.isnan(flat)
    return torch.where(nan.all(-1), torch.nan, torch.where(nan, torch.inf, flat).amin(-1))


def nanmax(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(x.shape[0], -1)
    nan = torch.isnan(flat)
    return torch.where(nan.all(-1), torch.nan, torch.where(nan, -torch.inf, flat).amax(-1))


def _per_item(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * ndim)


def rescale_intensity(im: torch.Tensor, ndim: int, in_range=None,
                      out_range=(0.0, 1.0)) -> torch.Tensor:
    """Each item rescaled linearly from ``in_range`` (by default its own
    [nanmin, nanmax]) to ``out_range`` (NaN stays NaN; an empty range
    divides by 1). A given range's width is taken in float64 and rounded
    once, as the reference takes it."""
    if in_range is None:
        lo, hi = nanmin(im), nanmax(im)
        denom = hi - lo
        denom = torch.where(denom == 0, 1.0, denom)
        scaled = (im - _per_item(lo, ndim)) / _per_item(denom, ndim)
    else:
        width = float(in_range[1]) - float(in_range[0])
        scaled = (im - torch.tensor(float(in_range[0]), dtype=im.dtype, device=im.device)) / (
            torch.tensor(width if width != 0 else 1.0, dtype=im.dtype, device=im.device))
    if tuple(out_range) == (0.0, 1.0):
        return scaled
    span = float(out_range[1]) - float(out_range[0])
    return scaled * torch.tensor(span, dtype=im.dtype, device=im.device) + torch.tensor(
        float(out_range[0]), dtype=im.dtype, device=im.device)


def _unravel(flat_idx: torch.Tensor, shape) -> torch.Tensor:
    """(B,) flat indices -> (B, ndim) float32 coordinates."""
    coords = []
    rem = flat_idx
    for s in reversed(shape):
        coords.append(rem % s)
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(coords[::-1], -1).to(torch.float32)


def _upsampled_dft(data: torch.Tensor, upsampled_region_size: int, upsample_factor: int,
                   axis_offsets: torch.Tensor) -> torch.Tensor:
    """Matrix DFT of each item over an upsampled region (Guizar-Sicairos
    2008): (B, *shape) complex, (B, ndim) offsets -> (B, R, ..., R).

    One axis at a time, last to first, each a batched matmul with a small
    DFT kernel that prepends the upsampled axis."""
    B = data.shape[0]
    ndim = data.dim() - 1
    orig_shape = tuple(data.shape[1:])
    R = upsampled_region_size
    dev = data.device
    offsets = axis_offsets.to(torch.float64)
    for ax in range(ndim - 1, -1, -1):
        n = orig_shape[ax]
        freqs = torch.fft.fftfreq(n, d=upsample_factor, dtype=torch.float64, device=dev)
        arg = (torch.arange(R, dtype=torch.float64, device=dev)[None, :, None]
               - offsets[:, ax, None, None]) * freqs[None, None, :]
        kernel = torch.polar(torch.ones_like(arg), -2 * math.pi * arg).to(torch.complex64)
        rest = tuple(data.shape[1:-1])
        flat = data.reshape(B, -1, n)
        data = torch.bmm(kernel, flat.transpose(1, 2)).reshape((B, R) + rest)
    return data


def phase_cross_correlation(reference_image, moving_image, upsample_factor: int = 1,
                            normalization="phase"):
    """Subpixel shift registering ``moving_image`` to ``reference_image``:
    ((ndim,) shift, peak magnitude). See :func:`phase_cross_correlation_batch`."""
    shift, peak = phase_cross_correlation_batch(
        reference_image[None], moving_image[None], upsample_factor, normalization
    )
    return shift[0], peak[0]


def phase_cross_correlation_batch(reference, moving, upsample_factor: int = 1,
                                  normalization="phase"):
    """Subpixel shifts registering each moving image to its reference,
    (B, *shape) each: returns ((B, ndim) shifts, (B,) peak magnitudes), with
    skimage's semantics (wrap-around by the midpoint, ``round(shift*u)/u``
    seeding, a ceil(1.5u)-sized upsampled DFT)."""
    ndim = reference.dim() - 1
    shape = tuple(reference.shape[1:])
    axes = _axes(ndim)
    B = reference.shape[0]
    src_freq = torch.fft.fftn(reference.to(torch.complex64), dim=axes)
    target_freq = torch.fft.fftn(moving.to(torch.complex64), dim=axes)
    image_product = src_freq * torch.conj(target_freq)
    if normalization == "phase":
        image_product = image_product / torch.clamp_min(torch.abs(image_product), 100 * EPS32)
    elif normalization is not None:
        raise ValueError(normalization)
    abs_cc = torch.abs(torch.fft.ifftn(image_product, dim=axes))
    flat_idx = abs_cc.reshape(B, -1).argmax(-1)
    maxima = _unravel(flat_idx, shape)
    shape_arr = torch.tensor(shape, dtype=torch.float32, device=reference.device)
    midpoint = torch.tensor([np.fix(s / 2) for s in shape], dtype=torch.float32,
                            device=reference.device)
    shift = torch.where(maxima > midpoint, maxima - shape_arr, maxima)
    if upsample_factor == 1:
        return shift, abs_cc.reshape(B, -1).gather(1, flat_idx[:, None])[:, 0]

    shift = torch.round(shift * upsample_factor) / upsample_factor
    R = int(math.ceil(upsample_factor * 1.5))
    dftshift = float(np.fix(R / 2.0))
    sample_region_offset = dftshift - shift * upsample_factor
    with full_f32():
        cc_up = torch.conj(_upsampled_dft(torch.conj(image_product), R, upsample_factor,
                                          sample_region_offset))
    abs_up = torch.abs(cc_up).reshape(B, -1)
    flat_up = abs_up.argmax(-1)
    maxima_up = _unravel(flat_up, (R,) * ndim) - dftshift
    shift = shift + maxima_up / upsample_factor
    return shift, abs_up.gather(1, flat_up[:, None])[:, 0]


def _next_even(n: int) -> int:
    return n + (n % 2)


def masked_phase_cross_correlation(reference_image, moving_image, reference_mask, moving_mask,
                                   overlap_ratio: float = 0.3):
    """Shift of one pair by masked NCC: ((ndim,) shift, peak NCC value). See
    :func:`masked_phase_cross_correlation_batch`."""
    shift, peak = masked_phase_cross_correlation_batch(
        reference_image[None], moving_image[None], reference_mask[None], moving_mask[None],
        overlap_ratio,
    )
    return shift[0], peak[0]


def masked_phase_cross_correlation_batch(reference, moving, reference_mask, moving_mask,
                                         overlap_ratio: float = 0.3):
    """Shifts by masked NCC over the full correlation surface (masks True on
    valid pixels), (B, *shape) each: ((B, ndim) shifts, (B,) peak NCC
    values)."""
    ndim = reference.dim() - 1
    axes = _axes(ndim)
    B = reference.shape[0]
    dev = reference.device
    m1 = reference_mask.to(reference.dtype)
    m2 = moving_mask.to(reference.dtype)
    fixed = torch.where(m1 > 0, reference, 0.0)
    moving = torch.where(m2 > 0, moving, 0.0)
    # the moving image and mask turned by 180 degrees: correlation becomes
    # convolution
    moving_r = torch.flip(moving, axes)
    m2_r = torch.flip(m2, axes)
    s1, s2 = tuple(reference.shape[1:]), tuple(moving.shape[1:])
    full_shape = tuple(_next_even(a + b - 1) for a, b in zip(s1, s2))

    def fft(x):
        return torch.fft.rfftn(x, s=full_shape, dim=axes)

    def ifft(X):
        return torch.fft.irfftn(X, s=full_shape, dim=axes)

    F1, M1, F2r, M2r = fft(fixed), fft(m1), fft(moving_r), fft(m2_r)
    n_overlap = torch.clamp_min(torch.round(ifft(M2r * M1)), EPS32)
    corr_f1_m2 = ifft(F1 * M2r)
    corr_f2_m1 = ifft(F2r * M1)
    numerator = ifft(F1 * F2r) - corr_f1_m2 * corr_f2_m1 / n_overlap
    denom1 = ifft(fft(fixed * fixed) * M2r) - corr_f1_m2 * corr_f1_m2 / n_overlap
    denom2 = ifft(fft(moving_r * moving_r) * M1) - corr_f2_m1 * corr_f2_m1 / n_overlap
    denom = torch.sqrt(torch.clamp_min(denom1, 0) * torch.clamp_min(denom2, 0))
    tol = _per_item(1e3 * EPS32 * torch.abs(denom).amax(axes), ndim)
    xcorr = torch.where(denom > tol, numerator / torch.maximum(denom, tol), 0.0)
    xcorr = torch.clamp(xcorr, -1.0, 1.0)
    # shifts with too little mask overlap are discarded
    min_overlap = _per_item(torch.clamp_min(overlap_ratio * n_overlap.amax(axes), 1.0), ndim)
    xcorr = torch.where(n_overlap >= min_overlap, xcorr, 0.0)
    # the 'full'-mode region s1 + s2 - 1 (padded to even above)
    valid = torch.ones(full_shape, dtype=torch.bool, device=dev)
    for ax in range(ndim):
        idx = torch.arange(full_shape[ax], device=dev) < s1[ax] + s2[ax] - 1
        valid = valid & idx.reshape((1,) * ax + (-1,) + (1,) * (ndim - ax - 1))
    xcorr_valid = torch.where(valid, xcorr, -torch.inf).reshape(B, -1)
    flat_idx = xcorr_valid.argmax(-1)
    maxima = _unravel(flat_idx, full_shape)
    shift = maxima - torch.tensor(s1, dtype=torch.float32, device=dev) + 1
    return shift, xcorr_valid.gather(1, flat_idx[:, None])[:, 0]
