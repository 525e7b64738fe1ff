"""Multi-view deconvolution fusion (Preibisch et al. 2014) on torch.

The port of ``multiview_stitcher_tpu.fusion.mv_deconv``: efficient
Bayesian multi-view Richardson-Lucy deconvolution with the four compound
back-projection kernels, Gaussian PSFs given or estimated from the optics,
sequential per-view updates gated by the blending weights, Tikhonov
regularisation and an erosion of the sample's boundary.

The PSFs and compound kernels are tiny and made on the host (numpy, scipy).
The update loop runs as torch ops on the device of the views: each
convolution is one ``conv2d`` with the kernel flipped (scipy's ``convolve``)
over a copy padded as scipy's ``mirror`` or with a constant, at full float32
precision (TF32 off). It plugs into
:func:`~multiview_stitcher_torch.fusion.fuse` as a ``fusion_func``, through
the host tier, and declares the PSF's half-width as its chunk halo.

Reference: Preibisch et al., Nature Methods 11, 645-648 (2014).
"""

from __future__ import annotations

import functools
from enum import Enum
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import convolve as _scipy_convolve
from scipy.ndimage import gaussian_filter as _scipy_gaussian_filter

from multiview_stitcher_torch.ops.filters import _pad_axis
from multiview_stitcher_torch.utils import misc as misc_utils

_CONVS = {1: F.conv1d, 2: F.conv2d}


class PSFType(str, Enum):
    """Compound back-projection kernel variants (Preibisch 2014 suppl.)."""

    EFFICIENT_BAYESIAN = "EFFICIENT_BAYESIAN"
    OPTIMIZATION_I = "OPTIMIZATION_I"
    OPTIMIZATION_II = "OPTIMIZATION_II"
    INDEPENDENT = "INDEPENDENT"


def _flip(kernel):
    return np.flip(kernel)


def _norm(kernel):
    kernel = kernel.astype(np.float64)
    s = kernel.sum()
    if s > 0:
        kernel = kernel / s
    return kernel.astype(np.float32)


def make_gaussian_psf(sigma, ndim: Optional[int] = None, shape=None):
    """Normalised (an)isotropic Gaussian PSF; shape defaults to ceil(6σ)|1."""
    sigma = np.atleast_1d(sigma)
    if sigma.size == 1 and ndim is not None:
        sigma = np.full(ndim, float(sigma[0]))
    if shape is None:
        shape = tuple(int(np.ceil(6.0 * s)) | 1 for s in sigma)
    psf = np.zeros(shape, dtype=np.float32)
    psf[tuple(s // 2 for s in shape)] = 1.0
    psf = _scipy_gaussian_filter(psf, sigma=sigma.tolist())
    return _norm(psf)


def estimate_psf(spacing: dict, na: float = 0.8, wavelength_um: float = 0.5):
    """Gaussian PSF from objective parameters: σ_lat≈0.5λ/NA, σ_ax≈2λ/NA²."""
    sigma_lateral = 0.5 * wavelength_um / na
    sigma_axial = 2.0 * wavelength_um / (na**2)
    sigma_px = []
    for dim, sp in spacing.items():
        if dim == "z":
            sigma_px.append(max(0.5, sigma_axial / float(sp)))
        else:
            sigma_px.append(max(0.5, sigma_lateral / float(sp)))
    return make_gaussian_psf(sigma_px)


def _compute_compound_kernel(v_idx: int, psfs: List[np.ndarray], psf_type):
    """Back-projection kernel of view ``v_idx`` (host, float64 products)."""
    n_views = len(psfs)
    psf_type = psf_type.value if isinstance(psf_type, PSFType) else str(psf_type)
    psf_v = psfs[v_idx].astype(np.float64)

    if n_views == 1 or psf_type == PSFType.INDEPENDENT:
        return _norm(_flip(psf_v))
    if psf_type == PSFType.OPTIMIZATION_II:
        return _norm(_flip(psf_v**n_views))
    if psf_type == PSFType.OPTIMIZATION_I:
        tmp = psf_v.copy()
        psf_v_flip = _flip(psf_v)
        for w_idx, psf_w in enumerate(psfs):
            if w_idx == v_idx:
                continue
            conv = _scipy_convolve(psf_v_flip, psf_w.astype(np.float64), mode="constant", cval=0.0)
            tmp = tmp * conv
        return _norm(_flip(tmp))

    # EFFICIENT_BAYESIAN
    psf_v_flip = _flip(psf_v)
    tmp = psf_v_flip.copy()
    for w_idx, psf_w in enumerate(psfs):
        if w_idx == v_idx:
            continue
        psf_w_d = psf_w.astype(np.float64)
        conv1 = _scipy_convolve(psf_v_flip, psf_w_d, mode="constant", cval=0.0)
        conv2 = _scipy_convolve(conv1, _flip(psf_w_d), mode="constant", cval=0.0)
        tmp = tmp * conv2
    return _norm(tmp)


@functools.lru_cache(maxsize=32)
def _compound_kernels_cached(key, psf_type: str):
    psfs = [np.frombuffer(b, dtype=np.float32).reshape(shape) for shape, b in key]
    return tuple(_compute_compound_kernel(v, psfs, psf_type) for v in range(len(psfs)))


def _compound_kernels(psfs: List[np.ndarray], psf_type) -> tuple:
    """Every view's back-projection kernel, kept for the last 32 sets of
    PSFs and type: a fused output's chunks share them, and the
    EFFICIENT_BAYESIAN kernels of four 9^3 PSFs take 24 scipy convolutions
    on the host."""
    psf_type = psf_type.value if isinstance(psf_type, PSFType) else str(psf_type)
    key = tuple((p.shape, np.ascontiguousarray(p, dtype=np.float32).tobytes()) for p in psfs)
    return _compound_kernels_cached(key, psf_type)


def _jconvolve(arr: torch.Tensor, kernel: torch.Tensor, mode: str, cval: float = 0.0):
    """scipy.ndimage.convolve of ``arr`` with an odd ``kernel`` in ``mode``
    "mirror" or "constant": the padded copy correlated with the flipped
    kernel. Pads may be as long as the axis (numpy's ``reflect`` repeats).

    In 3D the kernel's z taps are the input channels of one ``conv2d`` over
    the stack of z-shifted planes: the same sums as a single-channel
    ``conv3d``, which cuDNN computes several times slower (``chip_smoke.py``
    times both)."""
    ndim = arr.dim()
    if mode not in ("mirror", "constant"):
        raise ValueError(mode)
    padded = arr
    for ax, k in enumerate(kernel.shape):
        r = (k - 1) // 2
        padded = _pad_axis(padded, ax, r, k - 1 - r, mode, cval)
    kern = torch.flip(kernel, dims=tuple(range(ndim)))
    with misc_utils.full_f32():
        if ndim == 3:
            # (z, kz, y, x): plane z + kz of the padded copy at [z, kz]
            taps = padded.unfold(0, kernel.shape[0], 1).permute(0, 3, 1, 2)
            return F.conv2d(taps, kern[None])[:, 0]
        out = _CONVS[ndim](padded[None, None], kern[None, None])
    return out[0, 0]


def _rl_iterations(psi0, observed, view_coverage, blending_weights, kernels1, kernels2,
                   max_intensity: torch.Tensor, n_iterations: int, lambda_reg: float,
                   min_value: float):
    """The Richardson-Lucy updates, view after view in each iteration.
    ``max_intensity`` is a float32 scalar tensor on the views' device."""
    psi = psi0
    if lambda_reg > 0:
        # max_intensity / lambda_reg as the reference's compiled step has it:
        # the float32 reciprocal of lambda_reg times max_intensity, in float32
        tikhonov_scale = float(
            np.float32(max_intensity.item()) * (np.float32(1.0) / np.float32(lambda_reg))
        )
    for _ in range(n_iterations):
        for v in range(observed.shape[0]):
            blurred = _jconvolve(psi, kernels1[v], mode="mirror")
            ratio = torch.where(
                view_coverage[v], observed[v] / torch.clamp_min(blurred, min_value), 1.0
            )
            weighted_ratio = 1.0 + blending_weights[v] * (ratio - 1.0)
            integral = _jconvolve(weighted_ratio, kernels2[v], mode="constant", cval=1.0)
            value = psi * integral
            if lambda_reg > 0:
                x = torch.clamp_min(value, 0.0) / max_intensity
                # a correctly rounded float32 square root (torch's
                # vectorised CPU one is not)
                root = torch.sqrt((1.0 + 2.0 * lambda_reg * x).double()).float()
                adjusted = (root - 1.0) * tikhonov_scale
            else:
                adjusted = value
            psi = torch.where(
                torch.isnan(adjusted), min_value, torch.clamp_min(adjusted, min_value)
            )
    return psi


def _erode(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """scipy's ``binary_erosion`` with its default cross and
    ``border_value=1``, ``iterations`` times: a voxel stays where it and
    its two neighbours along every axis are set (outside counts as set)."""
    for _ in range(iterations):
        out = mask.clone()
        for ax in range(mask.dim()):
            n = mask.shape[ax]
            p = _pad_axis(mask, ax, 1, 1, "constant", True)
            out &= p.narrow(ax, 0, n) & p.narrow(ax, 2, n)
        mask = out
    return mask


def multi_view_deconvolution(
    transformed_views,
    blending_weights,
    psfs: Optional[List[np.ndarray]] = None,
    psf_type=PSFType.EFFICIENT_BAYESIAN,
    n_iterations: int = 10,
    lambda_reg: float = 0.0,
    min_value: float = 1e-4,
    output_spacing: Optional[dict] = None,
    na: float = 0.8,
    wavelength_um: float = 0.5,
    sample_boundary_erosion_px: int = 0,
    device=None,
):
    """Richardson-Lucy multi-view deconvolution fusion.

    Sequential per-view multiplicative updates with blending-weight-gated
    corrections; pass it as ``fusion_func`` to ``fuse``. Tensors stay on
    their device and come back as a tensor of their dtype; numpy arrays run
    on ``device`` (the CUDA device unless the caller names another) and come
    back as numpy of their dtype.
    """
    as_numpy = not isinstance(transformed_views, torch.Tensor)
    if as_numpy:
        input_dtype = np.asarray(transformed_views).dtype
        dev = misc_utils.resolve_device(device)
        tv = torch.from_numpy(np.asarray(transformed_views, dtype=np.float32)).to(dev)
    else:
        input_dtype = transformed_views.dtype
        dev = transformed_views.device
        tv = transformed_views.to(torch.float32)
    if isinstance(blending_weights, torch.Tensor):
        bw = blending_weights.to(device=dev, dtype=torch.float32)
    else:
        bw = torch.from_numpy(np.asarray(blending_weights, dtype=np.float32)).to(dev)
    n_views = tv.shape[0]
    ndim = tv.dim() - 1

    view_coverage = ~torch.isnan(tv)
    observed = torch.nan_to_num(tv, nan=0.0)

    if psfs is None:
        psf0 = (
            estimate_psf(output_spacing, na=na, wavelength_um=wavelength_um)
            if output_spacing is not None
            else make_gaussian_psf(1.5, ndim=ndim)
        )
        psfs_cpu = [psf0] * n_views
    else:
        if len(psfs) != n_views:
            raise ValueError(f"len(psfs) = {len(psfs)} but n_views = {n_views}.")
        psfs_cpu = [_norm(np.asarray(p, dtype=np.float32)) for p in psfs]

    # pad PSFs to a common (odd) shape
    max_shape = tuple(max(p.shape[d] for p in psfs_cpu) for d in range(ndim))
    padded = []
    for p in psfs_cpu:
        if p.shape != max_shape:
            pw = [((t - a) // 2, (t - a) - (t - a) // 2) for a, t in zip(p.shape, max_shape)]
            p = np.pad(p, pw, mode="constant")
        padded.append(_norm(p))
    psfs_cpu = padded

    def on_device(k):
        return torch.tensor(k, device=dev)  # a copy: the compound kernels are cached

    kernels1 = [on_device(p) for p in psfs_cpu]
    kernels2 = [on_device(k) for k in _compound_kernels(psfs_cpu, psf_type)]

    psi0 = torch.nansum(observed * bw, dim=0).clamp_min(min_value)
    max_intensity = float(psi0.max())
    if max_intensity <= 0:
        max_intensity = 1.0
    # a tensor, not a Python number: CUDA divides by a host scalar as a
    # multiplication by its reciprocal
    max_intensity = torch.tensor(max_intensity, dtype=torch.float32, device=dev)

    psi = _rl_iterations(
        psi0, observed, view_coverage, bw, kernels1, kernels2, max_intensity,
        int(n_iterations), float(lambda_reg), float(min_value),
    )

    if sample_boundary_erosion_px > 0:
        eroded = _erode(view_coverage.any(dim=0), int(sample_boundary_erosion_px))
        psi = torch.where(eroded, psi, 0.0)

    if as_numpy:
        return psi.cpu().numpy().astype(input_dtype)
    return psi.to(input_dtype)


def _required_overlap_for_deconvolution(func_kwargs):
    """The PSF's half-width as the chunk halo the planner must give."""
    kwargs = func_kwargs or {}
    output_spacing = kwargs.get("output_spacing")
    if output_spacing is not None:
        psf = estimate_psf(
            output_spacing, na=kwargs.get("na", 0.8), wavelength_um=kwargs.get("wavelength_um", 0.5)
        )
        psf_size = max(psf.shape)
    else:
        psf_size = int(np.ceil(6.0 * 1.5)) | 1
    return psf_size // 2


multi_view_deconvolution.required_overlap = _required_overlap_for_deconvolution
