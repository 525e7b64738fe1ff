"""Candidate scoring of the batched pairwise registration on the card.

``score_candidates(im0, im1, t_candidates, cand_valid, region_mode)`` scores
each candidate shift ``t_candidates`` (B, C, ndim) of a bucket of pairs of
crops (B, *shape), NaN outside their data, as
``registration._pcc_register_core_batch`` ranks them: the moving crop at the
shift, the joint validity mask, the box (the union of the two crops' valid
boxes, or their intersection where either holds NaN or ``region_mode`` says
"intersection"), and the SSIM mean over the box's interior at window 7, 5 or 3
as the box admits; -1 where no window fits or the shifted crop holds nothing
above its minimum in the box, -inf where the joint mask covers under a tenth
of the moving crop's valid pixels or ``cand_valid`` is False. Returns the
(B, C) table of scores. ``shift_winners(im0, im1, t_best, region_mode)`` gives
each pair's moving crop at its shift ``t_best`` (B, ndim) with its joint mask,
whether that covers a tenth of the moving crop, and the shifted crop's maximum
in the box: what the Spearman link quality reads.

For CUDA tensors both launch the hand-written CUDA C++ kernel of
``csrc/candidate_scoring.cu`` (built for sm_90a at first use) or raise, one
launch a call, counted in ``score_candidates.launches``; CPU tensors take the
plain PyTorch versions :func:`score_candidates_plain` and
:func:`shift_winners_plain`. The kernel replaces no Pallas kernel: the JAX
package scores its candidates with jnp ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from multiview_stitcher_torch.ops import _build
from multiview_stitcher_torch.ops import image_metrics as im_metrics
from multiview_stitcher_torch.ops import phase_correlation as pc_ops
from multiview_stitcher_torch.ops import resample as resample_ops

# the plain version scores (pair, candidate) items in groups whose float32
# image temporaries hold at most this many bytes each
SCORE_BYTES = 1 << 30

# region modes of csrc/candidate_scoring.cu
_REGION_AUTO, _REGION_UNION, _REGION_INTERSECTION = 0, 1, 2


def _region_code(region_mode: Optional[str]) -> int:
    if region_mode is None:
        return _REGION_AUTO
    return _REGION_INTERSECTION if region_mode == "intersection" else _REGION_UNION


def _translate(im1_filled, im1_mask, t):
    """Each item's moving image at a pure shift ``t`` (N, ndim), NaN where
    the shifted image does not reach."""
    ndim = t.shape[1]
    shape = tuple(im1_filled.shape[1:])
    ones = torch.ones(ndim, dtype=torch.float32, device=t.device)
    data_t = resample_ops.separable_axis_aligned_resample(im1_filled, ones, t, shape, cval=np.nan)
    mask_t = resample_ops.separable_axis_aligned_resample(im1_mask, ones, t, shape, cval=0.0)
    return torch.where(mask_t >= 1.0 - 1e-4, data_t, torch.nan)


def _candidate_stats(im1t, im0nm, valid_pixels1, use_intersection, lo0, hi0):
    """Per item: the joint validity mask, whether it covers at least a tenth
    of the moving image, the scoring box and the moving image's maximum in
    it."""
    ndim = im1t.dim() - 1
    shape = tuple(im1t.shape[1:])
    valid1 = ~torch.isnan(im1t)
    mask = valid1 & ~im0nm
    mask_sum = mask.reshape(mask.shape[0], -1).sum(-1)
    frac_ok = (mask_sum > 0) & (
        mask_sum.to(torch.float32) / torch.clamp_min(valid_pixels1.to(torch.float32), 1.0) >= 0.1
    )
    lo1, hi1 = im_metrics._bbox_bounds_from_mask(valid1, ndim)
    ui = use_intersection[:, None]
    lo = torch.where(ui, torch.maximum(lo0, lo1), torch.minimum(lo0, lo1))
    hi = torch.where(ui, torch.minimum(hi0, hi1), torch.maximum(hi0, hi1))
    box = im_metrics._box_mask(shape, lo, hi)
    box_max = torch.where(box, torch.nan_to_num(im1t, nan=-torch.inf), -torch.inf)
    return mask, frac_ok, lo, hi, box_max.reshape(box_max.shape[0], -1).amax(-1)


def _pair_terms(im0, im1, region_mode):
    """What scoring reads of each pair besides its shifts: the fixed crop's
    NaN mask and valid box, the moving crop's valid pixel count, filled
    values and mask, and whether the box is the intersection."""
    B = im0.shape[0]
    ndim = im0.dim() - 1
    im0nm = torch.isnan(im0)
    im1nm = torch.isnan(im1)
    if region_mode is None:
        use_intersection = im0nm.reshape(B, -1).any(-1) | im1nm.reshape(B, -1).any(-1)
    else:
        use_intersection = torch.full((B,), region_mode == "intersection", device=im0.device)
    valid_pixels1 = (~im1nm).reshape(B, -1).sum(-1)
    lo0, hi0 = im_metrics._bbox_bounds_from_mask(~im0nm, ndim)
    return (im0nm, use_intersection, valid_pixels1, lo0, hi0, torch.nan_to_num(im1),
            (~im1nm).to(torch.float32))


def score_candidates_plain(im0: torch.Tensor, im1: torch.Tensor, t_candidates: torch.Tensor,
                           cand_valid: torch.Tensor, region_mode: Optional[str] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_candidates`, on any device: the
    kept (pair, candidate) items shifted, counted and scored in groups within
    :data:`SCORE_BYTES`, the fixed crops' filter maps made once a window."""
    B = im0.shape[0]
    ndim = im0.dim() - 1
    shape = tuple(im0.shape[1:])
    dev = im0.device
    im0nm, use_intersection, valid_pixels1, lo0, hi0, im1_filled, im1_mask = _pair_terms(
        im0, im1, region_mode)
    data_range = torch.fmax(pc_ops.nanmax(im0), pc_ops.nanmax(im1)) - torch.fmin(
        pc_ops.nanmin(im0), pc_ops.nanmin(im1)
    )
    im1_min = pc_ops.nanmin(im1)
    im0f = torch.nan_to_num(im0)

    pair_idx, cand_idx = torch.nonzero(cand_valid, as_tuple=True)
    ssim_vals = torch.full((B, t_candidates.shape[1]), -torch.inf, device=dev)
    fixed_maps: dict = {}
    group = max(1, SCORE_BYTES // (4 * int(np.prod(shape))))
    for g0 in range(0, len(pair_idx), group):
        pi, ci = pair_idx[g0:g0 + group], cand_idx[g0:g0 + group]
        t = t_candidates[pi, ci]
        im1t = _translate(im1_filled[pi], im1_mask[pi], t)
        _, frac_ok, lo, hi, box_max = _candidate_stats(
            im1t, im0nm[pi], valid_pixels1[pi], use_intersection[pi], lo0[pi], hi0[pi]
        )
        min_shape = (hi - lo + 1).amin(-1)
        win_eff = torch.clamp_max(min_shape - torch.remainder(min_shape - 1, 2), 7)
        win = torch.where(win_eff >= 7, 7, torch.where(win_eff >= 5, 5, 3))
        score = torch.full((len(pi),), -1.0, device=dev)
        im1tf = torch.nan_to_num(im1t)
        del im1t
        for w in (3, 5, 7):
            k = torch.nonzero((win == w) & (win_eff >= 3)).reshape(-1)
            if not len(k):
                continue
            if w not in fixed_maps:
                fixed_maps[w] = im_metrics.ssim_fixed_maps(im0f, w, ndim)
            ux, uxx = fixed_maps[w]
            pk = pi[k]
            score[k] = im_metrics.ssim_mean_over_box_precomputed(
                im0f[pk], ux[pk], uxx[pk], im1tf[k], lo[k], hi[k], w, data_range[pk], ndim
            )
        score = torch.where((win_eff < 3) | (box_max <= im1_min[pi]), -1.0, score)
        ssim_vals[pi, ci] = torch.where(frac_ok, score, -torch.inf)
    return ssim_vals


def shift_winners_plain(im0: torch.Tensor, im1: torch.Tensor, t_best: torch.Tensor,
                        region_mode: Optional[str] = None):
    """Plain PyTorch version of :func:`shift_winners`, on any device."""
    im0nm, use_intersection, valid_pixels1, lo0, hi0, im1_filled, im1_mask = _pair_terms(
        im0, im1, region_mode)
    im1t = _translate(im1_filled, im1_mask, t_best)
    mask, frac_ok, _, _, box_max = _candidate_stats(
        im1t, im0nm, valid_pixels1, use_intersection, lo0, hi0
    )
    return im1t, mask, frac_ok, box_max


def _check(im0: torch.Tensor, im1: torch.Tensor, shifts: torch.Tensor, n_shift_dims: int,
           keep: Optional[torch.Tensor] = None) -> None:
    """What the kernel takes: float32 crops (B, *shape) of 2 or 3 dims, equal
    in shape, on one CUDA device with the float32 shifts (B, C, ndim) (or
    (B, ndim)) and the boolean ``keep`` (B, C)."""
    ndim = im0.dim() - 1
    if ndim not in (2, 3):
        raise ValueError(f"the kernel takes 2D or 3D crops, got crops of shape {tuple(im0.shape)}")
    if im1.shape != im0.shape:
        raise ValueError(f"fixed and moving crops differ in shape: {tuple(im0.shape)}, "
                         f"{tuple(im1.shape)}")
    if im0.dtype != torch.float32 or im1.dtype != torch.float32 or shifts.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 crops and shifts, got {im0.dtype}, "
                         f"{im1.dtype}, {shifts.dtype}")
    if shifts.dim() != n_shift_dims or shifts.shape[0] != im0.shape[0] or shifts.shape[-1] != ndim:
        raise ValueError(f"shifts of shape {tuple(shifts.shape)} do not fit crops of shape "
                         f"{tuple(im0.shape)}")
    if keep is not None and (keep.dtype != torch.bool or keep.shape != shifts.shape[:2]):
        raise ValueError(f"cand_valid must be boolean of shape {tuple(shifts.shape[:2])}")
    tensors = [im0, im1, shifts] + ([keep] if keep is not None else [])
    if any(x.device != im0.device for x in tensors):
        raise ValueError("crops, shifts and cand_valid must lie on one device")
    n = int(np.prod(im0.shape[1:]))
    if not 0 < n < 2**31:
        raise ValueError(
            f"the kernel takes crops of 1 to 2^31 - 1 pixels, got {tuple(im0.shape[1:])}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("candidate_scoring")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mvs_score_candidates.argtypes = [I, P, P, P, P, I, I, I, I, I, I, P, P]
    lib.mvs_score_candidates.restype = I
    lib.mvs_shift_winners.argtypes = [I, P, P, P, I, I, I, I, I, P, P, P, P]
    lib.mvs_shift_winners.restype = I
    return lib


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for another device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"crops must lie on the CPU or a CUDA device, got {x.device}")
    return True


def _zyx(im0: torch.Tensor) -> tuple:
    return (1,) * (4 - im0.dim()) + tuple(im0.shape[1:])


def score_candidates(im0: torch.Tensor, im1: torch.Tensor, t_candidates: torch.Tensor,
                     cand_valid: torch.Tensor, region_mode: Optional[str] = None
                     ) -> torch.Tensor:
    """The (B, C) SSIM scores of the candidate shifts ``t_candidates``
    (B, C, ndim) of the moving crops ``im1`` against the fixed crops ``im0``
    (B, *shape, NaN outside their data); -inf where ``cand_valid`` is False
    or the candidate keeps under a tenth of the moving crop. A CPU tensor
    takes :func:`score_candidates_plain`; a CUDA tensor the kernel."""
    if not _on_cuda(im0):
        return score_candidates_plain(im0, im1, t_candidates, cand_valid, region_mode)
    _check(im0, im1, t_candidates, 3, cand_valid)
    im0, im1 = im0.contiguous(), im1.contiguous()
    t_candidates, cand_valid = t_candidates.contiguous(), cand_valid.contiguous()
    B, C = cand_valid.shape
    scores = torch.empty((B, C), dtype=torch.float32, device=im0.device)
    if scores.numel() == 0:
        return scores
    lib = _library()
    with torch.cuda.device(im0.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.mvs_score_candidates(
            im0.dim() - 1, im0.data_ptr(), im1.data_ptr(), t_candidates.data_ptr(),
            cand_valid.data_ptr(), B, C, *_zyx(im0), _region_code(region_mode),
            scores.data_ptr(), stream,
        )
    _build.check(lib, rc, "score_candidates")
    score_candidates.launches += 1
    return scores


score_candidates.launches = 0


def shift_winners(im0: torch.Tensor, im1: torch.Tensor, t_best: torch.Tensor,
                  region_mode: Optional[str] = None):
    """Each pair's moving crop at its shift ``t_best`` (B, ndim), NaN where it
    does not reach, with the joint validity mask, whether that covers a
    tenth of the moving crop's valid pixels, and the shifted crop's maximum
    in the scoring box. A CPU tensor takes :func:`shift_winners_plain`; a
    CUDA tensor the kernel (its launches count in
    ``score_candidates.launches``)."""
    if not _on_cuda(im0):
        return shift_winners_plain(im0, im1, t_best, region_mode)
    _check(im0, im1, t_best, 2)
    im0, im1, t_best = im0.contiguous(), im1.contiguous(), t_best.contiguous()
    B = im0.shape[0]
    dev = im0.device
    img = torch.empty(im0.shape, dtype=torch.float32, device=dev)
    mask = torch.empty(im0.shape, dtype=torch.bool, device=dev)
    frac_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    box_max = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return img, mask, frac_ok, box_max
    lib = _library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.mvs_shift_winners(
            im0.dim() - 1, im0.data_ptr(), im1.data_ptr(), t_best.data_ptr(), B, *_zyx(im0),
            _region_code(region_mode), img.data_ptr(), mask.data_ptr(), frac_ok.data_ptr(),
            box_max.data_ptr(), stream,
        )
    _build.check(lib, rc, "shift_winners")
    score_candidates.launches += 1
    return img, mask, frac_ok, box_max
