"""Registration: the view graph, batched pairwise phase correlation and the
groupwise resolution of the views' transforms, on torch.

The port of ``multiview_stitcher_tpu.registration`` for its default path:
``register`` builds the view adjacency graph, prunes it, registers every
kept pair by phase correlation and resolves one transform per view
(``param_resolution``). Views may be multiscale msims: each pair registers at
``reg_res_level``, or at the coarsest level that the registration binning
allows, binned by what is left of it. Views with a ``t`` dim register each
timepoint on its own and resolve one transform per view and timepoint. The
pairwise work runs on the device in batches of (pair, timepoint) units
whose overlap windows share a shape: both crops are resampled into the
fixed view's pixel grid over the overlap, three shift proposals are made
(phase-normalised and plain phase correlation, masked NCC where NaN is
present), each expands into its 4^ndim sign and wrap candidates, and the
candidates are scored by SSIM over the union (or intersection) box, with the
Spearman correlation of the winner as the link quality. Crops come from the
host, or are cut on the device from a resident tile stack (the device tile
cache of ``residency``, which ``fuse`` reads too), so that ``stitch``
uploads each tile once: that serves views without ``t`` registered at level
0.

Any other pairwise function or kwargs registers pair by pair
(``register_pair_of_msims``), in the space the function's signature asks
for: marker point sets in world coordinates (``registration_marker_based``:
descriptor matching, RANSAC and ICP on the host), the overlap crops in
physical space (``registration_plugins``), or both crops resampled onto the
fixed view's pixel grid (``phase_correlation_registration`` with
``use_fused_core=False``, its step-by-step path on the device); or through
the caller's ``pairwise_executor``.

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
A device ``mesh`` (``parallel.mesh.Mesh``) of more than one entry splits
each batch of pairs into one part per entry, registered on its device.
``plot_summary`` draws the reference's summary figures
(``vis_utils.plot_registration_summaries``, which needs matplotlib).
"""

from __future__ import annotations

import itertools as it
import logging
import math
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multiview_stitcher_torch import (
    msi_utils,
    mv_graph,
    param_resolution,
    param_utils,
    residency,
    si_utils,
    transformation,
    transforms,
)
from multiview_stitcher_torch.msi_utils import Msim
from multiview_stitcher_torch.ops import candidate_scoring as cs_ops
from multiview_stitcher_torch.ops import image_metrics as im_metrics
from multiview_stitcher_torch.ops import phase_correlation as pc_ops
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.parallel import mesh as mesh_utils
from multiview_stitcher_torch.param_utils import XAffine
from multiview_stitcher_torch.si_utils import Sim
from multiview_stitcher_torch.utils import misc as misc_utils
from multiview_stitcher_torch.utils import profiling

logger = logging.getLogger(__name__)

# pairs registered in one batch (the reference's MAX_B)
MAX_B = 512

# what the last register() call did, by stage: host seconds of the graph,
# the pruning, the crop planning, the tile upload (or host crop reads) and
# the resolution; the pairwise batches' seconds on the host clock and, on
# CUDA, their device milliseconds; pairs, edges, (pair, timepoint) units,
# buckets and batches; the levels registered at; the bytes of tiles and of
# crops uploaded; the candidate-scoring kernel's launches (two a batch on
# CUDA, none on the CPU)
last_telemetry: dict = {}


# ---------------------------------------------------------------------------
# binning and overlap boxes
# ---------------------------------------------------------------------------


def get_optimal_registration_binning(sim1: Sim, sim2: Sim, max_total_pixels_per_stack=400**3,
                                     overlap_tolerance=None):
    """Per-dim binning factors that bring a pair's overlap stack under
    ``max_total_pixels_per_stack`` voxels: the finest effective spacing grows
    (y and x together, z alone) until the upper bound of the stack fits."""
    if overlap_tolerance is not None:
        raise NotImplementedError("overlap_tolerance")
    spatial_dims = si_utils.get_spatial_dims_from_sim(sim1)
    spacing = {
        d: min(si_utils.get_spacing_from_sim(s)[d] for s in (sim1, sim2)) for d in spatial_dims
    }
    extent = {d: max(sim1.sizes[d], sim2.sizes[d]) for d in spatial_dims}
    binning = {d: 1 for d in spatial_dims}
    while np.prod([extent[d] / binning[d] for d in spatial_dims]) >= max_total_pixels_per_stack:
        finest = min(spatial_dims, key=lambda d: spacing[d] * binning[d])
        for d in ["z"] if finest == "z" else ["y", "x"]:
            binning[d] += 1
    return binning


def _get_overlap_bboxes(sim1: Sim, sim2: Sim, input_transform_key=None,
                        output_transform_key=None, overlap_tolerance=None, geom_cache=None,
                        cache_keys=(None, None)):
    """Overlap box of two sims in world coordinates, projected into each
    sim's intrinsic frame (or kept in world coordinates). ``geom_cache``
    keeps each view's geometry across the edges it joins, under
    ``cache_keys``, which must tell apart every sim given under them."""
    tol_key = (
        tuple(sorted(overlap_tolerance.items()))
        if isinstance(overlap_tolerance, dict) else overlap_tolerance
    )

    def view_geometry(sim, key):
        # the caller's key names the view, timepoint, level and binning
        ck = (key, input_transform_key, tol_key)
        if geom_cache is not None and key is not None and ck in geom_cache:
            return geom_cache[ck]
        sp = si_utils.get_stack_properties_from_sim(sim, transform_key=input_transform_key)
        if overlap_tolerance is not None:
            sp = si_utils.extend_stack_props(sp, overlap_tolerance)
        aligned = mv_graph._is_axis_aligned(sp)
        aabb = mv_graph._world_aabb(sp) if aligned else None
        mat = np.asarray(si_utils.get_affine_from_sim(sim, input_transform_key).squeeze())
        if mat.ndim == 3:
            mat = mat[0]
        entry = (sp, aligned, aabb, np.linalg.inv(mat))
        if geom_cache is not None and key is not None:
            geom_cache[ck] = entry
        return entry

    geoms = [view_geometry(sim, key) for sim, key in zip([sim1, sim2], cache_keys)]
    if geoms[0][1] and geoms[1][1]:
        lower = np.maximum(geoms[0][2][0], geoms[1][2][0])
        upper = np.minimum(geoms[0][2][1], geoms[1][2][1])
        if np.any(upper < lower):
            raise mv_graph.NotEnoughOverlapError(
                "No overlap between views for pairwise registration."
            )
        vol = float(np.prod(upper - lower))
        intersection = mv_graph.BoxIntersection(lower, upper)
    else:
        vol, intersection = mv_graph.get_overlap_between_pair_of_stack_props(
            geoms[0][0], geoms[1][0]
        )
        if intersection is None:
            raise mv_graph.NotEnoughOverlapError(
                "No overlap between views for pairwise registration."
            )
    corners = np.asarray(intersection.intersections)
    if output_transform_key is None:
        corners_target_space = [param_utils.transform_pts(corners, g[3]) for g in geoms]
    elif output_transform_key == input_transform_key:
        corners_target_space = [corners, corners]
    else:
        raise NotImplementedError
    return {
        "lowers": [np.min(c, axis=0) for c in corners_target_space],
        "uppers": [np.max(c, axis=0) for c in corners_target_space],
        "intersection": intersection,
        "vol": vol,
    }


def _bin_sim(sim: Sim, binning: Dict[str, int], with_data: bool = True) -> Sim:
    """The sim binned by block means; ``with_data=False`` gives the binned
    sim's metadata over a zero-stride array of its shape (for callers that
    read no pixel of it)."""
    if max(binning.values()) <= 1:
        return sim
    factors = [binning.get(d, 1) for d in sim.dims]
    if with_data:
        data = msi_utils._coarsen_mean(sim.to_numpy(), factors)
    else:
        shape = tuple(s // f for s, f in zip(sim.data.shape, factors))
        data = np.broadcast_to(np.zeros((), dtype=sim.data.dtype), shape)
    spacing = si_utils.get_spacing_from_sim(sim)
    origin = si_utils.get_origin_from_sim(sim)
    out = si_utils.to_spatial_image(
        data,
        dims=sim.dims,
        scale={d: spacing[d] * binning.get(d, 1) for d in sim.spatial_dims},
        translation={
            d: origin[d] + (binning.get(d, 1) - 1) * spacing[d] / 2 for d in sim.spatial_dims
        },
    )
    out.transforms = {k: v.copy() for k, v in sim.transforms.items()}
    return out


def _spatial_range_slices(sim: Sim, ranges: Dict[str, Tuple[float, float]]) -> Dict[str, slice]:
    """Index slices selecting the pixel centres within [lo, hi] per dim."""
    indexers = {}
    for d, (lo, hi) in ranges.items():
        i0 = int(np.ceil((lo - sim.origin[d]) / sim.spacing[d] - 1e-12))
        i1 = int(np.floor((hi - sim.origin[d]) / sim.spacing[d] + 1e-12))
        indexers[d] = slice(max(0, i0), min(sim.sizes[d] - 1, i1) + 1)
    return indexers


def _select_and_crop_pair(msim1: Msim, msim2: Msim, transform_key, registration_binning=None,
                          reg_res_level=None, overlap_tolerance=None, bin_cache=None,
                          geom_cache=None, cache_keys=(None, None), with_data=True):
    """Level and binning choice and the overlap crop of one pair. The level
    is ``reg_res_level``, or the coarsest that ``registration_binning`` (by
    default :func:`get_optimal_registration_binning` of level 0) allows; the
    level is then binned by the binning divided by its own factor. Returns
    (sim1, sim2, the binned crops, lowers, uppers, overlap_tolerance,
    crop_info) with ``crop_info`` holding the crops' index slices, the binned
    full sims and the level, from which the device path cuts the same
    windows. ``cache_keys`` name the two views (and timepoint) for
    ``bin_cache`` and ``geom_cache``. With ``with_data=False`` the binned
    crops carry metadata only (see :func:`_bin_sim`)."""
    spatial_dims = msi_utils.get_spatial_dims(msim1)
    if overlap_tolerance is None:
        overlap_tolerance = {d: 0.0 for d in spatial_dims}
    elif isinstance(overlap_tolerance, (int, float)):
        overlap_tolerance = {d: float(overlap_tolerance) for d in spatial_dims}
    else:
        overlap_tolerance = {d: float(overlap_tolerance.get(d, 0.0)) for d in spatial_dims}

    sim1_0 = msi_utils.get_sim_from_msim(msim1, scale="scale0")
    if reg_res_level is not None:
        scale_key = f"scale{reg_res_level}"
        if scale_key not in msi_utils.get_sorted_scale_keys(msim1):
            raise ValueError(f"Resolution level {reg_res_level} does not exist.")
    else:
        if registration_binning is None:
            registration_binning = get_optimal_registration_binning(
                sim1_0, msi_utils.get_sim_from_msim(msim2, scale="scale0")
            )
        scale_key = msi_utils.get_res_level_from_binning_factors(msim1, registration_binning)
    sim1 = msi_utils.get_sim_from_msim(msim1, scale=scale_key)
    sim2 = msi_utils.get_sim_from_msim(msim2, scale=scale_key)
    # the level's own factor per dim
    actual = {d: int(round(sim1_0.sizes[d] / sim1.sizes[d])) for d in spatial_dims}
    if reg_res_level is None:
        registration_binning = {
            d: max(1, registration_binning.get(d, 1) // actual[d]) for d in spatial_dims
        }
    elif registration_binning is not None:
        for d in spatial_dims:
            if registration_binning.get(d, 1) % actual[d] != 0:
                raise ValueError(
                    f"Resolution level {reg_res_level} factor {actual[d]} does not divide "
                    f"registration_binning[{d}]"
                )
        registration_binning = {d: registration_binning[d] // actual[d] for d in spatial_dims}
    else:
        registration_binning = {d: 1 for d in spatial_dims}
    binning_key = tuple(sorted(registration_binning.items()))
    cache_keys = tuple(
        None if key is None else (key, scale_key, binning_key) for key in cache_keys
    )

    def bin_cached(sim, key):
        if bin_cache is None or key is None:
            return _bin_sim(sim, registration_binning, with_data)
        if key not in bin_cache:
            bin_cache[key] = _bin_sim(sim, registration_binning, with_data)
        return bin_cache[key]

    reg_sims_b = [bin_cached(sim, key) for sim, key in zip([sim1, sim2], cache_keys)]
    overlap = _get_overlap_bboxes(
        reg_sims_b[0], reg_sims_b[1], input_transform_key=transform_key,
        output_transform_key=None, overlap_tolerance=overlap_tolerance,
        geom_cache=geom_cache, cache_keys=cache_keys,
    )
    lowers, uppers = overlap["lowers"], overlap["uppers"]
    spacings = [si_utils.get_spacing_from_sim(s) for s in reg_sims_b]
    tol = 1e-6
    crop_slices = [
        _spatial_range_slices(
            sim,
            {
                d: (lowers[k][i] - tol - spacings[k][d], uppers[k][i] + tol + spacings[k][d])
                for i, d in enumerate(spatial_dims)
            },
        )
        for k, sim in enumerate(reg_sims_b)
    ]
    crop_info = {"slices": crop_slices, "full_sims": list(reg_sims_b), "scale_key": scale_key}
    reg_sims_b = [sim.isel(sl) for sim, sl in zip(reg_sims_b, crop_slices)]
    return sim1, sim2, reg_sims_b, lowers, uppers, overlap_tolerance, crop_info


# ---------------------------------------------------------------------------
# the pairwise core, batched over pairs
# ---------------------------------------------------------------------------


def link_quality_metric_func(im0, im1t, device=None):
    """Spearman's correlation of two overlap samples of equal shape (every
    pixel counts), in float32 on ``device``."""
    device = misc_utils.resolve_device(device)
    a = torch.as_tensor(np.asarray(im0, dtype=np.float32).reshape(-1), device=device)
    b = torch.as_tensor(np.asarray(im1t, dtype=np.float32).reshape(-1), device=device)
    mask = torch.ones(a.shape, dtype=torch.bool, device=device)
    return float(im_metrics.masked_spearman(a, b, mask, 1))


def _expand_candidates(proposals: torch.Tensor, proposal_valid: torch.Tensor, shape: tuple):
    """Each proposal (B, P, ndim) expanded per dim into {c, -c, S - c,
    -c - S} (only c where c is 0): the candidates (B, P 4^ndim, ndim) and
    which are kept (those of a valid proposal, below the largest crop extent
    on every dim)."""
    B, _, ndim = proposals.shape
    dev = proposals.device
    shape_arr = torch.tensor(shape, dtype=torch.float32, device=dev)
    alt_idx = torch.tensor(list(np.ndindex((4,) * ndim)), device=dev)  # (n_alt, ndim)
    c = proposals
    alts = torch.stack([c, -c, -(c - shape_arr), -c - shape_arr], 2)  # (B, P, 4, ndim)
    cands = alts[:, :, alt_idx, torch.arange(ndim, device=dev)[None, :]]  # (B, P, n_alt, ndim)
    oks = ((alt_idx == 0)[None, None] | (c != 0.0)[:, :, None, :]).all(-1)
    t_candidates = cands.reshape(B, -1, ndim)
    cand_valid = (oks & proposal_valid[:, :, None]).reshape(B, -1)
    cand_valid &= t_candidates.abs().amax(-1) < float(max(shape))
    return t_candidates, cand_valid


def _pcc_register_core_batch(im0_raw: torch.Tensor, im1_raw: torch.Tensor,
                             upsample_factor: int, region_mode: Optional[str] = None):
    """Phase-correlation registration of a batch of pairs (B, *shape) each,
    NaN outside their data: returns ((B, ndim) shifts, (B,) qualities).

    Per pair: intensity rescale; three proposals (phase-normalised and plain
    phase correlation, and masked NCC, which counts only where the pair holds
    NaN); each proposal expands per dim into {c, -c, S - c, -c - S} (only c
    where c is 0), kept below the largest crop extent; every kept candidate
    is scored by SSIM (window 7, 5 or 3 as the box admits) over the union of
    the two images' valid boxes, or their intersection where NaN is present;
    the first best wins, and its Spearman correlation is the quality.
    Candidates that cannot count (-inf in the reference) are not scored. The
    scoring and the winner's shift run in :mod:`ops.candidate_scoring`, one
    kernel launch each on the card."""
    B = im0_raw.shape[0]
    ndim = im0_raw.dim() - 1
    shape = tuple(im0_raw.shape[1:])
    dev = im0_raw.device
    im0 = pc_ops.rescale_intensity(im0_raw.to(torch.float32), ndim)
    im1 = pc_ops.rescale_intensity(im1_raw.to(torch.float32), ndim)
    im0nm = torch.isnan(im0)
    im1nm = torch.isnan(im1)
    has_nans = im0nm.reshape(B, -1).any(-1) | im1nm.reshape(B, -1).any(-1)
    im0nn = torch.nan_to_num(im0)
    im1nn = torch.nan_to_num(im1)

    shift_phase, _ = pc_ops.phase_cross_correlation_batch(im0nn, im1nn, upsample_factor, "phase")
    shift_plain, _ = pc_ops.phase_cross_correlation_batch(im0nn, im1nn, upsample_factor, None)
    # the masked proposal counts only for pairs that hold NaN: it is made
    # for those alone
    shift_masked = torch.zeros_like(shift_phase)
    sel = torch.nonzero(has_nans).reshape(-1)
    if len(sel):
        shift_masked[sel] = pc_ops.masked_phase_cross_correlation_batch(
            im0nn[sel], im1nn[sel], ~im0nm[sel], ~im1nm[sel]
        )[0]
    proposals = torch.stack([shift_phase, shift_plain, shift_masked], 1)  # (B, 3, ndim)
    proposal_valid = torch.tensor([True, True, False], device=dev)[None, :] | has_nans[:, None]
    t_candidates, cand_valid = _expand_candidates(proposals, proposal_valid, shape)

    ssim_vals = cs_ops.score_candidates(im0, im1, t_candidates, cand_valid, region_mode)
    best = ssim_vals.argmax(-1)
    any_valid = torch.isfinite(ssim_vals).any(-1)
    t_best = torch.where(
        any_valid[:, None], t_candidates[torch.arange(B, device=dev), best], 0.0
    )
    # the Spearman link quality of the winner
    im1t_best, mask_b, frac_ok_b, box_max_b = cs_ops.shift_winners(im0, im1, t_best, region_mode)
    quality = im_metrics.masked_spearman(im0, im1t_best - 1, mask_b, ndim)
    quality = torch.where((box_max_b <= pc_ops.nanmin(im1)) | ~frac_ok_b, -1.0, quality)
    quality = torch.where(any_valid, quality, torch.nan)
    return t_best, quality


def _resample_and_register_batch(f_crops, m_crops, fmats, foffs, mmats, moffs, out_shape: tuple,
                                 upsample_factor: int, region_mode: Optional[str] = None):
    """Both crops of each pair resampled into the fixed view's pixel grid of
    the overlap (linear, NaN outside), then registered."""
    im0 = resample_ops.affine_resample_batch(f_crops, fmats, foffs, out_shape, cval=np.nan)
    im1 = resample_ops.affine_resample_batch(m_crops, mmats, moffs, out_shape, cval=np.nan)
    return _pcc_register_core_batch(im0, im1, upsample_factor, region_mode)


def phase_correlation_registration(fixed_data, moving_data, disambiguate_region_mode=None,
                                   device=None, **phase_corr_kwargs):
    """Register one pair of images (arrays or sims on the same pixel grid,
    NaN outside their data): the affine of the moving image's shift and the
    link quality. ``upsample_factor`` (10 in 2D, 2 in 3D by default) sets
    the subpixel precision; ``use_fused_core=False`` takes the step-by-step
    path (:func:`_phase_correlation_stepwise`) instead of the batched core;
    other kwargs are not read, as in the reference. Runs on ``device``."""
    device = misc_utils.resolve_device(device)
    im0 = np.asarray(getattr(fixed_data, "data", fixed_data), dtype=np.float32)
    im1 = np.asarray(getattr(moving_data, "data", moving_data), dtype=np.float32)
    ndim = im0.ndim
    upsample_factor = phase_corr_kwargs.pop("upsample_factor", 10 if ndim == 2 else 2)
    if not phase_corr_kwargs.pop("use_fused_core", True):
        return _phase_correlation_stepwise(
            im0, im1, upsample_factor, disambiguate_region_mode, device
        )
    t_best, quality = _pcc_register_core_batch(
        torch.from_numpy(im0)[None].to(device), torch.from_numpy(im1)[None].to(device),
        upsample_factor, disambiguate_region_mode,
    )
    return {
        "affine_matrix": param_utils.affine_from_translation(
            t_best[0].cpu().numpy().astype(float)
        ),
        "quality": float(quality[0]),
    }


def _phase_correlation_stepwise(im0_np, im1_np, upsample_factor: int, region_mode, device):
    """The reference's step-by-step pairwise path, in torch ops on
    ``device``: the shift proposals one by one (the masked one only where
    NaN is present), the sign and wrap candidates expanded on the host, and
    every candidate scored (SSIM over the union or intersection box, the
    Spearman quality of each) by :func:`_evaluate_candidates`; the first
    best SSIM wins."""
    ndim = im0_np.ndim
    im0 = pc_ops.rescale_intensity(torch.from_numpy(im0_np)[None].to(device), ndim)
    im1 = pc_ops.rescale_intensity(torch.from_numpy(im1_np)[None].to(device), ndim)
    im0nm = torch.isnan(im0)
    im1nm = torch.isnan(im1)
    has_nans = bool(im0nm.any() or im1nm.any())
    if region_mode is None:
        region_mode = "intersection" if has_nans else "union"
    valid_pixels1 = int((~im1nm).sum())
    im0nn = torch.nan_to_num(im0) if has_nans else im0
    im1nn = torch.nan_to_num(im1) if has_nans else im1

    shift_candidates = [
        pc_ops.phase_cross_correlation_batch(im0nn, im1nn, upsample_factor, norm)[0][0]
        for norm in ("phase", None)
    ]
    if has_nans:
        shift_candidates.append(
            pc_ops.masked_phase_cross_correlation_batch(im0nn, im1nn, ~im0nm, ~im1nm)[0][0]
        )
    # the sign and wrap candidates of each proposal
    shape = im1_np.shape
    max_shift_per_dim = np.max([im0_np.shape, im1_np.shape])
    t_candidates = []
    for shift_candidate in shift_candidates:
        shift_candidate = shift_candidate.cpu().numpy()
        ranges = [1 if shift_candidate[d] == 0 else 4 for d in range(ndim)]
        for sel in np.ndindex(tuple(ranges)):
            t_candidate = []
            for d in range(ndim):
                c = shift_candidate[d]
                t_candidate.append(
                    (c, -c, -(c - shape[d]), -c - shape[d])[sel[d]]
                )
            if np.max(np.abs(t_candidate)) < max_shift_per_dim:
                t_candidates.append(t_candidate)
    if not t_candidates:
        return {"affine_matrix": param_utils.affine_from_translation(np.zeros(ndim)),
                "quality": np.nan}

    t_candidates = np.array(t_candidates, dtype=np.float32)
    # float32 extremes, as the reference takes them from float32 arrays
    highs = torch.cat([pc_ops.nanmax(im0), pc_ops.nanmax(im1)]).cpu().numpy()
    lows = torch.cat([pc_ops.nanmin(im0), pc_ops.nanmin(im1)]).cpu().numpy()
    data_range = float(np.nanmax(highs) - np.nanmin(lows))
    im1_min = float(lows[1])
    ssim_vals, quality_vals = _evaluate_candidates(
        im0[0], im1[0], t_candidates, im0nm[0], valid_pixels1, data_range, im1_min, region_mode
    )
    argmax_index = int(np.nanargmax(ssim_vals))
    return {
        "affine_matrix": param_utils.affine_from_translation(list(t_candidates[argmax_index])),
        "quality": float(quality_vals[argmax_index]),
    }


def _evaluate_candidates(im0, im1, t_candidates, im0nm, valid_pixels1: int, data_range: float,
                         im1_min: float, region_mode: str):
    """SSIM (window 7, 5 or 3 as the box admits; -1 where none does or the
    moving image holds nothing above its minimum in the box) and Spearman
    quality of every candidate shift of ``im1`` against ``im0``, over the
    union or intersection of their valid boxes; -1 both where the candidate
    keeps under a tenth of the moving image's valid pixels. Candidates are
    scored in groups within :data:`ops.candidate_scoring.SCORE_BYTES`. Returns
    numpy arrays."""
    ndim = im0.dim()
    shape = tuple(im0.shape)
    dev = im0.device
    lo0, hi0 = im_metrics._bbox_bounds_from_mask(~im0nm, ndim)
    im0f = torch.nan_to_num(im0)
    fixed_maps = {w: im_metrics.ssim_fixed_maps(im0f, w, ndim) for w in (3, 5, 7)}
    group = max(1, cs_ops.SCORE_BYTES // (16 * int(np.prod(shape))))
    ssim_out, quality_out = [], []
    for g0 in range(0, len(t_candidates), group):
        t = torch.from_numpy(t_candidates[g0:g0 + group]).to(dev)
        im1t = resample_ops.translate_resample_batch(im1, t, order=1, cval=np.nan)
        valid1 = ~torch.isnan(im1t)
        mask = valid1 & ~im0nm
        mask_sum = mask.reshape(len(t), -1).sum(-1)
        frac_ok = (mask_sum > 0) & (mask_sum.to(torch.float32) / max(valid_pixels1, 1) >= 0.1)
        lo1, hi1 = im_metrics._bbox_bounds_from_mask(valid1, ndim)
        if region_mode == "union":
            lo, hi = torch.minimum(lo0, lo1), torch.maximum(hi0, hi1)
        else:
            lo, hi = torch.maximum(lo0, lo1), torch.minimum(hi0, hi1)
        box = im_metrics._box_mask(shape, lo, hi)
        box_max = torch.where(box, torch.nan_to_num(im1t, nan=-torch.inf), -torch.inf)
        box_max = box_max.reshape(len(t), -1).amax(-1)
        min_shape = (hi - lo + 1).amin(-1)
        win_eff = torch.clamp_max(min_shape - torch.remainder(min_shape - 1, 2), 7)
        im1tf = torch.nan_to_num(im1t)
        ssims = [
            im_metrics.ssim_mean_over_box_precomputed(
                im0f, *fixed_maps[w], im1tf, lo, hi, w, data_range, ndim
            )
            for w in (3, 5, 7)
        ]
        ssim = torch.where(win_eff >= 7, ssims[2], torch.where(win_eff >= 5, ssims[1], ssims[0]))
        ssim = torch.where((win_eff < 3) | (box_max <= im1_min), -1.0, ssim)
        quality = im_metrics.masked_spearman(im0.expand_as(im1t), im1t - 1, mask, ndim)
        quality = torch.where(box_max <= im1_min, -1.0, quality)
        ssim_out.append(torch.where(frac_ok, ssim, -1.0).cpu().numpy())
        quality_out.append(torch.where(frac_ok, quality, -1.0).cpu().numpy())
    return np.concatenate(ssim_out), np.concatenate(quality_out)


# ---------------------------------------------------------------------------
# the per-pair path
# ---------------------------------------------------------------------------


def sims_to_intrinsic_coord_system(sim1: Sim, sim2: Sim, transform_key, overlap_bboxes,
                                   device=None):
    """Both sims resampled (as float32, NaN outside) onto the fixed sim's
    pixel grid over the overlap, each carrying the fixed sim's affine under
    ``transform_key``. The resampling is ``transform_sim``'s on ``device``:
    the exact-affine kernels on the card, the gather for NaN data."""
    spatial_dims = si_utils.get_spatial_dims_from_sim(sim1)
    lowers, uppers = overlap_bboxes
    spacing = np.max([si_utils.get_spacing_from_sim(s, asarray=True) for s in [sim1, sim2]], axis=0)
    affines = []
    for sim in [sim1, sim2]:
        m = np.asarray(si_utils.get_affine_from_sim(sim, transform_key).squeeze())
        affines.append(m[0] if m.ndim == 3 else m)
    transf_affine = np.linalg.inv(affines[1]) @ affines[0]
    shape = np.floor(np.array(uppers[0] - lowers[0]) / spacing + 1).astype(np.int64)
    out_props = {
        "origin": {d: lowers[0][i] for i, d in enumerate(spatial_dims)},
        "spacing": {d: spacing[i] for i, d in enumerate(spatial_dims)},
        "shape": {d: int(shape[i]) for i, d in enumerate(spatial_dims)},
    }
    out = []
    for isim, sim in enumerate([sim1, sim2]):
        res = transformation.transform_sim(
            sim.copy(data=np.asarray(sim.data, dtype=np.float32)),
            [None, transf_affine][isim],
            output_stack_properties=out_props,
            cval=np.nan,
            device=device,
        )
        si_utils.set_sim_affine(
            res, si_utils.get_affine_from_sim(sim1, transform_key), transform_key=transform_key
        )
        out.append(res)
    return out[0], out[1]


def get_affine_from_intrinsic_affine(data_affine, sim_fixed: Sim, sim_moving: Sim,
                                     transform_key_fixed=None, transform_key_moving=None):
    """A pixel-space result as a world transform:
    ``D_to_W_f @ M_D @ inv(D_to_W_c)``. Both frames read the moving key's
    affine, as in the reference."""
    data_affine = np.asarray(data_affine, dtype=float)

    def phys2world(sim, key):
        if key is None:
            return np.eye(data_affine.shape[0])
        m = np.asarray(si_utils.get_affine_from_sim(sim, key).squeeze())
        return m[0] if m.ndim == 3 else m

    def d_to_p(sim):
        return param_utils.affine_from_translation(
            si_utils.get_origin_from_sim(sim, asarray=True)
        ) @ np.diag(list(si_utils.get_spacing_from_sim(sim, asarray=True)) + [1])

    D_to_W_f = phys2world(sim_moving, transform_key_moving) @ d_to_p(sim_moving)
    D_to_W_c = phys2world(sim_fixed, transform_key_moving) @ d_to_p(sim_fixed)
    return D_to_W_f @ data_affine @ np.linalg.inv(D_to_W_c)


def dispatch_pairwise_reg_func(pairwise_reg_func, fixed_data=None, moving_data=None,
                               skip_constant_check=False, **pairwise_reg_func_kwargs):
    """Call ``pairwise_reg_func`` with the data (when given) and kwargs,
    unless either image is constant (NaN aside): then warn and return the
    identity with quality NaN."""
    has_image_data = fixed_data is not None and moving_data is not None
    if has_image_data and not skip_constant_check:
        for data in (fixed_data, moving_data):
            arr = np.asarray(getattr(data, "data", data))
            if np.nanmin(arr) == np.nanmax(arr):
                warnings.warn(
                    "An overlap region between tiles/views is all zero or constant. "
                    "Assuming identity transform.", UserWarning, stacklevel=2,
                )
                return {"affine_matrix": np.eye(arr.ndim + 1), "quality": np.nan}
    if has_image_data:
        pairwise_reg_func_kwargs["fixed_data"] = fixed_data
        pairwise_reg_func_kwargs["moving_data"] = moving_data
    return pairwise_reg_func(**pairwise_reg_func_kwargs)


_PHYS_KEYWORDS = ("fixed_origin", "moving_origin", "fixed_spacing", "moving_spacing",
                  "initial_affine")


def register_pair_of_msims(
    msim1,
    msim2,
    transform_key,
    points_key: str = "beads",
    prefilter_markers: bool = False,
    registration_binning=None,
    reg_res_level=None,
    overlap_tolerance=None,
    pairwise_reg_func: Callable = phase_correlation_registration,
    pairwise_reg_func_kwargs: Optional[dict] = None,
    device=None,
):
    """Register two purely spatial views with ``pairwise_reg_func``, which
    is called in the space its signature asks for:

    - points (it names ``fixed_points`` and ``moving_points``): each view's
      point set ``points_key`` in world coordinates (with
      ``prefilter_markers``, only the points of its overlap crop), plus the
      crops and ``initial_affine`` where it names them;
    - physical space (it names all of ``fixed_origin``, ``moving_origin``,
      ``fixed_spacing``, ``moving_spacing`` and ``initial_affine``): the
      overlap crops with their origins and spacings;
    - pixel space (it names only the data): both crops resampled onto the
      fixed view's pixel grid of the overlap
      (:func:`sims_to_intrinsic_coord_system`).

    Returns ``transform`` (fixed world -> moving world), ``quality`` and
    ``bbox`` (the overlap box in world coordinates). Runs on ``device``, which
    a function that names ``device`` gets too."""
    device = misc_utils.resolve_device(device)
    pairwise_reg_func_kwargs = dict(pairwise_reg_func_kwargs or {})
    if misc_utils.has_keyword(pairwise_reg_func, "device"):
        pairwise_reg_func_kwargs.setdefault("device", device)
    msim1 = msim1 if isinstance(msim1, Msim) else msi_utils.get_msim_from_sim(msim1, scale_factors=[])
    msim2 = msim2 if isinstance(msim2, Msim) else msi_utils.get_msim_from_sim(msim2, scale_factors=[])
    spatial_dims = msi_utils.get_spatial_dims(msim1)

    has_phys = {k: misc_utils.has_keyword(pairwise_reg_func, k) for k in _PHYS_KEYWORDS}
    has_data = all(misc_utils.has_keyword(pairwise_reg_func, k) for k in ["fixed_data", "moving_data"])
    has_points = all(
        misc_utils.has_keyword(pairwise_reg_func, k) for k in ["fixed_points", "moving_points"]
    )
    # a function that takes no data reads no pixel of the crops: their
    # binned levels are made as metadata alone
    sim1, sim2, reg_sims_b, lowers, uppers, overlap_tolerance, _ = _select_and_crop_pair(
        msim1, msim2, transform_key, registration_binning=registration_binning,
        reg_res_level=reg_res_level, overlap_tolerance=overlap_tolerance, with_data=has_data,
    )
    affines = [np.asarray(si_utils.get_affine_from_sim(s, transform_key).squeeze())
               for s in reg_sims_b]
    affines = [a[0] if a.ndim == 3 else a for a in affines]
    fixed_data = moving_data = sims_pixel_space = None

    if has_points:
        space = "transform_key_space"
        point_sets = [s.attrs.get("point_sets", {}).get(points_key) for s in [sim1, sim2]]
        if point_sets[0] is None or point_sets[1] is None:
            raise ValueError(f"Point set {points_key!r} missing for marker registration.")
        if prefilter_markers:
            # each view's markers within its overlap crop, with the crop's
            # margin of one pixel
            filtered = []
            for isim, pts in enumerate(point_sets):
                pts = np.atleast_2d(np.asarray(pts, dtype=float))
                spacing = si_utils.get_spacing_from_sim(reg_sims_b[isim])
                margin = np.array([spacing[d] for d in spatial_dims])
                lo = np.asarray(lowers[isim], dtype=float) - 1e-6 - margin
                hi = np.asarray(uppers[isim], dtype=float) + 1e-6 + margin
                filtered.append(pts[np.all((pts >= lo) & (pts <= hi), axis=1)])
            point_sets = filtered
        pairwise_reg_func_kwargs["fixed_points"] = param_utils.transform_pts(point_sets[0],
                                                                             affines[0])
        pairwise_reg_func_kwargs["moving_points"] = param_utils.transform_pts(point_sets[1],
                                                                              affines[1])
        if has_phys["initial_affine"]:
            pairwise_reg_func_kwargs["initial_affine"] = param_utils.affine_to_xaffine(
                np.linalg.inv(affines[1]) @ affines[0]
            )
        if has_data:
            fixed_data, moving_data = reg_sims_b
    elif not any(has_phys.values()):
        if has_data:
            space = "pixel_space"
            sims_pixel_space = sims_to_intrinsic_coord_system(
                reg_sims_b[0], reg_sims_b[1], transform_key=transform_key,
                overlap_bboxes=(lowers, uppers), device=device,
            )
            fixed_data, moving_data = sims_pixel_space
        else:
            space = "transform_key_space"
    elif all(has_phys.values()):
        space = "physical_space"
        for isim, sim in enumerate(reg_sims_b):
            prefix = ["fixed", "moving"][isim]
            pairwise_reg_func_kwargs[f"{prefix}_origin"] = si_utils.get_origin_from_sim(sim)
            pairwise_reg_func_kwargs[f"{prefix}_spacing"] = si_utils.get_spacing_from_sim(sim)
        pairwise_reg_func_kwargs["initial_affine"] = param_utils.affine_to_xaffine(
            np.linalg.inv(affines[1]) @ affines[0]
        )
        if has_data:
            fixed_data, moving_data = reg_sims_b
    else:
        raise ValueError("Unknown registration function signature")

    reg_result = dispatch_pairwise_reg_func(
        pairwise_reg_func, fixed_data=fixed_data, moving_data=moving_data,
        skip_constant_check=not has_data or space == "transform_key_space",
        **pairwise_reg_func_kwargs,
    )
    affine = np.asarray(param_utils.to_xaffine(reg_result["affine_matrix"]).squeeze())
    if affine.ndim == 3:
        affine = affine[0]
    if space == "pixel_space":
        affine_phys = get_affine_from_intrinsic_affine(
            data_affine=affine, sim_fixed=sims_pixel_space[0], sim_moving=sims_pixel_space[1],
            transform_key_fixed=transform_key, transform_key_moving=transform_key,
        )
    elif space == "physical_space":
        affine_phys = affines[1] @ affine @ np.linalg.inv(affines[0])
    else:
        affine_phys = affine

    overlap_phys = _get_overlap_bboxes(
        sim1, sim2, input_transform_key=transform_key, output_transform_key=transform_key,
        overlap_tolerance=overlap_tolerance,
    )
    return {
        "transform": param_utils.affine_to_xaffine(affine_phys),
        "quality": reg_result["quality"],
        "bbox": np.array([overlap_phys["lowers"][0], overlap_phys["uppers"][0]]),
    }


def register_pair_of_msims_over_time(msim1, msim2, **register_kwargs):
    """:func:`register_pair_of_msims` at each timepoint of the views (a view
    without ``t`` counts as one timepoint): the transforms stacked over
    ``t``, the qualities as an array, the first timepoint's box."""
    msim1 = msi_utils.ensure_dim(msim1, "t")
    msim2 = msi_utils.ensure_dim(msim2, "t")
    t_coords = np.asarray(msi_utils.get_sim_from_msim(msim1).coords["t"])
    results = [
        register_pair_of_msims(
            msi_utils.multiscale_sel_coords(msim1, {"t": t}),
            msi_utils.multiscale_sel_coords(msim2, {"t": t}),
            **register_kwargs,
        )
        for t in t_coords
    ]
    return {
        "transform": XAffine(
            np.stack([np.asarray(r["transform"].squeeze()) for r in results]), t_coords=t_coords
        ),
        "quality": np.array([r["quality"] for r in results]),
        "bbox": results[0]["bbox"],
    }


# ---------------------------------------------------------------------------
# crops from the host and from the resident tile stack
# ---------------------------------------------------------------------------


class _CropRef:
    """One registration crop: its view, window start and true shape; the
    host path reads it from ``sim``, the device path cuts the same window
    from the resident tile stack."""

    __slots__ = ("view", "starts", "shape", "sim", "arr")

    def __init__(self, view, starts, shape, sim):
        self.view = int(view)
        self.starts = tuple(int(s) for s in starts)
        self.shape = tuple(int(s) for s in shape)
        self.sim = sim
        self.arr = None


def _gather_f32(flat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``flat[index]`` as float32, for any integer or float dtype (PyTorch
    has no CUDA gather of uint16: its bits are gathered as int16)."""
    if flat.dtype == torch.uint16:
        return (flat.view(torch.int16)[index].to(torch.int32) & 0xFFFF).to(torch.float32)
    return flat[index].to(torch.float32)


def _axis_index(bucket_shape, d: int, device) -> torch.Tensor:
    """arange along axis ``d`` of a (B, *bucket_shape) batch, broadcastable."""
    ndim = len(bucket_shape)
    return torch.arange(bucket_shape[d], device=device).reshape(
        (1,) + (1,) * d + (-1,) + (1,) * (ndim - d - 1)
    )


def _within_shapes(bucket_shape, shapes: torch.Tensor) -> torch.Tensor:
    """(B, *bucket_shape) mask of the positions below each item's true
    shape ``shapes`` (B, ndim)."""
    ndim = len(bucket_shape)
    mask = None
    for d in range(ndim):
        m = _axis_index(bucket_shape, d, shapes.device) < shapes[:, d].reshape((-1,) + (1,) * ndim)
        mask = m if mask is None else mask & m
    return mask


def _crops_from_resident(tiles, views, starts, shapes, bucket_shape):
    """A NaN-padded float32 crop batch (B, *bucket_shape) cut from the
    resident (V, *tile) stack: item b holds tile ``views[b]`` from
    ``starts[b]`` over ``shapes[b]``, NaN beyond; equal to the host crop
    batch for integer tiles."""
    ndim = len(bucket_shape)
    dev = tiles.device
    tdims = tuple(tiles.shape[1:])
    B = len(views)
    views = torch.as_tensor(views, dtype=torch.int64, device=dev)
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    shapes = torch.as_tensor(shapes, dtype=torch.int64, device=dev)
    lin = views.reshape((B,) + (1,) * ndim) * int(np.prod(tdims))
    for d in range(ndim):
        pos = starts[:, d].reshape((B,) + (1,) * ndim) + _axis_index(bucket_shape, d, dev)
        lin = lin + torch.clamp(pos, 0, tdims[d] - 1) * int(np.prod(tdims[d + 1:]))
    vals = _gather_f32(tiles.reshape(-1), lin)
    return torch.where(_within_shapes(bucket_shape, shapes), vals, torch.nan)


def _renan_crops(vals: torch.Tensor, shapes) -> torch.Tensor:
    """Float32 crops with NaN at or beyond each item's true shape."""
    shapes = torch.as_tensor(shapes, dtype=torch.int64, device=vals.device)
    mask = _within_shapes(tuple(vals.shape[1:]), shapes)
    return torch.where(mask, vals.to(torch.float32), torch.nan)


def _crop_const_flags(f_crops, m_crops):
    """Per pair: True where either crop's values (NaN aside) are all equal,
    the reference's guard against constant overlaps."""
    return (pc_ops.nanmin(f_crops) == pc_ops.nanmax(f_crops)) | (
        pc_ops.nanmin(m_crops) == pc_ops.nanmax(m_crops)
    )


def _host_crops_to_device(refs, bucket_shape, device):
    """Upload a batch of host crops: as uint16 where all are integers in its
    range, with the NaN pad rebuilt on the device, else as NaN-padded
    float32. Returns (crops, bytes uploaded)."""
    arrs = [r.arr for r in refs]
    B = len(arrs)
    as_uint16 = all(
        np.issubdtype(a.dtype, np.integer) and int(a.min(initial=0)) >= 0
        and int(a.max(initial=0)) <= 65535
        for a in arrs
    )
    if as_uint16:
        host = np.zeros((B,) + tuple(bucket_shape), dtype=np.uint16)
    else:
        host = np.full((B,) + tuple(bucket_shape), np.nan, dtype=np.float32)
    for b, a in enumerate(arrs):
        host[b][tuple(slice(0, s) for s in a.shape)] = a
    dev = torch.from_numpy(host).to(device)
    if as_uint16:
        dev = _renan_crops(dev, [r.shape for r in refs])
    return dev, host.nbytes


# ---------------------------------------------------------------------------
# register
# ---------------------------------------------------------------------------


def _get_singleton_spatial_dim(sims):
    """The spatial dim of extent 1 at one shared coordinate, if there is
    exactly one (3D views then register as 2D)."""
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    if len(sdims) != 3:
        return None
    singleton_dims = [d for d in sdims if all(s.sizes[d] == 1 for s in sims)]
    if len(singleton_dims) != 1:
        return None
    d = singleton_dims[0]
    coords = [float(s.origin[d]) for s in sims]
    if not np.allclose(coords, coords[0]):
        return None
    return d


def _drop_spatial_dim(msim: Msim, dim: str) -> Msim:
    """The msim with the singleton spatial dim ``dim`` selected away."""
    new_sims = [s.isel({dim: 0}) for s in msim.sims]
    sdims = msim.sims[0].spatial_dims
    keep = [i for i, d in enumerate(sdims) if d != dim] + [len(sdims)]
    new_transforms = {
        key: XAffine(xaff.data[..., keep, :][..., keep], t_coords=xaff.t_coords)
        for key, xaff in msim.transforms.items()
    }
    out = Msim(sims=new_sims, transforms=new_transforms, attrs=dict(msim.attrs))
    for s in out.sims:
        s.transforms = {}
    return out


def register(
    msims: Sequence,
    transform_key: str = None,
    points_key: str = "beads",
    prefilter_markers: bool = False,
    reg_channel_index: Optional[int] = None,
    reg_channel: Optional[str] = None,
    new_transform_key: Optional[str] = None,
    registration_binning: Optional[Dict[str, int]] = None,
    reg_res_level: Optional[int] = None,
    overlap_tolerance: Union[float, Dict[str, float]] = 0.0,
    pairwise_reg_func: Callable = phase_correlation_registration,
    pairwise_reg_func_kwargs: Optional[dict] = None,
    groupwise_resolution_method: str = "global_optimization",
    groupwise_resolution_kwargs: Optional[dict] = None,
    pre_registration_pruning_method: str = "alternating_pattern",
    pre_reg_pruning_method_kwargs: Optional[dict] = None,
    post_registration_do_quality_filter: bool = False,
    post_registration_quality_threshold: float = 0.2,
    plot_summary: bool = False,
    pairs: Optional[List[Tuple[int, int]]] = None,
    n_parallel_pairwise_regs: Optional[int] = None,
    pairwise_executor: Optional[Callable] = None,
    return_dict: bool = False,
    mesh=None,
    device_tiles: Optional[bool] = None,
    scheduler=None,
    device=None,
):
    """Register views (sims or msims) to a common coordinate system: overlap
    graph, pruning, pairwise registration, optional quality filter, groupwise
    resolution, and the resolved affines written under ``new_transform_key``
    (composed with ``transform_key``'s, over the union of their timepoints).

    Each pair registers at ``reg_res_level`` when given, else at the
    coarsest level whose factor does not exceed ``registration_binning``
    (by default the binning that brings an overlap under 400^3 voxels), and
    is binned by what the level leaves of it. Views with a ``t`` dim register
    and resolve each timepoint: the params are then stacked over ``t``.

    ``device_tiles``: cut the registration crops on the device from the
    resident tile stack that ``fuse()`` reads too (the device tile cache):
    ``True`` uploads the stack here, ``None`` uses it only when it is
    already resident, ``False`` never. The stack serves views of integer
    dtype with spatial dims only, registered unbinned at level 0; other
    views take host crops.

    The default phase correlation with no kwargs but ``upsample_factor``
    and ``disambiguate_region_mode`` runs batched on the device; any other
    ``pairwise_reg_func`` (marker-based registration of the point sets
    ``points_key``, ``registration_plugins``, a user's function) or kwargs
    (``use_fused_core=False``) register pair by pair
    (:func:`register_pair_of_msims`), or through ``pairwise_executor(msims,
    edges, kwargs)`` when given. ``n_parallel_pairwise_regs`` and
    ``scheduler`` keep the reference's signature and are not read. A
    ``mesh`` of more than one entry splits each pair batch over its entries
    (see :func:`compute_pairwise_registrations`).

    Returns the per-view affines, or with ``return_dict`` the reference's
    dict, whose graph is this package's :class:`~.mv_graph.Graph` and whose
    resolution metrics are a dict of numpy columns. Runs on ``device``: the
    CUDA device by default (the first device of a ``mesh``), or the CPU with
    ``device="cpu"``. Records the stages ``register.adjacency_graph``,
    ``register.pairwise_registrations`` and ``register.groupwise_resolution``
    in ``utils.profiling``."""
    mesh, device = mesh_utils.resolve(mesh, device)
    pairwise_reg_func_kwargs = pairwise_reg_func_kwargs or {}
    groupwise_resolution_kwargs = groupwise_resolution_kwargs or {}
    pre_reg_pruning_method_kwargs = pre_reg_pruning_method_kwargs or {}
    if scheduler is not None:
        warnings.warn(
            "register(..., scheduler=) is deprecated and unused.", DeprecationWarning, stacklevel=2
        )
    msims = [
        m if isinstance(m, Msim) else msi_utils.get_msim_from_sim(m, scale_factors=[])
        for m in msims
    ]
    sims = [msi_utils.get_sim_from_msim(m) for m in msims]

    telemetry = {}
    t0 = time.perf_counter()
    if "c" in msi_utils.get_dims(msims[0]):
        if reg_channel is None:
            if reg_channel_index is None:
                raise ValueError("Please choose a registration channel.")
            reg_channel = np.asarray(sims[0].coords["c"])[reg_channel_index]
        msims_reg = [
            msi_utils.multiscale_sel_coords(m, {"c": reg_channel})
            if "c" in msi_utils.get_dims(m) else m
            for m in msims
        ]
    else:
        msims_reg = msims

    reduced_dim = _get_singleton_spatial_dim(sims)
    if reduced_dim is not None:
        msims_reg = [_drop_spatial_dim(m, reduced_dim) for m in msims_reg]
        registration_binning, overlap_tolerance = [
            {d: v for d, v in param.items() if d != reduced_dim}
            if isinstance(param, dict) else param
            for param in [registration_binning, overlap_tolerance]
        ]

    with profiling.stage("register.adjacency_graph"):
        g = mv_graph.build_view_adjacency_graph_from_msims(
            msims_reg, transform_key=transform_key, pairs=pairs,
            overlap_tolerance=overlap_tolerance,
        )
    t1 = time.perf_counter()
    telemetry["graph_s"] = t1 - t0
    if pre_registration_pruning_method is not None:
        g_reg = mv_graph.prune_view_adjacency_graph(
            g, method=pre_registration_pruning_method,
            pruning_method_kwargs=pre_reg_pruning_method_kwargs,
        )
    else:
        g_reg = g
    telemetry["prune_s"] = time.perf_counter() - t1
    telemetry["edges"] = g.number_of_edges()
    telemetry["pruned_edges"] = g_reg.number_of_edges()

    with profiling.stage("register.pairwise_registrations"):
        g_reg_computed = compute_pairwise_registrations(
            msims_reg, g_reg, transform_key=transform_key, points_key=points_key,
            prefilter_markers=prefilter_markers,
            registration_binning=registration_binning, reg_res_level=reg_res_level,
            overlap_tolerance=overlap_tolerance, pairwise_reg_func=pairwise_reg_func,
            pairwise_reg_func_kwargs=pairwise_reg_func_kwargs,
            n_parallel_pairwise_regs=n_parallel_pairwise_regs,
            pairwise_executor=pairwise_executor, mesh=mesh,
            device_tiles=device_tiles, device=device, telemetry=telemetry,
        )
    if post_registration_do_quality_filter:
        g_reg_computed = mv_graph.filter_edges(
            g_reg_computed, threshold=post_registration_quality_threshold, weight_key="quality"
        )

    t2 = time.perf_counter()
    with profiling.stage("register.groupwise_resolution"):
        params_dict, groupwise_resolution_info_dict = param_resolution.groupwise_resolution(
            g_reg_computed, method=groupwise_resolution_method, **groupwise_resolution_kwargs
        )
    params = [params_dict[iview] for iview in sorted(g_reg_computed.nodes())]
    if reduced_dim is not None:
        params = [param_utils.expand_affine_dims(p, [reduced_dim]) for p in params]
    if new_transform_key is not None:
        for imsim, msim in enumerate(msims):
            msi_utils.set_affine_transform(
                msim, params[imsim], transform_key=new_transform_key,
                base_transform_key=transform_key,
            )
    telemetry["resolve_s"] = time.perf_counter() - t2
    last_telemetry.clear()
    last_telemetry.update(telemetry)

    plot_info = {}
    if plot_summary:
        from multiview_stitcher_torch import vis_utils

        plot_info = vis_utils.plot_registration_summaries(
            msims, transform_key, new_transform_key, g_reg_computed,
            groupwise_resolution_info_dict, show_plot=plot_summary,
        )

    if return_dict:
        return {
            "params": params,
            "pairwise_registration": {
                "graph": g_reg_computed,
                "metrics": {"qualities": mv_graph.get_edge_attributes(g_reg_computed, "quality")},
                "summary_plot": (
                    (plot_info.get("fig_pair_reg"), plot_info.get("ax_pair_reg"))
                    if plot_summary else None
                ),
            },
            "groupwise_resolution": {
                "metrics": groupwise_resolution_info_dict,
                "summary_plot": (
                    (plot_info.get("fig_group_res"), plot_info.get("ax_group_res"))
                    if plot_summary else None
                ),
            },
        }
    return params


def compute_pairwise_registrations(msims, g_reg, n_parallel_pairwise_regs=None,
                                   pairwise_executor=None, mesh=None, device=None,
                                   telemetry=None, **register_kwargs):
    """Register the pair of every edge of ``g_reg``; returns a copy of the
    graph with each edge's ``transform``, ``quality`` and ``bbox`` (transform
    and quality over ``t`` for views with a ``t`` dim).

    ``pairwise_executor(msims, edges, kwargs)`` runs the edges instead (the
    register kwargs but ``device_tiles``, with the resolved ``device``) and
    returns one result dict an edge. Otherwise the default phase correlation
    runs batched on the device and any other pairwise function or kwargs
    pair by pair (:func:`register_pair_of_msims`, over ``t`` for views with
    a ``t`` dim). A ``mesh`` of more than one entry splits each batch of the
    batched path into one contiguous part per entry, registered on that
    entry's device (the reference's ``_resample_and_register_batch_sharded``);
    the results equal the unsharded ones. Without ``device`` the call runs
    on the mesh's first device."""
    mesh, device = mesh_utils.resolve(mesh, device)
    telemetry = {} if telemetry is None else telemetry
    g_reg_computed = g_reg.copy()
    edges = [tuple(sorted([e[0], e[1]])) for e in g_reg.edges]
    pair_kwargs = {k: v for k, v in register_kwargs.items() if k != "device_tiles"}
    pair_kwargs["device"] = device
    t0 = time.perf_counter()
    if pairwise_executor is not None:
        params = pairwise_executor(msims, edges, pair_kwargs)
        if len(params) != len(edges):
            raise ValueError(
                f"pairwise_executor returned {len(params)} results for "
                f"{len(edges)} registration pairs."
            )
        telemetry.update(route="executor", pairs=len(edges), pairwise_s=time.perf_counter() - t0)
        return _assign_pairwise_registrations(g_reg_computed, edges, params)

    params = _try_batched_phase_correlation(
        msims, edges, register_kwargs, device=device, telemetry=telemetry, mesh=mesh
    )
    if params is None:
        params = [
            register_pair_of_msims_over_time(msims[i], msims[j], **pair_kwargs)
            if "t" in msi_utils.get_dims(msims[i])
            else register_pair_of_msims(msims[i], msims[j], **pair_kwargs)
            for i, j in edges
        ]
        telemetry.update(route="per_pair", pairs=len(edges), pairwise_s=time.perf_counter() - t0)
    else:
        telemetry["route"] = "batched"
    return _assign_pairwise_registrations(g_reg_computed, edges, params)


class _Unit(NamedTuple):
    """One (edge, timepoint) work unit: its crops, the maps of both into the
    fixed view's pixel grid of the overlap, that grid's shape and its map
    ``T`` to world coordinates."""

    key: tuple
    fixed: _CropRef
    moving: _CropRef
    fmat: np.ndarray
    foff: np.ndarray
    mmat: np.ndarray
    moff: np.ndarray
    out_shape: tuple
    T: np.ndarray


def _part_crops(units, tiles, fshape, mshape, device):
    """The fixed and moving crop batches of ``units`` on ``device``: cut
    from the resident stack ``tiles`` there (with the constant-overlap flags
    computed on the device), or uploaded from the host crops. Returns
    (fixed, moving, flags or None, bytes uploaded)."""
    if tiles is not None:
        def refs_of(refs):
            return [r.view for r in refs], [r.starts for r in refs], [r.shape for r in refs]

        f_dev = _crops_from_resident(tiles, *refs_of([u.fixed for u in units]), fshape)
        m_dev = _crops_from_resident(tiles, *refs_of([u.moving for u in units]), mshape)
        return f_dev, m_dev, _crop_const_flags(f_dev, m_dev), 0
    f_dev, nb_f = _host_crops_to_device([u.fixed for u in units], fshape, device)
    m_dev, nb_m = _host_crops_to_device([u.moving for u in units], mshape, device)
    return f_dev, m_dev, None, nb_f + nb_m


def _try_batched_phase_correlation(msims, edges, register_kwargs, device, telemetry, mesh=None):
    """Batched pairwise registration of every (edge, timepoint) unit: one
    device batch per crop-shape bucket (up to :data:`MAX_B` units), from host
    crops or from crops cut out of the resident tile stack; with a sharded
    ``mesh``, each batch in one contiguous part per mesh entry on its device
    (crops cut from that device's copy of the stack). Returns the
    per-edge results, stacked over ``t`` for views with a ``t`` dim, or None
    where the call is not the default phase correlation with its plain
    kwargs (the per-pair path takes it)."""
    kwargs = dict(register_kwargs)
    pairwise_reg_func = kwargs.pop("pairwise_reg_func", phase_correlation_registration)
    reg_func_kwargs = dict(kwargs.pop("pairwise_reg_func_kwargs", None) or {})
    kwargs.pop("points_key", None)
    kwargs.pop("prefilter_markers", None)
    transform_key = kwargs.pop("transform_key")
    registration_binning = kwargs.pop("registration_binning", None)
    reg_res_level = kwargs.pop("reg_res_level", None)
    overlap_tolerance = kwargs.pop("overlap_tolerance", None)
    device_tiles = kwargs.pop("device_tiles", None)
    if (
        pairwise_reg_func is not phase_correlation_registration
        or set(reg_func_kwargs) - {"upsample_factor", "disambiguate_region_mode"}
        or kwargs
    ):
        return None
    if not edges:
        return []
    has_t = "t" in msi_utils.get_dims(msims[0])
    t_coords = np.asarray(msi_utils.get_sim_from_msim(msims[0]).coords["t"]) if has_t else [None]

    t_plan = time.perf_counter()
    # the resident tile stack: the one fuse() reads from the device tile
    # cache, of level 0 without t. Auto mode (None) takes it only when it is
    # resident already; True uploads it here (as stitch() asks)
    field_sims = [msi_utils.get_sim_from_msim(m) for m in msims]
    use_dev = device_tiles is not False and not has_t
    if use_dev:
        key = residency.device_tile_cache.key_for(field_sims, device)
        resident = residency.device_tile_cache.get(key) is not None
        if device_tiles is None and not resident:
            use_dev = False
        elif not resident:
            total = sum(
                int(np.prod(s.data.shape)) * np.dtype(s.data.dtype).itemsize for s in field_sims
            )
            if key is None or total > residency.device_tile_cache.budget():
                use_dev = False
        if use_dev:
            for s in field_sims:
                # float tiles may hold NaN, which the stack zeroes; integer
                # tiles are carried exactly
                if si_utils.get_nonspatial_dims_from_sim(s) or not np.issubdtype(
                    np.dtype(s.data.dtype), np.integer
                ):
                    use_dev = False
                    break

    units = []
    bboxes = {}
    levels = set()
    # each view's selection at each timepoint, its binned level and its
    # geometry are made once a call, not once an edge
    msim_sel_cache: dict = {}
    bin_cache: dict = {}
    geom_cache: dict = {}

    def msim_at(i, t):
        if t is None:
            return msims[i]
        if (i, t) not in msim_sel_cache:
            msim_sel_cache[(i, t)] = msi_utils.multiscale_sel_coords(msims[i], {"t": t})
        return msim_sel_cache[(i, t)]

    for ei, (i, j) in enumerate(edges):
        for ti, t in enumerate(t_coords):
            tkey = None if t is None else float(t)
            sim1, sim2, reg_sims_b, lowers, uppers, otol, crop_info = _select_and_crop_pair(
                msim_at(i, t), msim_at(j, t), transform_key,
                registration_binning=registration_binning, reg_res_level=reg_res_level,
                overlap_tolerance=overlap_tolerance, bin_cache=bin_cache, geom_cache=geom_cache,
                cache_keys=((i, tkey), (j, tkey)),
            )
            levels.add(crop_info["scale_key"])
            if use_dev and not (
                crop_info["scale_key"] == "scale0"
                and crop_info["full_sims"][0].data is field_sims[i].data
                and crop_info["full_sims"][1].data is field_sims[j].data
            ):
                # a coarser level or binning in play: the resident level-0
                # stack cannot serve the crops; all pairs take host crops
                use_dev = False
            if ei not in bboxes:
                scale_key = crop_info["scale_key"]
                overlap_phys = _get_overlap_bboxes(
                    sim1, sim2, input_transform_key=transform_key,
                    output_transform_key=transform_key, overlap_tolerance=otol,
                    geom_cache=geom_cache,
                    cache_keys=(("u", i, tkey, scale_key), ("u", j, tkey, scale_key)),
                )
                bboxes[ei] = np.array([overlap_phys["lowers"][0], overlap_phys["uppers"][0]])
            ndim = len(sim1.spatial_dims)
            refs = [
                _CropRef(
                    v,
                    [crop_info["slices"][k][d].start for d in reg_sims_b[k].spatial_dims],
                    tuple(reg_sims_b[k].data.shape),
                    reg_sims_b[k],
                )
                for k, v in enumerate((i, j))
            ]
            # the fixed view's pixel grid over the overlap, and each crop's
            # map into it
            spacing = np.max(
                [si_utils.get_spacing_from_sim(s, asarray=True) for s in reg_sims_b], axis=0
            )
            affines = []
            for s in reg_sims_b:
                a = np.asarray(si_utils.get_affine_from_sim(s, transform_key).squeeze())
                affines.append(a[0] if a.ndim == 3 else a)
            transf_affine = np.linalg.inv(affines[1]) @ affines[0]
            out_shape = tuple(
                int(v)
                for v in np.floor(np.array(uppers[0] - lowers[0]) / spacing + 1).astype(np.int64)
            )
            fmat, foff = resample_ops.physical_to_pixel_params(
                np.eye(ndim + 1),
                input_spacing=si_utils.get_spacing_from_sim(reg_sims_b[0], asarray=True),
                input_origin=si_utils.get_origin_from_sim(reg_sims_b[0], asarray=True),
                output_spacing=spacing, output_origin=lowers[0],
            )
            mmat, moff = resample_ops.physical_to_pixel_params(
                transf_affine,
                input_spacing=si_utils.get_spacing_from_sim(reg_sims_b[1], asarray=True),
                input_origin=si_utils.get_origin_from_sim(reg_sims_b[1], asarray=True),
                output_spacing=spacing, output_origin=lowers[0],
            )
            # world conversion of a pixel shift: the pixel grid T = A0 Tr(lo) S
            T = (
                affines[0] @ param_utils.affine_from_translation(lowers[0])
                @ np.diag(list(spacing) + [1])
            )
            units.append(_Unit((ei, ti), refs[0], refs[1], fmat, foff, mmat, moff, out_shape, T))

    unit_results = {}
    replicas = {}
    tile_bytes_before = residency.tile_upload_bytes
    telemetry["plan_s"] = time.perf_counter() - t_plan
    t_upload = time.perf_counter()
    if use_dev:
        # one upload a device, or a hit of the stack a fuse() or register()
        # left; a failed upload raises
        devices = mesh.distinct_devices if mesh_utils.is_sharded(mesh) else (device,)
        replicas = {d: residency.tiles_to_device(field_sims, d) for d in devices}
    else:
        # host crops, with the constant guard before batching
        kept = []
        for u in units:
            for ref in (u.fixed, u.moving):
                if ref.arr is None:
                    ref.arr = np.asarray(ref.sim.to_numpy())
            if any(np.nanmin(r.arr) == np.nanmax(r.arr) for r in (u.fixed, u.moving)):
                warnings.warn(
                    "An overlap region between tiles/views is all zero or constant. "
                    "Assuming identity transform.", UserWarning, stacklevel=2,
                )
                unit_results[u.key] = (np.eye(len(u.out_shape) + 1), np.nan)
                continue
            kept.append(u)
        units = kept
    telemetry["upload_s"] = time.perf_counter() - t_upload
    telemetry["device_tiles"] = bool(use_dev)
    telemetry["tile_upload_bytes"] = residency.tile_upload_bytes - tile_bytes_before

    upsample_factor = reg_func_kwargs.get("upsample_factor")
    region_mode = reg_func_kwargs.get("disambiguate_region_mode")
    buckets: dict = {}
    for unit in units:
        buckets.setdefault(unit.out_shape, []).append(unit)

    t_pairs = time.perf_counter()
    score_launches = cs_ops.score_candidates.launches
    timed = device.type == "cuda"
    if timed:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    pending = []
    crop_bytes = 0
    for out_shape, bucket in buckets.items():
        ndim = len(out_shape)
        uf = upsample_factor or (10 if ndim == 2 else 2)
        fshape = tuple(max(u.fixed.shape[d] for u in bucket) for d in range(ndim))
        mshape = tuple(max(u.moving.shape[d] for u in bucket) for d in range(ndim))
        for cstart in range(0, len(bucket), MAX_B):
            chunk = bucket[cstart:cstart + MAX_B]
            if mesh_utils.is_sharded(mesh):
                parts = [(chunk[sl], d) for sl, d in mesh_utils.shard_parts(len(chunk), mesh)]
            else:
                parts = [(chunk, device)]
            for part, dev in parts:
                f_dev, m_dev, const, nbytes = _part_crops(
                    part, replicas.get(dev), fshape, mshape, dev
                )
                crop_bytes += nbytes
                tables = torch.from_numpy(np.stack([
                    np.concatenate([a.ravel() for a in (u.fmat, u.foff, u.mmat, u.moff)])
                    for u in part
                ]).astype(np.float32)).to(dev)
                n2 = ndim * ndim
                fmats = tables[:, :n2].reshape(-1, ndim, ndim)
                foffs = tables[:, n2:n2 + ndim]
                mmats = tables[:, n2 + ndim:2 * n2 + ndim].reshape(-1, ndim, ndim)
                moffs = tables[:, 2 * n2 + ndim:]
                shifts, qualities = _resample_and_register_batch(
                    f_dev, m_dev, fmats, foffs, mmats, moffs, out_shape, uf, region_mode
                )
                pending.append((part, shifts, qualities, const))
    if timed:
        ev1.record()
    telemetry["batches"] = len(pending)
    telemetry["buckets"] = len(buckets)
    telemetry["pairs"] = len(edges)
    telemetry["units"] = len(edges) * len(t_coords)
    telemetry["levels"] = sorted(levels)
    telemetry["crop_upload_bytes"] = crop_bytes
    telemetry["score_launches"] = cs_ops.score_candidates.launches - score_launches

    for chunk, shifts, qualities, const in pending:
        shifts = shifts.cpu().numpy()
        qualities = qualities.cpu().numpy()
        consts = np.zeros(len(chunk), bool) if const is None else const.cpu().numpy()
        for u, t_vec, q, is_const in zip(chunk, shifts, qualities, consts):
            if is_const:
                warnings.warn(
                    "An overlap region between tiles/views is all zero or constant. "
                    "Assuming identity transform.", UserWarning, stacklevel=2,
                )
                unit_results[u.key] = (np.eye(len(u.out_shape) + 1), np.nan)
                continue
            affine_px = param_utils.affine_from_translation(np.asarray(t_vec, dtype=float))
            unit_results[u.key] = (u.T @ affine_px @ np.linalg.inv(u.T), float(q))
    telemetry["pairwise_s"] = time.perf_counter() - t_pairs
    if timed:
        telemetry["pairwise_device_ms"] = ev0.elapsed_time(ev1)

    params = []
    for ei in range(len(edges)):
        mats = [unit_results[(ei, ti)][0] for ti in range(len(t_coords))]
        quals = [unit_results[(ei, ti)][1] for ti in range(len(t_coords))]
        if has_t:
            transform = XAffine(np.stack(mats), t_coords=np.asarray(t_coords))
            quality = np.asarray(quals)
        else:
            transform, quality = param_utils.affine_to_xaffine(mats[0]), quals[0]
        params.append({"transform": transform, "quality": quality, "bbox": bboxes[ei]})
    return params


def _assign_pairwise_registrations(g_reg_computed, edges, params):
    for i, pair in enumerate(edges):
        g_reg_computed.edges[pair]["transform"] = params[i]["transform"]
        g_reg_computed.edges[pair]["quality"] = params[i]["quality"]
        g_reg_computed.edges[pair]["bbox"] = params[i]["bbox"]
    return g_reg_computed


# ---------------------------------------------------------------------------
# crops to references and pairs from sample masks
# ---------------------------------------------------------------------------


def _sel_spatial_range(sim: Sim, ranges: Dict[str, Tuple[float, float]]) -> Sim:
    """The pixel centres within [lo, hi] per spatial dim."""
    return sim.isel(_spatial_range_slices(sim, ranges))


def crop_sim_to_references(sim_input_to_crop: Sim, reference_sims: Sequence[Sim],
                           transform_key_input: str, transform_keys_reference: Sequence[str],
                           input_time_index: int = 0) -> Sim:
    """The smallest crop of ``sim_input_to_crop`` that covers the reference
    sims (their corners mapped into its frame)."""
    ref_corners_world = []
    for iref, ref_sim in enumerate(reference_sims):
        props = si_utils.get_stack_properties_from_sim(
            ref_sim, transform_key=transform_keys_reference[iref]
        )
        ref_corners_world += list(mv_graph.get_vertices_from_stack_props(props))
    mat = np.asarray(
        si_utils.get_affine_from_sim(sim_input_to_crop, transform_key=transform_key_input).squeeze()
    )
    if mat.ndim == 3:
        mat = mat[input_time_index]
    corners_input = param_utils.transform_pts(np.asarray(ref_corners_world), np.linalg.inv(mat))
    lower = corners_input.min(axis=0)
    upper = corners_input.max(axis=0)
    sdims = si_utils.get_spatial_dims_from_sim(sim_input_to_crop)
    return _sel_spatial_range(
        sim_input_to_crop, {d: (lower[i], upper[i]) for i, d in enumerate(sdims)}
    )


def _nanmin_label_fusion(transformed_views):
    """The smallest label (1-based) over the views at each voxel, 0 where
    no view holds one."""
    stacked = torch.where(
        torch.isnan(transformed_views) | (transformed_views == 0), torch.inf, transformed_views
    )
    out = stacked.amin(0)
    return torch.where(torch.isinf(out), 0.0, out)


def get_pairs_from_sample_masks(mask_sims, transform_key: str = si_utils.DEFAULT_TRANSFORM_KEY,
                                fused_mask_spacing=None, device=None):
    """Pairs of views whose sample masks touch: each mask becomes a label
    image (view index + 1), the labels are fused by their smallest value
    (the host tier of ``fuse`` on ``device``) and adjacent labels paired.
    Returns (sorted pairs, the fused label sim)."""
    from multiview_stitcher_torch.fusion import fuse

    label_sims = [
        si_utils.get_sim_from_array(
            (np.asarray(m.data) > 0).astype(np.float32) * (i + 1),
            dims=m.dims,
            scale=si_utils.get_spacing_from_sim(m),
            translation=si_utils.get_origin_from_sim(m),
            affine=si_utils.get_affine_from_sim(m, transform_key),
            transform_key=transform_key,
        )
        for i, m in enumerate(mask_sims)
    ]
    if fused_mask_spacing is None:
        fused_mask_spacing = si_utils.get_spacing_from_sim(mask_sims[0])
    fused = fuse(
        label_sims, transform_key=transform_key, fusion_func=_nanmin_label_fusion,
        output_spacing=fused_mask_spacing, device=device,
    )
    labels = np.asarray(fused.to_numpy()).astype(int)
    pairs = mv_graph.get_connected_labels(labels)
    return [tuple(sorted(p)) for p in pairs.tolist()], fused


def apply_recursive_dict(func, d):
    """``func`` applied to every leaf of a nested dict."""
    if isinstance(d, dict):
        return {k: apply_recursive_dict(func, v) for k, v in d.items()}
    return func(d)


# ---------------------------------------------------------------------------
# marker-based registration (RGLDM descriptors, RANSAC, ICP), on the host
# ---------------------------------------------------------------------------


def _marker_min_matches(transform_type: str, ndim: int) -> int:
    transform_type = transform_type.lower()
    if transform_type == "translation":
        return 1
    if transform_type == "rigid":
        return ndim
    if transform_type == "affine":
        return ndim + 1
    raise ValueError(f"Unsupported marker transform_type {transform_type!r}")


def _marker_descriptors(points, num_neighbors, redundancy):
    """Local descriptors: for each point and each ``num_neighbors``-subset
    of its ``num_neighbors + redundancy`` nearest neighbours, the sorted
    pairwise distances of the group, in point then subset order. Returns
    (descriptors, their point indices)."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, dtype=float)
    required = num_neighbors + redundancy
    if len(points) < required + 1:
        raise ValueError(
            f"Not enough points for marker descriptors: need {required + 1}, got {len(points)}."
        )
    n = len(points)
    _, neigh = cKDTree(points).query(points, k=min(n, required + 2))
    neigh = np.atleast_2d(neigh)
    # each point's nearest neighbours but itself, in query order
    others = neigh != np.arange(n)[:, None]
    first = np.argsort(~others, axis=1, kind="stable")[:, :required]
    complete = others.sum(1) >= required
    nb = np.take_along_axis(neigh, first, axis=1)[complete]
    centre = np.flatnonzero(complete)
    if not len(centre):
        raise ValueError("No marker descriptors could be built.")
    subsets = np.array(list(it.combinations(range(required), num_neighbors)), dtype=np.int64)
    groups = np.concatenate(
        [np.broadcast_to(centre[:, None, None], (len(centre), len(subsets), 1)),
         nb[:, subsets]], axis=2,
    )
    a, b = np.array(list(it.combinations(range(num_neighbors + 1), 2))).T
    diffs = points[groups[..., a]] - points[groups[..., b]]
    dists = np.sqrt(np.einsum("...i,...i->...", diffs, diffs))
    vectors = np.sort(dists, axis=-1).reshape(-1, len(a))
    return vectors, np.repeat(centre, len(subsets))


def _marker_auto_threshold(fixed_points, moving_points, num_neighbors, scale):
    """Descriptor distance threshold: the median nearest-neighbour distance
    of both sets times the square root of the descriptor length, scaled."""
    from scipy.spatial import cKDTree

    nearest = []
    for pts in (fixed_points, moving_points):
        pts = np.asarray(pts, dtype=float)
        if len(pts) < 2:
            continue
        d, _ = cKDTree(pts).query(pts, k=2)
        nearest.extend(d[:, 1])
    nearest = np.asarray(nearest)
    nearest = nearest[np.isfinite(nearest)]
    if nearest.size == 0:
        return 0.0
    vec_len = math.comb(num_neighbors + 1, 2)
    return float(np.median(nearest) * np.sqrt(vec_len) * scale)


def _match_descriptors(fixed_vectors, fixed_idx, moving_vectors, moving_idx,
                       descriptor_ratio, distance_threshold):
    """Candidate point pairs: each fixed descriptor's nearest moving
    descriptor, under the threshold and ``descriptor_ratio`` times nearer
    than the nearest descriptor of another moving point; a pair found
    several times counts once, in the order first found."""
    from scipy.spatial import cKDTree

    if not len(fixed_vectors) or not len(moving_vectors):
        return np.empty((0, 2), dtype=int)
    _, counts = np.unique(moving_idx, return_counts=True)
    k = min(len(moving_vectors), int(np.max(counts)) + 1)
    dists, inds = cKDTree(moving_vectors).query(fixed_vectors, k=k)
    dists = np.atleast_2d(dists)
    inds = np.atleast_2d(inds)
    candidates = {}
    for fi, row_d, row_i in zip(fixed_idx, dists, inds):
        best = float(row_d[0])
        best_mi = moving_idx[row_i[0]]
        if best >= distance_threshold:
            continue
        other = moving_idx[row_i] != best_mi
        second = float(row_d[np.flatnonzero(other)[0]]) if other.any() else np.inf
        if best * descriptor_ratio < second:
            pair = (int(fi), int(best_mi))
            if pair not in candidates or best < candidates[pair]:
                candidates[pair] = best
    return np.asarray(list(candidates.keys()), dtype=int).reshape(-1, 2)


def _fit_marker_transform(fixed_points, moving_points, transform_type):
    transform_type = transform_type.lower()
    if transform_type == "translation":
        return transforms.estimate_translation(fixed_points, moving_points)
    if transform_type == "rigid":
        M = transforms.estimate_rigid(fixed_points, moving_points)
    elif transform_type == "affine":
        M = transforms.estimate_affine(fixed_points, moving_points)
    else:
        raise ValueError(f"Unsupported marker transform_type {transform_type!r}")
    if not np.all(np.isfinite(M)):
        raise ValueError("Marker registration points are degenerate.")
    return M


def _marker_quality(n_inliers: int, n: int, mean_res: float, max_error: float) -> float:
    return (n_inliers / n) * max(0.0, 1.0 - mean_res / max_error)


def _run_marker_ransac(fixed_points, moving_points, candidate_pairs, transform_type,
                       ransac_max_error, ransac_min_inlier_ratio, ransac_min_inlier_factor,
                       ransac_num_iterations, random_state):
    """RANSAC over the candidate pairs: every minimal sample when there are
    at most ``ransac_num_iterations`` of them, else that many draws of
    ``np.random.default_rng(random_state)``; the model of the best
    (quality, inliers, -mean residual) key is refit on its inliers. Returns
    (affine, quality)."""
    ndim = fixed_points.shape[1]
    min_matches = _marker_min_matches(transform_type, ndim)
    min_inliers = max(min_matches, int(np.round(min_matches * ransac_min_inlier_factor)))
    if len(candidate_pairs) < min_inliers:
        raise ValueError(
            f"Not enough marker correspondences for RANSAC: need {min_inliers}, "
            f"got {len(candidate_pairs)}."
        )
    fixed_c = fixed_points[candidate_pairs[:, 0]]
    moving_c = moving_points[candidate_pairs[:, 1]]
    rng = np.random.default_rng(random_state)
    n = len(candidate_pairs)
    samples = (
        it.combinations(range(n), min_matches)
        if math.comb(n, min_matches) <= ransac_num_iterations
        else (rng.choice(n, size=min_matches, replace=False) for _ in range(ransac_num_iterations))
    )
    best = None
    for sample in samples:
        sample = np.asarray(sample, dtype=int)
        try:
            M = _fit_marker_transform(fixed_c[sample], moving_c[sample], transform_type)
        except ValueError:
            continue
        res = np.linalg.norm(param_utils.transform_pts(fixed_c, M) - moving_c, axis=1)
        inliers = res <= ransac_max_error
        ni = int(inliers.sum())
        if ni == 0:
            key = (0.0, 0, -np.inf)
        else:
            mean_res = float(res[inliers].mean())
            key = (_marker_quality(ni, n, mean_res, ransac_max_error), ni, -mean_res)
        if best is None or key > best[0]:
            best = (key, inliers)
    if best is None:
        raise ValueError("No marker transform model could be estimated.")

    inliers = best[1]
    ni = int(inliers.sum())
    if ni < min_inliers or ni / n < ransac_min_inlier_ratio:
        raise ValueError(f"Marker RANSAC did not find enough inliers ({ni}/{n}).")
    M = _fit_marker_transform(fixed_c[inliers], moving_c[inliers], transform_type)
    res = np.linalg.norm(param_utils.transform_pts(fixed_c, M) - moving_c, axis=1)
    inliers = res <= ransac_max_error
    ni = int(inliers.sum())
    if ni < min_inliers:
        raise ValueError(f"Refit marker transform lost inliers ({ni}/{n}).")
    return M, _marker_quality(ni, n, float(res[inliers].mean()), ransac_max_error)


def _run_marker_icp(fixed_points, moving_points, initial_affine, initial_quality,
                    transform_type, icp_max_error, icp_num_iterations, icp_tolerance):
    """Iterative closest points from ``initial_affine``: refit on the
    fixed points whose nearest moving point lies within ``icp_max_error``,
    until the affine moves by at most ``icp_tolerance``."""
    from scipy.spatial import cKDTree

    affine = np.asarray(initial_affine, dtype=float)
    quality = float(initial_quality)
    min_matches = _marker_min_matches(transform_type, fixed_points.shape[1])
    tree = cKDTree(moving_points)
    for _ in range(icp_num_iterations):
        d, idx = tree.query(param_utils.transform_pts(fixed_points, affine), k=1)
        inliers = d <= icp_max_error
        if int(inliers.sum()) < min_matches:
            break
        try:
            next_affine = _fit_marker_transform(
                fixed_points[inliers], moving_points[idx[inliers]], transform_type
            )
        except ValueError:
            break
        quality = _marker_quality(int(inliers.sum()), len(fixed_points),
                                  float(np.mean(d[inliers])), icp_max_error)
        delta = float(np.linalg.norm(next_affine - affine))
        affine = next_affine
        if delta <= icp_tolerance:
            break
    return affine, quality


def registration_marker_based(
    fixed_points,
    moving_points,
    transform_type: str = "rigid",
    num_neighbors: int = 3,
    redundancy: int = 1,
    descriptor_ratio: float = 3.0,
    descriptor_distance_threshold: Optional[float] = None,
    descriptor_threshold_scale: float = 1.0,
    ransac_max_error: float = 5.0,
    ransac_min_inlier_ratio: float = 0.1,
    ransac_min_inlier_factor: float = 3.0,
    ransac_num_iterations: int = 1000,
    icp: bool = False,
    icp_max_error: Optional[float] = None,
    icp_num_iterations: int = 50,
    icp_tolerance: float = 1e-6,
    random_state: int = 0,
    fail_on_error: bool = True,
):
    """Marker-based registration of two point sets in world coordinates
    (BigStitcher's RGLDM bead matching): local sorted-distance descriptors
    matched between the sets, RANSAC over the matches, optionally ICP.
    Returns ``affine_matrix`` (fixed -> moving world) and ``quality``; with
    ``fail_on_error=False`` a failure warns and returns the identity with
    quality NaN. Host numpy and scipy, as in the reference."""
    fixed_points = np.asarray(fixed_points, dtype=float)
    moving_points = np.asarray(moving_points, dtype=float)
    ndim = fixed_points.shape[1] if fixed_points.ndim == 2 else 2
    try:
        if fixed_points.ndim != 2 or moving_points.ndim != 2:
            raise ValueError("Marker point arrays must be two-dimensional.")
        if fixed_points.shape[1] != moving_points.shape[1]:
            raise ValueError("Point sets must share dimensionality.")
        if not len(fixed_points) or not len(moving_points):
            raise ValueError("Marker point arrays must not be empty.")
        fv, fi = _marker_descriptors(fixed_points, num_neighbors, redundancy)
        mv, mi = _marker_descriptors(moving_points, num_neighbors, redundancy)
        if descriptor_distance_threshold is None:
            descriptor_distance_threshold = _marker_auto_threshold(
                fixed_points, moving_points, num_neighbors, descriptor_threshold_scale
            )
        pairs = _match_descriptors(fv, fi, mv, mi, descriptor_ratio,
                                   descriptor_distance_threshold)
        affine, quality = _run_marker_ransac(
            fixed_points, moving_points, pairs, transform_type, ransac_max_error,
            ransac_min_inlier_ratio, ransac_min_inlier_factor, ransac_num_iterations,
            random_state,
        )
        if icp:
            affine, quality = _run_marker_icp(
                fixed_points, moving_points, affine, quality, transform_type,
                ransac_max_error if icp_max_error is None else icp_max_error,
                icp_num_iterations, icp_tolerance,
            )
        return {"affine_matrix": affine, "quality": quality}
    except ValueError as e:
        if fail_on_error:
            raise
        warnings.warn(str(e), UserWarning, stacklevel=2)
        return {"affine_matrix": np.eye(ndim + 1), "quality": np.nan}


# the optional ANTsPy and ITK-Elastix backends, as the reference exports them
from multiview_stitcher_torch.registration_plugins import (  # noqa: E402,F401
    registration_ANTsPy,
    registration_ITKElastix,
)
