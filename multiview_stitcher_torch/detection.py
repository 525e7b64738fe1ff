"""Bead detection: Laplacian-of-gaussian blobs with local-maximum
suppression, scanned over an image chunk by chunk with halo deduplication.

The port of ``multiview_stitcher_tpu.detection``. The filter stack of
:func:`log_detect` (LoG, maximum and minimum filters, gaussian) runs on the
device through ``ops.filters`` in float32 with TF32 off; the detection mask
is downloaded and labelled on the host (``scipy.ndimage.label``), as in the
reference. :func:`detect_beads` picks the pyramid level, cuts halo-extended
chunks, hands each window to the detection function as a numpy array and
keeps the centroids (unweighted, of each label) that lie in the chunk's
core, in intrinsic physical coordinates.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from scipy import ndimage as scipy_ndimage

from multiview_stitcher_torch import msi_utils, mv_graph, si_utils
from multiview_stitcher_torch.ops import filters as filter_ops
from multiview_stitcher_torch.si_utils import Sim
from multiview_stitcher_torch.utils import misc as misc_utils
from multiview_stitcher_torch.utils.misc import requires_overlap

# what log_detect did since detect_beads last cleared it: windows, voxels,
# and seconds of the upload, the filters (to the mask on the device), the
# mask download and the host labelling (label and centroids)
last_telemetry: dict = {}


def _normalize_size(value, ndim):
    if isinstance(value, bool):
        raise TypeError("size must be a float or dict[str, float].")
    if isinstance(value, (int, float, np.integer, np.floating)):
        return tuple(float(value) for _ in range(ndim))
    if isinstance(value, dict):
        if len(value) != ndim:
            raise TypeError("size dict must cover all spatial dims.")
        return tuple(float(v) for v in value.values())
    raise TypeError("size must be a float or dict[str, float].")


def _aligned_size(value, spacing, ndim):
    """:func:`_normalize_size`, with a dict ``value`` paired to a dict
    ``spacing`` by key, in the spacing's order."""
    if isinstance(value, dict) and isinstance(spacing, dict):
        if set(value) != set(spacing):
            raise TypeError(
                f"size dict keys {sorted(value)} must match spacing keys {sorted(spacing)}."
            )
        return tuple(float(value[d]) for d in spacing)
    return _normalize_size(value, ndim)


def _spacing_values(spacing):
    if isinstance(spacing, dict):
        return tuple(float(spacing[d]) for d in spacing)
    return tuple(float(s) for s in spacing)


def _target_size_pixels(target_size_physical, spacing):
    vals = _spacing_values(spacing)
    target = _aligned_size(target_size_physical, spacing, len(vals))
    return tuple(t / s for t, s in zip(target, vals))


def _log_detect_required_overlap(kwargs):
    spacing = kwargs["spacing"]
    target_size = _target_size_pixels(kwargs["target_size_physical"], spacing)
    ndim = len(target_size)
    out = []
    for size in target_size:
        sigma = max(0.5, float(size) / (2.0 * np.sqrt(ndim)))
        min_distance = max(1.0, float(size) / 2.0)
        out.append(max(1, int(np.ceil(4 * sigma + min_distance))))
    if isinstance(spacing, dict):
        return dict(zip(spacing, out))
    return tuple(out)


def _log_response_kernel(
    img: torch.Tensor,
    sigma_pixels: tuple,
    max_filter_size: tuple,
    threshold_rel: float,
    threshold_abs,
    max_neigh_intensity,
    min_filter_size: tuple,
    max_neigh_sigma_pixels,
) -> torch.Tensor:
    """The detection mask of a float32 image: local maxima of the
    scale-normalised LoG response above the threshold (relative to the
    image's largest response unless ``threshold_abs``) and above 0, and,
    with ``max_neigh_intensity``, whose (optionally smoothed)
    neighbourhood minimum lies below it."""
    with misc_utils.full_f32():
        response = -filter_ops.gaussian_laplace(img, sigma_pixels, mode="reflect")
        response = response * float(np.mean(sigma_pixels)) ** 2
        max_response = filter_ops.maximum_filter(response, max_filter_size, mode="reflect")
        if threshold_abs is None:
            finite = torch.where(torch.isnan(response), -torch.inf, response)
            thr = finite.max() * threshold_rel
        else:
            thr = threshold_abs
        detections = (response == max_response) & (response > thr) & (response > 0)
        if max_neigh_intensity is not None:
            sample = (
                filter_ops.gaussian_filter(img, max_neigh_sigma_pixels)
                if max_neigh_sigma_pixels is not None
                else img
            )
            min_sample = filter_ops.minimum_filter(sample, min_filter_size, mode="reflect")
            detections = detections & (min_sample < max_neigh_intensity)
    return detections


def _add_time(key: str, seconds: float) -> None:
    last_telemetry[key] = last_telemetry.get(key, 0.0) + seconds


@requires_overlap(_log_detect_required_overlap)
def log_detect(
    image,
    spacing,
    target_size_physical,
    threshold_rel: float = 0.2,
    threshold_abs: Optional[float] = None,
    max_neigh_intensity: Optional[float] = None,
    max_neigh_sample_size=None,
    max_neigh_sigma=None,
    device=None,
):
    """Detect bright beads of about ``target_size_physical`` (a number or a
    dict per dim, physical units) in ``image`` (numpy or torch) with pixel
    ``spacing`` (a tuple or dict): LoG at sigma ``size / (2 sqrt(ndim))`` px,
    local maxima over ``2 ceil(size / 2) + 1`` px. Returns a numpy integer
    label array (0 is background). The filters run on ``device``: the CUDA
    device by default, the CPU with ``device="cpu"``."""
    device = misc_utils.resolve_device(device)
    ndim = image.ndim
    target_size = _target_size_pixels(target_size_physical, spacing)
    if len(target_size) != ndim:
        raise ValueError("spacing and target_size_physical must match image.ndim")

    sigma_pixels = tuple(max(0.5, s / (2.0 * np.sqrt(ndim))) for s in target_size)
    min_distance_pixels = tuple(max(1.0, s / 2.0) for s in target_size)
    max_filter_size = tuple(2 * int(np.ceil(d)) + 1 for d in min_distance_pixels)

    if max_neigh_intensity is not None:
        spacing_vals = _spacing_values(spacing)
        if max_neigh_sigma is not None:
            sig = _aligned_size(max_neigh_sigma, spacing, ndim)
            max_neigh_sigma_pixels = tuple(s / sp for s, sp in zip(sig, spacing_vals))
        else:
            max_neigh_sigma_pixels = None
        size_phys = _aligned_size(
            max_neigh_sample_size if max_neigh_sample_size is not None else target_size_physical,
            spacing, ndim,
        )
        min_filter_size = tuple(
            max(1, int(round(s / sp))) for s, sp in zip(size_phys, spacing_vals)
        )
    else:
        max_neigh_sigma_pixels = None
        min_filter_size = (1,) * ndim

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    t0 = time.perf_counter()
    img = torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray) else image)
    img = img.to(device).to(torch.float32)
    sync(device)
    t1 = time.perf_counter()
    mask = _log_response_kernel(
        img,
        sigma_pixels,
        max_filter_size,
        float(threshold_rel),
        None if threshold_abs is None else float(threshold_abs),
        None if max_neigh_intensity is None else float(max_neigh_intensity),
        min_filter_size,
        max_neigh_sigma_pixels,
    )
    del img
    sync(device)
    t2 = time.perf_counter()
    mask = mask.cpu().numpy()
    t3 = time.perf_counter()
    labels = scipy_ndimage.label(mask)[0]
    t4 = time.perf_counter()
    last_telemetry["windows"] = last_telemetry.get("windows", 0) + 1
    last_telemetry["voxels"] = last_telemetry.get("voxels", 0) + int(mask.size)
    for key, s in (("upload_s", t1 - t0), ("filters_s", t2 - t1), ("download_s", t3 - t2),
                   ("label_s", t4 - t3)):
        _add_time(key, s)
    return labels


def _extract_core_label_centroids(labels, chunk_start, core_shape, depth):
    """Centroids of the labels whose centre lies in the chunk's core, in
    image pixels (the halo dedup). A centroid is the mean position of its
    label's voxels: ``scipy.ndimage.center_of_mass(labels, labels, ids)``
    to the bit, from the label's voxels alone."""
    if not np.issubdtype(labels.dtype, np.integer):
        raise TypeError("detection_func must return an integer label array.")
    t0 = time.perf_counter()
    nz = np.nonzero(labels > 0)
    if not len(nz[0]):
        return np.empty((0, labels.ndim), dtype=float)
    # center_of_mass weighs each voxel by its label value, constant over a
    # label: sum(L * x) / (L * n) rounds as sum(x) / n, both exact integers
    _ids, inv = np.unique(labels[nz], return_inverse=True)
    counts = np.bincount(inv).astype(float)
    centroids = np.stack(
        [np.bincount(inv, weights=c.astype(float)) / counts for c in nz], axis=1
    )
    depth = np.asarray(depth, dtype=float)
    core_stop = depth + np.asarray(core_shape, dtype=float)
    keep = np.all((centroids >= depth) & (centroids < core_stop), axis=1)
    centroids = centroids[keep]
    _add_time("label_s", time.perf_counter() - t0)
    if not len(centroids):
        return np.empty((0, labels.ndim), dtype=float)
    return np.asarray(chunk_start, dtype=float) + centroids - depth


def detect_beads(
    msim,
    detection_func: Callable = log_detect,
    detection_func_kwargs: Optional[dict] = None,
    detection_overlap=None,
    max_detection_spacing=None,
    chunksize: Optional[Union[int, Dict[str, int]]] = None,
    device=None,
):
    """Detect beads over an image (sim or msim), chunk by chunk.

    Takes level 0, or the coarsest level whose spacing stays within
    ``max_detection_spacing``, and the first coordinate of any non-spatial
    dim; applies ``detection_func(window, spacing, **kwargs)`` (a numpy
    window; the function's ``required_overlap`` declares the halo unless
    ``detection_overlap`` is given) to halo-extended chunks of
    ``chunksize`` (the default spatial chunks); keeps each label's centroid
    in its chunk's core. Returns (N, ndim) positions in intrinsic physical
    coordinates. A detection function that names ``device`` gets the
    resolved one (the CUDA device by default, the CPU with
    ``device="cpu"``)."""
    device = misc_utils.resolve_device(device)
    last_telemetry.clear()
    if isinstance(msim, Sim):
        msim = msi_utils.get_msim_from_sim(msim, scale_factors=[])

    if max_detection_spacing is None:
        scale_key = "scale0"
    else:
        sdims0 = si_utils.get_spatial_dims_from_sim(msim.get_scale("scale0"))
        max_detection_spacing = si_utils.normalize_to_spatial_dict(
            max_detection_spacing, sdims0, "max_detection_spacing"
        )
        scale_key = msi_utils.get_res_level_from_spacing(msim, max_detection_spacing)

    sim = msim.get_scale(scale_key)
    nsdims = si_utils.get_nonspatial_dims_from_sim(sim)
    if nsdims:
        sim = si_utils.sim_sel_coords(sim, {nd: np.asarray(sim.coords[nd])[0] for nd in nsdims})

    sdims = si_utils.get_spatial_dims_from_sim(sim)
    ndim = len(sdims)
    spacing = si_utils.get_spacing_from_sim(sim)
    spacing_tuple = tuple(spacing[d] for d in sdims)
    origin = si_utils.get_origin_from_sim(sim)

    detection_func_kwargs = dict(detection_func_kwargs or {})
    if detection_overlap is None and hasattr(detection_func, "required_overlap"):
        required = detection_func.required_overlap(
            dict(detection_func_kwargs, spacing=spacing_tuple)
        )
        detection_overlap = required if isinstance(required, dict) else dict(zip(sdims, required))
    if detection_overlap is None:
        detection_overlap = 0
    detection_overlap = si_utils.normalize_to_spatial_dict(
        detection_overlap, sdims, "detection_overlap"
    )
    depth = tuple(int(np.ceil(detection_overlap[d])) for d in sdims)
    if misc_utils.has_keyword(detection_func, "device"):
        detection_func_kwargs.setdefault("device", device)

    if chunksize is None:
        chunksize = si_utils.get_default_spatial_chunksizes(ndim)
    elif not isinstance(chunksize, dict):
        chunksize = {d: int(chunksize) for d in sdims}

    shape = si_utils.get_shape_from_sim(sim)
    chunk_bbs, _ = mv_graph.get_chunk_bbs(
        {
            "origin": {d: 0.0 for d in sdims},
            "shape": shape,
            "spacing": {d: 1.0 for d in sdims},
        },
        chunksize,
    )

    all_points = []
    for bb in chunk_bbs:
        core_start = [int(bb["origin"][d]) for d in sdims]
        core_shape = [int(bb["shape"][d]) for d in sdims]
        # the halo-extended window, clipped to the image
        starts = [max(0, s - dp) for s, dp in zip(core_start, depth)]
        stops = [
            min(int(shape[d]), core_start[i] + core_shape[i] + depth[i])
            for i, d in enumerate(sdims)
        ]
        eff_depth = [core_start[i] - starts[i] for i in range(ndim)]
        window = sim.isel({d: slice(starts[i], stops[i]) for i, d in enumerate(sdims)})
        labels = detection_func(window.to_numpy(), spacing_tuple, **detection_func_kwargs)
        pts = _extract_core_label_centroids(np.asarray(labels), core_start, core_shape, eff_depth)
        if len(pts):
            all_points.append(pts)

    if all_points:
        point_indices = np.concatenate(all_points, axis=0)
    else:
        point_indices = np.empty((0, ndim), dtype=float)
    positions = np.empty_like(point_indices)
    for i, d in enumerate(sdims):
        positions[:, i] = origin[d] + point_indices[:, i] * spacing[d]
    return positions
