"""Fusion core: ``fuse`` of views placed by translations or by any affine,
with any fusion and weights function.

The port of ``multiview_stitcher_tpu.fusion._core``. Planning (output
geometry, kernel tables, view lists, chunk plans) is host-side numpy in
float64, as in the reference; each call takes the reference's tier, in its
order (:func:`_execute_fusion_plan`):

- **Translation tier**: a grid of translation-placed 2D or 3D tiles fused
  with the default weighted-average blending by the translation kernels
  (``ops.translation_fusion``). As in the reference, tiles that are lazy
  (zarr-backed), that exceed :data:`TILES_MAX_BYTES` or that hold more than
  :data:`STREAM_BYTES` stream through banded kernel calls that overlap
  upload, kernel and download (``fusion._streaming``) when their layout
  bands; other grids run in one kernel call over the whole output while
  the tiles fit on the device. Lazy tiles above :data:`TILES_MAX_BYTES` that
  do not band go to the batched tier's host slabs, as in the reference.
- **Tiles tier**: the other builtin fusion functions (``max_fusion``,
  ``simple_average_fusion``), and pixel scales the kernels do not take, on
  axis-aligned plans of equal-shape tiles that fit on the device: each
  chunk's views are resampled
  from the whole tiles on the device by the separable axis-aligned resample
  and blended with torch ops, chunks in batches under a memory bound.
- **Batched tier**: builtin fusion functions on views that are rotated,
  scaled or sheared. The output is cut into chunks; each chunk lists the
  views that reach it and their source windows
  (``_build_spatial_fusion_plan``); batches of chunks are resampled view by
  view with the exact-affine kernels (``ops.exact_affine``) straight from
  the tile stack on the device, once for the data and once for the 5^ndim
  blending grids, and blended with torch ops (``_reduce_views``). Float
  views that may hold NaN take its gather route instead, as in the
  reference: the gather resample of each view's NaN-padded window
  (``ops.resample``), so that NaN pixels drop out of a view's contribution.
  With ``MVS_TPU_SHEAR=1`` (the one environment variable the port reads)
  the shear tier (``ops.shear``) takes the place of the exact kernels, as in
  the reference.
- **Host tier**: any other fusion function, any ``weights_func`` (such as
  ``weights.content_based``) or ``fusion_func_kwargs``: each chunk, with the
  halo its functions declare, is fused by the computation of the extension
  API :func:`fuse_np`, which hands the resampled views (a (K, *chunk)
  tensor on the device) to the user's functions.

``trim_overlap=False`` with a halo keeps each chunk's extended region in the
output, chunks side by side (the batched and host tiers).

Lazy views whose bytes exceed :data:`TILES_MAX_BYTES` do not fit on the
device: the batched and host tiers then read each chunk's source windows
from them on the host, pack them into slabs and upload those, a batch or a
chunk ahead of the computation (the host-slab route, :func:`_iter_slabs`,
counted in :data:`last_slab_telemetry`); no tile stack is made. Otherwise
every tier reads its tile stack through the device tile cache
(``residency.device_tile_cache``): a
repeat ``fuse()`` over the same source arrays, or a ``fuse()`` after
``registration.register(..., device_tiles=True)`` has uploaded them, uploads
nothing; float views that the gather route or the host tier read with their
NaN kept are the one exception, a second stack uploaded once. The streaming
tier uploads its bands anew, as the reference's does.

``fuse(output_zarr_url=...)`` writes the output chunk by chunk into a zarr v2
array, or a zarr v3 array (sharded or not) for NGFF 0.5 (an OME-Zarr level 0
with its pyramid, by default) through ``io.zarr_backend``, and returns a sim
backed by it. With
``output_on_backend=True`` the output stays a torch tensor on the call's
device: the tiers that fuse on the device write into it there (the streaming
tier uploads its host output once). :func:`prepare_block_fusion` fuses a
zarr array block by block, the blocks spread over workers at will.

``fuse(mesh=...)`` (a ``parallel.mesh.Mesh`` of more than one entry) splits
the translation tier's output into one band of whole view-list tiles per
mesh entry, and the tiles tier's chunks into one contiguous part per entry,
each fused on its entry's device from that device's copy of the tile stack;
the other tiers, and the streaming tier, run on one device, as in the
reference. The sharded output equals the unsharded one bit for bit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from multiview_stitcher_torch import msi_utils, mv_graph, param_utils, residency, si_utils, weights
from multiview_stitcher_torch.fusion import _streaming
from multiview_stitcher_torch.io import ngff_utils, zarr_backend
from multiview_stitcher_torch.ops import exact_affine
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.ops import translation_fusion
from multiview_stitcher_torch.parallel import mesh as mesh_utils
from multiview_stitcher_torch.utils import misc as misc_utils
from multiview_stitcher_torch.utils import profiling

BoundingBox = Dict[str, Dict[str, Union[float, int]]]

# the translation tier streams tiles that hold more than STREAM_BYTES, and
# tiles that are not in memory whatever their size; lazy tiles above
# TILES_MAX_BYTES do not fit on the device: where they do not band, the
# chunked tiers read them as host slabs
STREAM_BYTES = 192 << 20
TILES_MAX_BYTES = 2 << 30
# the batched and tiles tiers resample at most this many view voxels at once
# (chunks in a batch x view slots x the largest window)
MAX_BATCH_ELEMENTS = 2**25


def max_fusion(transformed_views):
    """Pixel-wise NaN-aware maximum over views (NaN where no view is valid)."""
    nan = torch.isnan(transformed_views)
    top = torch.where(nan, -torch.inf, transformed_views).amax(dim=0)
    return torch.where(nan.all(dim=0), torch.nan, top)


def simple_average_fusion(transformed_views):
    """Unweighted NaN-aware mean over views (NaN where no view is valid)."""
    n_valid = (~torch.isnan(transformed_views)).sum(dim=0).to(torch.float32)
    n_valid = torch.where(n_valid == 0, torch.nan, n_valid)
    return (torch.nansum(transformed_views, dim=0) / n_valid).to(transformed_views.dtype)


def weighted_average_fusion(
    transformed_views, blending_weights, fusion_weights=None
):
    """Weighted average with (already normalized) blending weights."""
    if fusion_weights is None:
        additive_weights = blending_weights
    else:
        additive_weights = weights.normalize_weights(
            blending_weights * fusion_weights
        )
    prod = transformed_views * additive_weights
    return torch.nansum(prod, dim=0).to(transformed_views.dtype)


_BUILTIN_FUSION_MODES = {
    max_fusion: "max",
    weighted_average_fusion: "weighted_average",
    simple_average_fusion: "simple_average",
}


# ---------------------------------------------------------------------------
# output stack geometry
# ---------------------------------------------------------------------------


def calc_stack_properties_from_volume(volume, spacing):
    """(lower, upper) pixel-center extent + spacing -> shape/origin/spacing."""
    origin = np.asarray(volume[0], dtype=float)
    spacing = np.asarray(spacing, dtype=float)
    shape = (
        np.floor((np.asarray(volume[1]) - origin) / spacing + 1e-9).astype(
            np.int64
        )
        + 1
    )
    return {"shape": shape, "spacing": spacing, "origin": origin}


def get_transformed_stack_vertices(stack_keypoints, stack_properties_list, params):
    """Corner selectors (over pixel centers) through each view's param."""
    ndim = len(stack_properties_list[0]["spacing"])
    vertices = np.zeros((len(stack_properties_list), len(stack_keypoints), ndim))
    for iim, sp in enumerate(stack_properties_list):
        tmp = stack_keypoints * (np.array(sp["shape"]) - 1) * np.array(
            sp["spacing"]
        ) + np.array(sp["origin"])
        p = np.asarray(params[iim])
        vertices[iim] = tmp @ p[:ndim, :ndim].T + p[:ndim, ndim]
    return vertices


def calc_stack_properties_from_view_properties_and_params(
    views_props, params, spacing, mode="union"
):
    spatial_dims = ["z", "y", "x"][-len(spacing):]
    spacing = np.array([spacing[d] for d in spatial_dims], dtype=float)
    views_props = [
        {k: np.array([v[d] for d in spatial_dims]) for k, v in vp.items()
         if k in ("shape", "spacing", "origin")}
        for vp in views_props
    ]
    ndim = len(spacing)
    stack_vertices = np.array(list(np.ndindex(tuple([2] * ndim)))).astype(float)

    if mode == "sample":
        zero_z_face = stack_vertices[np.where(stack_vertices[:, 0] == 1)]
        zero_z_face[:, 2] = np.mean(zero_z_face[:, 2])
        tv = get_transformed_stack_vertices(zero_z_face, views_props, params)
        volume = (tv.min(1).min(0), tv.max(1).max(0))
    elif mode == "union":
        tv = get_transformed_stack_vertices(stack_vertices, views_props, params)
        volume = (tv.min(1).min(0), tv.max(1).max(0))
    elif mode == "intersection":
        tv = get_transformed_stack_vertices(stack_vertices, views_props, params)
        volume = (tv.min(1).max(0), tv.max(1).min(0))
    else:
        raise ValueError(mode)
    return calc_stack_properties_from_volume(volume, spacing)


def combine_stack_props(stack_props_list):
    """Combine per-timepoint stack props into one covering all of them."""
    origin = np.min([sp["origin"] for sp in stack_props_list], axis=0)
    spacing = np.min([sp["spacing"] for sp in stack_props_list], axis=0)
    shape = (
        np.max(
            [
                np.floor(
                    (sp["origin"] + (sp["shape"] - 1) * sp["spacing"] - origin)
                    / spacing
                    + 1e-9
                )
                for sp in stack_props_list
            ],
            axis=0,
        ).astype(np.int64)
        + 1
    )
    return {"origin": origin, "spacing": spacing, "shape": shape}


def calc_fusion_stack_properties(sims, params, spacing, mode="union"):
    """Fusion output geometry from views + params."""
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    views_props = [
        si_utils.get_stack_properties_from_sim(sim, asarray=False) for sim in sims
    ]
    xparams = [param_utils.to_xaffine(p) for p in params]
    t_coords = None
    for p in xparams:
        if p.has_t and len(p.t_coords) > 1:
            t_coords = p.t_coords
            break

    if t_coords is not None:
        props = combine_stack_props(
            [
                calc_stack_properties_from_view_properties_and_params(
                    views_props,
                    [p.sel_t(t).data if p.has_t else p.data for p in xparams],
                    spacing=spacing,
                    mode=mode,
                )
                for t in t_coords
            ]
        )
    else:
        props = calc_stack_properties_from_view_properties_and_params(
            views_props,
            [p.matrix() for p in xparams],
            spacing=spacing,
            mode=mode,
        )
    return {k: {d: v[i] for i, d in enumerate(sdims)} for k, v in props.items()}


def process_output_stack_properties(
    sims,
    output_spacing=None,
    output_origin=None,
    output_shape=None,
    output_stack_properties=None,
    output_stack_mode="union",
    transform_key=None,
):
    if transform_key is None:
        raise ValueError("transform_key must be provided")
    params = [
        si_utils.get_affine_from_sim(sim, transform_key=transform_key)
        for sim in sims
    ]
    if output_stack_properties is None:
        if output_spacing is None:
            output_spacing = si_utils.get_spacing_from_sim(sims[0])
        output_stack_properties = calc_fusion_stack_properties(
            sims, params=params, spacing=output_spacing, mode=output_stack_mode
        )
        if output_origin is not None:
            output_stack_properties["origin"] = output_origin
        if output_shape is not None:
            output_stack_properties["shape"] = output_shape
    return output_stack_properties


def process_output_chunksize(sims, output_chunksize=None):
    """Normalize ``output_chunksize`` to a per-spatial-dim dict: None -> the
    ndim default; scalars broadcast over spatial dims."""
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    if output_chunksize is None:
        return si_utils.get_default_spatial_chunksizes(len(sdims))
    if not isinstance(output_chunksize, dict):
        return {d: int(output_chunksize) for d in sdims}
    return {d: int(output_chunksize[d]) for d in sdims}


# ---------------------------------------------------------------------------
# translation tier
# ---------------------------------------------------------------------------


def _plan_is_translation(sparams, ndim) -> bool:
    for p in sparams:
        lin = np.asarray(p)[:ndim, :ndim]
        if not np.allclose(lin, np.eye(ndim), atol=1e-12):
            return False
    return True


def _views_output_scale(field_sims, output_stack_properties, sdims):
    """Per-dim output-pixel -> view-pixel scale shared by all views, or None.

    None when the views' spacings differ, when a scale exceeds 8 or is not
    positive, or, in 3D, when the z scale is not an integer (the kernels'
    uniform mode steps z by an integer stride)."""
    osp = np.array([float(output_stack_properties["spacing"][d]) for d in sdims])
    sp0 = si_utils.get_spacing_from_sim(field_sims[0])
    sp0 = np.array([float(sp0[d]) for d in sdims])
    for s in field_sims[1:]:
        sp = si_utils.get_spacing_from_sim(s)
        if not np.allclose([sp[d] for d in sdims], sp0, rtol=1e-6):
            return None
    scale = osp / sp0
    # snap near-unit / near-integer scales onto the exact paths
    scale = np.where(np.abs(scale - np.round(scale)) < 1e-9, np.round(scale), scale)
    if np.any(scale > 8.0) or np.any(scale <= 0.0):
        return None
    if len(sdims) == 3 and float(scale[0]) != int(scale[0]):
        return None
    return tuple(float(x) for x in scale)


def _views_output_scales_per_view(field_sims, output_stack_properties, sdims):
    """(V, ndim) per-view output-pixel -> view-pixel scales for mosaics of
    views at different spacings, or None when a scale exceeds 8 or is not
    positive. The z scale may be any float."""
    osp = np.array([float(output_stack_properties["spacing"][d]) for d in sdims])
    scales = np.zeros((len(field_sims), len(sdims)))
    for v, s in enumerate(field_sims):
        sp = si_utils.get_spacing_from_sim(s)
        sc = osp / np.array([float(sp[d]) for d in sdims])
        sc = np.where(np.abs(sc - np.round(sc)) < 1e-9, np.round(sc), sc)
        if np.any(sc > 8.0) or np.any(sc <= 0.0):
            return None
        scales[v] = sc
    return scales


def translation_kernel_params(
    plan, views_bb, output_stack_properties, sdims,
    blending_widths, shrink_distance, scale_arr=None,
):
    """Per-view translation-kernel parameter tables: pixel offsets, true
    extents, and the 5^ndim blending proxy grids with their pixel maps.
    Raises ValueError when a view's pixel map diag disagrees with the
    expected ``scale_arr``."""
    ndim = len(sdims)
    V = len(views_bb)
    osp_origin = np.array([output_stack_properties["origin"][d] for d in sdims])
    osp_spacing = np.array([output_stack_properties["spacing"][d] for d in sdims])
    offs = np.zeros((V, ndim), dtype=np.float32)
    extents = np.zeros((V, ndim), dtype=np.float32)
    wdiags = np.zeros((V, ndim), dtype=np.float32)
    woffs = np.zeros((V, ndim), dtype=np.float32)
    wgrids = np.zeros((V,) + (5,) * ndim, dtype=np.float32)
    for v in range(V):
        pm = plan["sparams"][v]
        m, o = resample_ops.physical_to_pixel_params(
            np.linalg.inv(pm),
            input_spacing=np.array([views_bb[v]["spacing"][d] for d in sdims]),
            input_origin=np.array([views_bb[v]["origin"][d] for d in sdims]),
            output_spacing=osp_spacing,
            output_origin=osp_origin,
        )
        if scale_arr is not None:
            expect = scale_arr[v] if np.ndim(scale_arr) == 2 else scale_arr
            if not np.allclose(np.diag(m), expect, rtol=1e-6):
                raise ValueError(
                    "per-view pixel map diag disagrees with the expected scale"
                )
        offs[v] = o
        extents[v] = [views_bb[v]["shape"][d] for d in sdims]
        g, wm, wo = weights.blending_weights_pixel_params(
            output_stack_properties,
            views_bb[v],
            pm,
            blending_widths=blending_widths,
            shrink_distance=shrink_distance,
        )
        wgrids[v] = g
        wdiags[v] = np.diag(wm)
        woffs[v] = wo
    return offs, extents, wdiags, woffs, wgrids


def tile_view_lists(offs, extents, scale_arr, out_shape, tile_shape):
    """(*n_t, K) int32 per-tile view lists over tiles of ``tile_shape``, in
    ascending view order, -1 for empty slots.

    View v covers the output pixels o with 0 <= scale * o + off <= ext - 1;
    a tile lists every view whose covered box, widened by one pixel, meets
    it. A listed view that is not valid at a pixel adds exactly 0 there, so
    the fused values do not depend on the tile shape (up to the f32 rounding
    of the tile-origin split where offsets are fractional)."""
    ndim = len(out_shape)
    n_t = [-(-int(out_shape[d]) // tile_shape[d]) for d in range(ndim)]
    boxes = []
    for v in range(len(offs)):
        sc_v = scale_arr[v] if scale_arr.ndim == 2 else scale_arr
        lo = -offs[v] / sc_v - 1
        hi = (extents[v] - offs[v]) / sc_v + 1
        box = []
        for d in range(ndim):
            a0 = max(0, int(np.floor(lo[d] / tile_shape[d])))
            a1 = min(n_t[d] - 1, int(np.floor(hi[d] / tile_shape[d])))
            if a0 > a1:
                box = None
                break
            box.append(slice(a0, a1 + 1))
        boxes.append(None if box is None else tuple(box))
    count = np.zeros(n_t, dtype=np.int32)
    for box in boxes:
        if box is not None:
            count[box] += 1
    K = max(1, int(count.max(initial=0)))
    view_idx = np.full(tuple(n_t) + (K,), -1, dtype=np.int32)
    fill = np.zeros(n_t, dtype=np.int64)
    for v, box in enumerate(boxes):
        if box is None:
            continue
        np.put_along_axis(view_idx[box], fill[box][..., None], v, axis=-1)
        fill[box] += 1
    return view_idx


# what the most recent run of the host-slab route did: the tier and route,
# units (batches or chunks), windows and their bytes read, bytes uploaded,
# tile bytes of the views, the seconds spent reading windows and packing
# slabs (queueing the windows' copies into their slabs and the padding on
# the device), summed over units on the reader thread, and on a CUDA device
# the (start, end) events of each upload on its stream
last_slab_telemetry: dict = {}


def _pad_beyond(slab, extent, value=None) -> None:
    """Pad ``slab`` (an array or a tensor) in place beyond ``extent``, axis
    by axis: with ``value``, or by repeating the last row/column/plane
    (numpy's ``pad(mode="edge")``) when it is None."""
    for d, e in enumerate(extent):
        if e < slab.shape[d]:
            src = [slice(None)] * slab.ndim
            dst = [slice(None)] * slab.ndim
            src[d], dst[d] = slice(e - 1, e), slice(e, None)
            slab[tuple(dst)] = slab[tuple(src)] if value is None else value


def _iter_slabs(units, field_sims, dtype, pad, device):
    """The host-slab route's reads and uploads: for each unit, a ``(shape,
    windows)`` pair whose windows are ``(position, iview, starts, stops)``,
    yield the slab of ``shape`` on ``device`` in ``dtype``, window k read
    from view ``iview``'s data (lazy or not) into ``slab[position]`` from
    its origin, and padded beyond it: with NaN (``pad="nan"``; positions no
    window fills are NaN too), by edge replication (``"edge"``), or not at
    all (``None``: for readers that mask by the windows' extents and never
    sample a position no window fills, as the exact kernels do).

    A reader thread reads the next unit while the caller computes on this
    one: the windows of a unit, each cut into pieces along its first axis,
    are read by ``residency.READ_WORKERS`` threads
    (``residency.read_retrying``) into one host buffer, pinned on a CUDA
    device, one window after another with no padding; the buffer is
    uploaded on a stream of its own, where each window is copied into its
    place in the slab and padded, and the slab is handed to the caller's
    stream through an event. A buffer is refilled
    only after its upload has completed. Nothing reads more than a window,
    nothing but the windows crosses to the device, and the tiles are never
    stacked. Counts go to :data:`last_slab_telemetry`."""
    if not units:
        return
    cuda = device.type == "cuda"
    tdtype = residency.torch_dtype(dtype)

    def extent(window):
        return [int(b) - int(a) for a, b in zip(window[2], window[3])]

    cap = max(sum(int(np.prod(extent(w))) for w in windows) for _, windows in units)
    bufs = residency.HostBuffers(3, (cap,), tdtype, cuda)
    tele = last_slab_telemetry
    if cuda:
        compute = torch.cuda.current_stream(device)
        up_stream = torch.cuda.Stream(device)

    def pieces(windows, offsets):
        """Each window's read cut along its first axis, at multiples of the
        array's chunks where it has them, into enough pieces for every
        reader (a batch of few views would leave most of them idle)."""
        per = max(1, -(-residency.READ_WORKERS // len(windows)))
        out = []
        for (pos, iview, starts, stops), off in zip(windows, offsets):
            a, b = int(starts[0]), int(stops[0])
            step = -(-(b - a) // per)
            chunk = int((getattr(field_sims[iview].data, "chunks", None) or (1,))[0])
            step = -(-step // chunk) * chunk
            cuts = sorted({a, b} | {c for c in range(-(-a // step) * step, b, step) if c > a})
            for z0, z1 in zip(cuts[:-1], cuts[1:]):
                out.append((off, extent((pos, iview, starts, stops)), iview,
                            (z0,) + tuple(starts[1:]), (z1,) + tuple(stops[1:]), z0 - a))
        return out

    def read_into(flat, piece):
        off, ext, iview, starts, stops, at = piece
        sl = tuple(slice(int(a), int(b)) for a, b in zip(starts, stops))
        data = field_sims[iview].data
        dest = flat[off:off + int(np.prod(ext))].reshape(ext)[at:at + int(stops[0] - starts[0])]
        label = f"window of view {iview}"
        if isinstance(data, zarr_backend.LazyZarrArray):
            # straight from the chunk files into the host buffer
            residency.read_retrying(lambda: data[sl].read(out=dest), label)
        else:
            dest[...] = residency.read_retrying(lambda: np.asarray(data[sl]), label)
        return dest.nbytes

    def load(unit, pool):
        shape, windows = unit
        sizes = [int(np.prod(extent(w))) for w in windows]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        total = int(offsets[-1])
        slot = bufs.acquire()
        t0 = time.perf_counter()
        nbytes = sum(pool.map(lambda p: read_into(slot.array, p), pieces(windows, offsets)))
        t1 = time.perf_counter()
        with torch.cuda.stream(up_stream) if cuda else contextlib.nullcontext():
            packed = torch.empty(total, dtype=tdtype, device=device)
            if cuda:
                start, uploaded, done = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                start.record()
            packed.copy_(slot.tensor[:total], non_blocking=cuda)
            if cuda:
                uploaded.record()
                tele["upload_events"].append((start, uploaded))
            slab = torch.empty(shape, dtype=tdtype, device=device)
            if pad == "nan":
                slab.fill_(float("nan"))
            dst, src = residency.signed_bits(slab), residency.signed_bits(packed)
            for w, off in zip(windows, offsets):
                ext = extent(w)
                region = dst[w[0]][tuple(slice(0, e) for e in ext)]
                region.copy_(src[int(off):int(off) + region.numel()].view(ext))
                if pad == "edge":
                    _pad_beyond(dst[w[0]], ext)
            if cuda:
                done.record()
        bufs.release(slot, uploaded if cuda else None)
        tele["windows"] += len(windows)
        tele["window_bytes"] += nbytes
        tele["upload_bytes"] += total * slab.element_size()
        tele["read_s"] += t1 - t0
        tele["pack_s"] += time.perf_counter() - t1
        tele["units"] += 1
        return slab, done if cuda else None

    with ThreadPoolExecutor(residency.READ_WORKERS) as pool, ThreadPoolExecutor(1) as loader:
        fut = loader.submit(load, units[0], pool)
        for i in range(len(units)):
            dev, done = fut.result()
            if i + 1 < len(units):
                fut = loader.submit(load, units[i + 1], pool)
            if cuda:
                compute.wait_event(done)
                dev.record_stream(compute)
            yield dev


def _slab_telemetry_start(tier, route, field_sims) -> None:
    last_slab_telemetry.clear()
    last_slab_telemetry.update(
        tier=tier, route=route, tile_bytes=_tile_bytes(field_sims), units=0, windows=0,
        window_bytes=0, upload_bytes=0, read_s=0.0, pack_s=0.0, upload_events=[],
    )


# fusion plans of geometry-identical fuse() calls, least recent insertion
# first: each holds the views' parameter matrices ("sparams"), the chunk plan
# once a chunked tier asked for it, and the host tables a tier prepared from
# it under "prep:*" keys
_plan_cache: dict = {}
_PLAN_CACHE_MAX = 16


def _plan_cache_insert(key, plan) -> None:
    while len(_plan_cache) >= _PLAN_CACHE_MAX:
        _plan_cache.pop(next(iter(_plan_cache)))
    _plan_cache[key] = plan


def clear_device_tile_cache() -> None:
    """Drop every tile stack the device tile cache holds, the streaming
    tier's upload-resume stash, and the cached fusion plans."""
    residency.device_tile_cache.clear()
    _plan_cache.clear()
    _streaming._upload_stash.clear()


class _PrefixedSink:
    """Spatial-region writes onto a region-writable array with leading
    non-spatial (t/c) dims, at the fixed index ``prefix_idx`` of those."""

    def __init__(self, array, prefix_idx):
        self.array = array
        self.prefix = tuple(prefix_idx)

    @property
    def shape(self) -> tuple:
        return tuple(self.array.shape[len(self.prefix):])

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.array.dtype)

    @property
    def shards(self) -> Optional[tuple]:
        """The spatial shard shape of a sharded zarr v3 array, else None."""
        shards = getattr(self.array, "shards", None)
        return None if shards is None else tuple(shards[len(self.prefix):])

    def __setitem__(self, slices, value):
        if not isinstance(slices, tuple):
            slices = (slices,)
        self.array[self.prefix + slices] = value


def _kernel_tile_shape(ndim, out_shape) -> tuple:
    """The view-list tile of the translation kernels for an output of
    ``out_shape``: in 3D no deeper than the output (the plain version pads
    to whole tiles)."""
    if ndim == 2:
        return translation_fusion.TILE_SHAPE_2D
    tile_shape = translation_fusion.TILE_SHAPE_3D
    return (min(tile_shape[0], max(int(out_shape[0]), 1)),) + tuple(tile_shape[1:])


def _execute_fusion_plan_translation(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    blending_widths,
    shrink_distance,
    out,
    device,
    scale=None,
    scales=None,
    mesh=None,
):
    """The whole output in one translation-kernel call with per-tile view
    lists. ``scale`` is the per-dim output-pixel -> view-pixel scale shared
    by all views; ``scales`` the (V, ndim) per-view variant. With a sharded
    ``mesh``, the reference's ``_pallas_fused_sharded``: the first tile axis
    of the view lists is padded with empty lists (-1) to a multiple of the
    mesh size, and each mesh entry fuses its band of ``b_t0`` whole tiles at
    the band's integer ``origin`` from its device's tile stack; every band
    is launched before the first is copied out, cropped to the output."""
    ndim = len(sdims)
    out_shape = tuple(int(output_stack_properties["shape"][d]) for d in sdims)
    tile_shape = _kernel_tile_shape(ndim, out_shape)
    if scales is not None:
        scale_arr = np.asarray(scales, dtype=np.float64)
        # the per-dim max stands where the reference sized its windows;
        # the kernels read the true per-view scales
        scale = tuple(float(x) for x in scale_arr.max(axis=0))
    else:
        scale_arr = np.asarray(scale, dtype=np.float64)
    # the tables are kept on the (cached) plan: a repeat call skips them
    prep_key = (
        "prep:pallas", tuple(tile_shape), tuple(scale),
        None if scales is None else scale_arr.tobytes(),
        json.dumps(blending_widths, sort_keys=True, default=float),
        json.dumps(shrink_distance, sort_keys=True, default=float),
    )
    if prep_key not in plan:
        with profiling.stage("fuse.plan"):
            views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
            tables = translation_kernel_params(
                plan, views_bb, output_stack_properties, sdims,
                blending_widths, shrink_distance, scale_arr,
            )
            plan[prep_key] = (
                tables, tile_view_lists(tables[0], tables[1], scale_arr, out_shape, tile_shape)
            )
    tables, view_idx = plan[prep_key]

    fuse_fn = (
        translation_fusion.fuse_translation_3d
        if ndim == 3
        else translation_fusion.fuse_translation_2d
    )
    kscale = scale
    if ndim == 3:
        kscale = (int(np.ceil(scale[0])),) + tuple(scale[1:])
    kw = dict(
        tile_shape=tile_shape, K=view_idx.shape[-1], out_dtype=residency.torch_dtype(out.dtype),
        scale=kscale, scales=None if scales is None else np.asarray(scales, np.float32),
    )
    if not mesh_utils.is_sharded(mesh):
        tiles = residency.tiles_to_device(field_sims, device)
        residency.download(fuse_fn(tiles, view_idx, *tables, out_shape=out_shape, **kw), out)
        return
    n_t0 = view_idx.shape[0]
    pad = (-n_t0) % mesh.size
    view_idx = np.concatenate(
        [view_idx, np.full((pad,) + view_idx.shape[1:], -1, dtype=view_idx.dtype)]
    )
    b_t0 = (n_t0 + pad) // mesh.size
    rows = b_t0 * tile_shape[0]
    replicas = {d: residency.tiles_to_device(field_sims, d) for d in mesh.distinct_devices}
    bands = [
        fuse_fn(
            replicas[d], view_idx[k * b_t0:(k + 1) * b_t0], *tables,
            out_shape=(rows,) + out_shape[1:], origin=(k * rows,) + (0,) * (ndim - 1), **kw,
        )
        for k, d in enumerate(mesh.devices)
    ]
    for k, band in enumerate(bands):
        n = min(rows, out_shape[0] - k * rows)
        if n > 0:
            residency.download(band[:n], out, row0=k * rows)


def _fuse_translation_views(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    scale,
    scales,
    blending_widths,
    shrink_distance,
    out,
    device,
    output_chunksize,
    mesh=None,
):
    """The reference's choice of translation tier: the banded streaming tier
    for uniform unit-scale tiles that are lazy, too large for the device or
    above :data:`STREAM_BYTES`, when their layout bands and no ``mesh`` is
    given; otherwise one monolithic kernel call (one a band per entry of a
    sharded ``mesh``) while the tiles fit on the device. Returns False
    when neither takes the call (lazy tiles above :data:`TILES_MAX_BYTES`
    that do not band: the chunked tiers read them as host slabs). A failed
    streaming run raises."""
    tiles_in_memory = all(not si_utils._is_lazy(s.data) for s in field_sims)
    tiles_fit_on_device = _tiles_fit_on_device(field_sims)
    stream_worthy = (
        mesh is None  # the banded pipeline is single-device
        and len({tuple(s.data.shape) for s in field_sims}) == 1
        and scale is not None
        and all(s == 1.0 for s in scale)
        and (
            not tiles_in_memory
            or not tiles_fit_on_device
            or _tile_bytes(field_sims) > STREAM_BYTES
        )
    )
    if stream_worthy:
        # the streaming tier writes host bands: a device output takes them
        # from one host array, uploaded once
        sink = (
            np.empty(tuple(out.shape), dtype=si_utils.numpy_dtype(out.dtype))
            if isinstance(out, torch.Tensor) else out
        )
        res = _streaming.execute_streaming(
            plan,
            field_sims,
            output_stack_properties,
            sdims,
            blending_widths=blending_widths,
            shrink_distance=shrink_distance,
            out_dtype=sink.dtype,
            device=device,
            out_sink=sink,
            output_chunksize=output_chunksize,
            is_zarr_sink=not isinstance(sink, np.ndarray),
        )
        if res is not None:
            if sink is not out:
                out.copy_(torch.from_numpy(sink))
            return True
    if not tiles_fit_on_device:
        return False
    _execute_fusion_plan_translation(
        plan,
        field_sims,
        output_stack_properties,
        sdims,
        blending_widths=blending_widths,
        shrink_distance=shrink_distance,
        out=out,
        device=device,
        scale=scale,
        scales=scales,
        mesh=mesh,
    )
    return True


# ---------------------------------------------------------------------------
# chunk plans and the batched tier (exact-affine kernels, gather route)
# ---------------------------------------------------------------------------


def _normalized_bw(data_t, bw, dim: int = 0):
    """The blending weights a reduction uses: cosine-tapered, 0 where a
    view's data is NaN, normalized over the view axis ``dim``; where every
    valid view's weight is 0 (the taper hits 0 at the support border), the
    valid views share equally, so border pixels keep their values."""
    bw = weights.cosine_weights(bw)
    valid = ~torch.isnan(data_t)
    bw = bw * valid
    wsum = bw.sum(dim=dim, keepdim=True)
    bw = torch.where(wsum > 0, bw, valid.to(bw.dtype))
    return weights.normalize_weights(bw, dim=dim)


def _reduce_views(data_t, bw, mode: str, use_bw: bool, dim: int = 0):
    """NaN-aware reduction over the view axis ``dim``; returns the fused
    values and the normalized weights (None without ``use_bw``)."""
    if use_bw:
        bw = _normalized_bw(data_t, bw, dim)
    if mode == "weighted_average":
        fused = torch.nansum(data_t * bw, dim=dim)
    elif mode == "max":
        nan = torch.isnan(data_t)
        top = torch.where(nan, -torch.inf, data_t).amax(dim=dim)
        fused = torch.where(nan.all(dim=dim), torch.nan, top)
    elif mode == "simple_average":
        n_valid = (~torch.isnan(data_t)).sum(dim=dim).to(torch.float32)
        n_valid = torch.where(n_valid == 0, torch.nan, n_valid)
        fused = torch.nansum(data_t, dim=dim) / n_valid
    else:
        raise ValueError(mode)
    return fused, bw


def _extend_bb(bb: BoundingBox, overlap_in_pixels: Dict[str, int]) -> BoundingBox:
    return {
        "origin": {
            d: bb["origin"][d] - overlap_in_pixels[d] * bb["spacing"][d]
            for d in bb["origin"]
        },
        "shape": {d: bb["shape"][d] + 2 * overlap_in_pixels[d] for d in bb["shape"]},
        "spacing": dict(bb["spacing"]),
    }


def _build_spatial_fusion_plan(
    *,
    sparams,
    views_bb,
    output_stack_properties,
    output_chunksize,
    output_chunk_bbs,
    output_chunk_bbs_with_overlap,
    block_indices,
    overlap_in_pixels,
    interpolation_order,
    sdims,
    extra_source_margin_in_pixels: int = 0,
):
    """Map each output chunk to the views that reach it and their source
    windows. ``sparams`` holds one (ndim+1, ndim+1) matrix per view.

    ``extra_source_margin_in_pixels`` widens every source window beyond the
    ``interpolation_order`` pixels that linear interpolation needs (the
    reference's shear tier asks for it; the exact tier passes 0)."""
    ndim = len(sdims)
    inv_sparams = [np.linalg.inv(p) for p in sparams]

    normalized = mv_graph.normalize_chunks(
        [output_chunksize[d] for d in sdims],
        [output_stack_properties["shape"][d] for d in sdims],
    )
    n_blocks_per_dim = [len(c) for c in normalized]
    uniform_cs = [c[0] for c in normalized]
    osp_origin = np.array([output_stack_properties["origin"][d] for d in sdims])
    osp_spacing = np.array([output_stack_properties["spacing"][d] for d in sdims])
    overlap_phys = np.array([overlap_in_pixels[d] for d in sdims]) * osp_spacing

    chunk_to_tiles: dict = {}
    for iview, (p, view_bb) in enumerate(zip(sparams, views_bb)):
        pad_phys = overlap_phys + np.array(
            [
                (interpolation_order + extra_source_margin_in_pixels)
                * view_bb["spacing"][d]
                for d in sdims
            ]
        )
        corners = param_utils.transform_pts(
            mv_graph.get_vertices_from_stack_props(view_bb), p
        )
        aabb_min = corners.min(axis=0) - pad_phys
        aabb_max = corners.max(axis=0) + pad_phys

        idx_ranges = []
        for idim in range(ndim):
            cs_phys = uniform_cs[idim] * osp_spacing[idim]
            i_first = max(
                0, int(np.floor((aabb_min[idim] - osp_origin[idim]) / cs_phys))
            )
            i_last = min(
                n_blocks_per_dim[idim] - 1,
                int(np.floor((aabb_max[idim] - osp_origin[idim]) / cs_phys)),
            )
            if i_first > i_last:
                break
            idx_ranges.append(range(i_first, i_last + 1))
        if len(idx_ranges) < ndim:
            continue
        for ci in product(*idx_ranges):
            chunk_to_tiles.setdefault(ci, []).append(iview)

    additional_extent = {
        d: int(interpolation_order) + int(extra_source_margin_in_pixels)
        for d in sdims
    }

    per_chunk_entries = []
    for chunk_bb, chunk_bb_ov, block_index in zip(
        output_chunk_bbs, output_chunk_bbs_with_overlap, block_indices
    ):
        chunk_views = []
        for iview in chunk_to_tiles.get(tuple(block_index), []):
            overlap = mv_graph.get_overlap_for_bbs(
                target_bb=chunk_bb_ov,
                query_bbs=[views_bb[iview]],
                param=inv_sparams[iview],
                additional_extent_in_pixels=additional_extent,
                param_is_inverse=True,
            )[0]
            if overlap is not None:
                chunk_views.append((iview, overlap))
        per_chunk_entries.append(
            {
                "views": chunk_views,
                "output_bb": chunk_bb,
                "output_bb_overlap": chunk_bb_ov,
                "block_index": tuple(int(i) for i in block_index),
            }
        )

    return {"sparams": sparams, "per_chunk_entries": per_chunk_entries}


def _plan_window_shapes(entries, sdims):
    """(K_max, S_max, O_max) of a plan's non-empty entries: the most views
    of a chunk, the largest source window and the largest chunk with its
    halo, per dim."""
    K_max = max(len(e["views"]) for e in entries)
    S_max = tuple(
        max(int(bb["shape"][d]) for e in entries for _, bb in e["views"])
        for d in sdims
    )
    O_max = tuple(
        max(int(e["output_bb_overlap"]["shape"][d]) for e in entries) for d in sdims
    )
    return K_max, S_max, O_max


def exact_kernel_params(
    entries, field_sims, sparams, sdims, S_max, O_max, stack_shape,
    use_bw, blending_widths, shrink_distance,
):
    """Per (chunk entry, view) parameters of the exact-affine kernels, in
    float64: for every entry a list of dicts with the chunk-pixel -> window-
    pixel map ``m``, ``o``, the window's integer ``start`` in the view and
    its true ``extent``, the view index ``iview`` and, with ``use_bw``, the
    blending grid ``g`` and its map ``wm``, ``wo``.

    The kernel grid of an entry is its chunk (with halo) extended to
    ``O_max``. With a ``stack_shape``, a window start is clamped so that an
    ``S_max`` window fits the tile stack (at least ``S_max`` wide), as the
    reference clamps it for its on-device slice; without one (the gather
    route) it is not, as for the reference's host slabs. The map's offset is
    relative to the start."""
    ndim = len(sdims)
    clamp_sizes = (
        None if stack_shape is None
        else tuple(max(stack_shape[i], S_max[i]) for i in range(ndim))
    )
    views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
    out = []
    for entry in entries:
        chunk_bb_ov = entry["output_bb_overlap"]
        kernel_bb = {
            "origin": dict(chunk_bb_ov["origin"]),
            "spacing": dict(chunk_bb_ov["spacing"]),
            "shape": {d: O_max[i] for i, d in enumerate(sdims)},
        }
        osp_spacing = np.array([chunk_bb_ov["spacing"][d] for d in sdims])
        kp = []
        for iview, window_bb in entry["views"]:
            sim = field_sims[iview]
            origin = si_utils.get_origin_from_sim(sim)
            spacing = si_utils.get_spacing_from_sim(sim)
            starts, extent = [], []
            for i, d in enumerate(sdims):
                start = int(round((window_bb["origin"][d] - origin[d]) / spacing[d]))
                start = max(0, start)
                stop = min(int(sim.sizes[d]), start + int(window_bb["shape"][d]))
                if clamp_sizes is not None:
                    start = min(start, max(0, clamp_sizes[i] - S_max[i]))
                starts.append(start)
                extent.append(stop - start)
            slab_origin = {
                d: origin[d] + starts[i] * spacing[d] for i, d in enumerate(sdims)
            }
            pm = sparams[iview]
            m, o = resample_ops.physical_to_pixel_params(
                np.linalg.inv(pm),
                input_spacing=np.array([spacing[d] for d in sdims]),
                input_origin=np.array([slab_origin[d] for d in sdims]),
                output_spacing=osp_spacing,
                output_origin=np.array([kernel_bb["origin"][d] for d in sdims]),
            )
            item = {"m": m, "o": o, "extent": extent, "start": starts, "iview": iview}
            if use_bw:
                g, wm, wo = weights.blending_weights_pixel_params(
                    kernel_bb,
                    views_bb[iview],
                    pm,
                    blending_widths=blending_widths,
                    shrink_distance=shrink_distance,
                )
                item.update(g=g, wm=wm, wo=wo)
            kp.append(item)
        out.append(kp)
    return out


def _exact_kind(ndim, params, use_bw) -> str:
    """Which kernel a plan takes: "2d", or in 3D "sepy" when every data map
    and every weight map of the plan is y-decoupled, else "general"."""
    if ndim == 2:
        return "2d"
    all_m = np.stack([it["m"] for kp in params for it in kp])
    if exact_affine.is_y_decoupled(all_m) and (
        not use_bw
        or exact_affine.is_y_decoupled(np.stack([it["wm"] for kp in params for it in kp]))
    ):
        return "sepy"
    return "general"


def _build_exact_batch(batch_params, K_max, ndim, use_bw):
    """Host tables of one batch of entries, every entry padded to ``K_max``
    slots. Padding slots carry identity maps, extent 1 and ``valid`` False."""
    B = len(batch_params)
    eye = np.tile(np.eye(ndim, dtype=np.float32), (B, K_max, 1, 1))
    t = {
        "tile_idx": np.zeros((B, K_max), dtype=np.int32),
        "starts": np.zeros((B, K_max, ndim), dtype=np.int32),
        "mats": eye,
        "offs": np.zeros((B, K_max, ndim), dtype=np.float32),
        "extents": np.ones((B, K_max, ndim), dtype=np.float32),
        "wgrids": np.zeros((B, K_max) + (5,) * ndim, dtype=np.float32),
        "wmats": eye.copy(),
        "woffs": np.zeros((B, K_max, ndim), dtype=np.float32),
        "valid": np.zeros((B, K_max), dtype=bool),
    }
    for bi, kp in enumerate(batch_params):
        for vi, it in enumerate(kp):
            t["tile_idx"][bi, vi] = it["iview"]
            t["starts"][bi, vi] = it["start"]
            t["mats"][bi, vi] = it["m"]
            t["offs"][bi, vi] = it["o"]
            t["extents"][bi, vi] = it["extent"]
            t["valid"][bi, vi] = True
            if use_bw:
                t["wgrids"][bi, vi] = it["g"]
                t["wmats"][bi, vi] = it["wm"]
                t["woffs"][bi, vi] = it["wo"]
    return t


def _blend_batch(data_t, bw, mode, use_bw, out_dtype):
    """Blend (B, K, *O) resampled views over K; nan_to_num and the cast to
    the output dtype (truncating for integers) run on the device."""
    fused, _ = _reduce_views(data_t, bw, mode, use_bw, dim=1)
    return translation_fusion._cast(fused, out_dtype)


def _fuse_chunk_batch_kernel(slabs, mats, offs, wgrids, wmats, woffs, view_valid, out_shape,
                             mode="weighted_average", use_bw=True):
    """Fuse a batch of B chunks from their (B, K, *S) NaN-padded slabs: each
    slab resampled at its (ndim, ndim) map and offset by the gather resample
    (``ops.resample.affine_resample_batch``, NaN outside), each 5^ndim
    blending grid at its own map (0 outside), padding views (``view_valid``
    False) dropped, blended over K and ``nan_to_num``. Returns the float32
    (B, *out_shape) batch on the device of ``slabs``."""
    slabs = torch.as_tensor(slabs)
    dev = slabs.device
    ndim = len(out_shape)
    B, K = slabs.shape[:2]
    BK = B * K
    split = (B, K) + tuple(out_shape)
    keep = torch.as_tensor(view_valid, device=dev).reshape((B, K) + (1,) * ndim)
    data_t = resample_ops.affine_resample_batch(
        slabs.reshape((BK,) + tuple(slabs.shape[2:])).to(torch.float32),
        torch.as_tensor(mats).reshape(BK, ndim, ndim), torch.as_tensor(offs).reshape(BK, ndim),
        out_shape, cval=float("nan"),
    ).reshape(split)
    data_t = torch.where(keep, data_t, torch.nan)
    bw = None
    if use_bw:
        bw = resample_ops.affine_resample_batch(
            torch.as_tensor(wgrids, dtype=torch.float32, device=dev).reshape((BK,) + (5,) * ndim),
            torch.as_tensor(wmats).reshape(BK, ndim, ndim),
            torch.as_tensor(woffs).reshape(BK, ndim), out_shape, cval=0.0,
        ).reshape(split) * keep
    fused, _ = _reduce_views(data_t, bw, mode, use_bw, dim=1)
    return torch.nan_to_num(fused)


def _fuse_chunk_batch_kernel_exact(
    data, mats, offs, extents, wgrids, wmats, woffs, view_valid,
    out_shape, mode="weighted_average", use_bw=True, kind="sepy",
    out_dtype=torch.float32, tile_idx=None, starts=None,
):
    """Fuse a batch of B chunks with up to K views each through the
    exact-affine kernels: one launch resamples all B * K data items, a
    second the 5^ndim blending grids (extent 5, ``cval`` 0), and torch ops
    blend over K. ``data`` is (B, K, *S) slabs, or with ``tile_idx`` (B, K)
    and ``starts`` (B, K, ndim) the (V, *T) tile stack itself. ``kind`` is
    "2d", "sepy" or "general". Returns (B, *out_shape) in ``out_dtype``."""
    ndim = len(out_shape)
    B, K = np.shape(view_valid)
    BK = B * K
    resample = exact_affine.wrapper_for(ndim, kind == "sepy")
    flat_valid = np.reshape(view_valid, BK)
    if tile_idx is None:
        data = data.reshape((BK,) + tuple(data.shape[2:]))
        src = {}
    else:
        src = {
            "tile_idx": np.reshape(tile_idx, BK),
            "starts": np.reshape(starts, (BK, ndim)),
        }
    with profiling.stage("batched.resample"):
        data_t = resample(
            data, np.reshape(mats, (BK, ndim, ndim)), np.reshape(offs, (BK, ndim)),
            np.reshape(extents, (BK, ndim)), out_shape, cval=float("nan"),
            valid=flat_valid, **src,
        ).reshape((B, K) + tuple(out_shape))
        bw = None
        if use_bw:
            wg = torch.as_tensor(wgrids, dtype=torch.float32, device=data.device)
            bw = resample(
                wg.reshape((BK,) + (5,) * ndim), np.reshape(wmats, (BK, ndim, ndim)),
                np.reshape(woffs, (BK, ndim)), np.full((BK, ndim), 5.0, np.float32),
                out_shape, cval=0.0, valid=flat_valid,
            ).reshape((B, K) + tuple(out_shape))
    with profiling.stage("batched.blend"):
        return _blend_batch(data_t, bw, mode, use_bw, out_dtype)


def _fuse_chunk_batch_kernel_exact_devtiles(
    tiles, tile_idx, starts, mats, offs, extents, wgrids, wmats, woffs,
    view_valid, out_shape, mode="weighted_average", use_bw=True, kind="sepy",
    out_dtype=torch.float32,
):
    """:func:`_fuse_chunk_batch_kernel_exact` on the device-resident (V, *T)
    tile stack: slot (b, k) samples ``tiles[tile_idx[b, k]]`` from the
    integer window start ``starts[b, k]``, with no slab copy and no f32
    copy of the stack."""
    return _fuse_chunk_batch_kernel_exact(
        tiles, mats, offs, extents, wgrids, wmats, woffs, view_valid,
        out_shape, mode, use_bw, kind, out_dtype, tile_idx=tile_idx, starts=starts,
    )


def _resample_views(stack, tile_idx, starts, extents, window, mats, offs, wgrids, wmats,
                    woffs, valid, out_shape, use_bw):
    """The gather resample of N view windows and their blending grids:
    item n reads the ``window``-shaped slab of ``stack[tile_idx[n]]`` at
    ``starts[n]``, NaN beyond ``extents[n]`` (``ops.resample.
    affine_resample_windows``), at the map ``mats[n]``, ``offs[n]``; its 5^ndim
    grid is resampled with ``cval`` 0. Items whose ``valid`` is False give NaN
    data and weight 0. Returns the (N, *out_shape) data and weights (None
    without ``use_bw``)."""
    ndim = len(out_shape)
    dev = stack.device
    data_t = resample_ops.affine_resample_windows(
        stack, tile_idx, starts, extents, window, mats, offs, out_shape, cval=float("nan"),
    )
    keep = torch.as_tensor(np.asarray(valid), device=dev).reshape((-1,) + (1,) * ndim)
    data_t = torch.where(keep, data_t, torch.nan)
    bw = None
    if use_bw:
        bw = resample_ops.affine_resample_batch(
            torch.as_tensor(np.asarray(wgrids, np.float32), device=dev), wmats, woffs,
            out_shape, cval=0.0,
        ) * keep
    return data_t, bw


def _fuse_chunk_batch_kernel_gather(stack, t, S_max, out_shape, mode, use_bw, out_dtype):
    """Fuse a batch of B chunks with up to K views each by the gather
    resample of their NaN-padded source windows (the reference's
    ``_fuse_chunk_batch_kernel``): ``stack`` is the float32 tile stack with
    its NaN kept, ``t`` the tables of :func:`_build_exact_batch` at unclamped
    starts. Returns (B, *out_shape) in ``out_dtype``."""
    B, K = t["valid"].shape
    ndim = len(out_shape)
    BK = B * K
    with profiling.stage("batched.resample"):
        data_t, bw = _resample_views(
            stack, t["tile_idx"].reshape(BK), t["starts"].reshape(BK, ndim),
            t["extents"].reshape(BK, ndim).astype(np.int64), S_max,
            t["mats"].reshape(BK, ndim, ndim), t["offs"].reshape(BK, ndim),
            t["wgrids"].reshape((BK,) + (5,) * ndim), t["wmats"].reshape(BK, ndim, ndim),
            t["woffs"].reshape(BK, ndim), t["valid"].reshape(BK), out_shape, use_bw,
        )
    split = (B, K) + tuple(out_shape)
    with profiling.stage("batched.blend"):
        return _blend_batch(data_t.reshape(split), None if bw is None else bw.reshape(split),
                            mode, use_bw, out_dtype)


def _shear_tier_enabled() -> bool:
    """``MVS_TPU_SHEAR=1`` puts the shear tier ahead of the exact-affine
    kernels, as in the reference; any other value (its ``auto`` is on only on
    a TPU) leaves it off. The one environment variable the port reads."""
    return os.environ.get("MVS_TPU_SHEAR") == "1"


def _shear_source_margin(ndim: int) -> int:
    """Extra source-window pixels when the shear tier may run: its
    interpolation support spreads about one source pixel per elementary pass
    (2D: 3 passes, 3D: 7)."""
    return (2 * ndim + 1) if _shear_tier_enabled() else 0


def _plan_shear_bundle(params, S_max, O_max, use_bw):
    """The shear tier's plans over every (entry, view) map of a chunk plan:
    ``(plan, ctx, wplan, wctx)``, the weight grids' maps planned in 4x
    refined grid coordinates; None when a map does not factor (the gather
    route then takes the plan, as in the reference)."""
    from multiview_stitcher_torch.ops import shear as shear_ops

    items = [it for kp in params for it in kp]
    res = shear_ops.plan_shear(
        np.stack([it["m"] for it in items]), np.stack([it["o"] for it in items]), S_max, O_max
    )
    if res is None:
        return None
    if not use_bw:
        return res[0], res[1], None, None
    ndim = len(O_max)
    wres = shear_ops.plan_shear(
        4.0 * np.stack([it["wm"] for it in items]), 4.0 * np.stack([it["wo"] for it in items]),
        (17,) * ndim, O_max,
    )
    if wres is None:
        return None
    return res[0], res[1], wres[0], wres[1]


def _slabs_from_stack(stack, tile_idx, starts, extents, window) -> torch.Tensor:
    """(N, *window) float32 windows of the (V, *T) ``stack``: item n reads
    ``stack[tile_idx[n]]`` from ``starts[n]`` and repeats its last sample
    beyond ``extents[n]`` on each axis, which is the host slab of the same
    window edge-padded (:func:`_pad_beyond`); float data through
    ``nan_to_num``."""
    dev = stack.device
    N = len(tile_idx)
    ndim = len(window)
    st = torch.as_tensor(np.asarray(starts), dtype=torch.int64, device=dev).reshape(N, ndim)
    ext = torch.as_tensor(np.asarray(extents), dtype=torch.int64, device=dev).reshape(N, ndim)
    idx = [torch.as_tensor(np.asarray(tile_idx), dtype=torch.int64, device=dev).reshape(
        (N,) + (1,) * ndim)]
    for d in range(ndim):
        i = torch.arange(window[d], device=dev)[None, :]
        i = st[:, d, None] + torch.minimum(i, (ext[:, d, None] - 1).clamp(min=0))
        shape = [N] + [1] * ndim
        shape[1 + d] = window[d]
        idx.append(i.reshape(shape))
    # uint16 has no gather on every device: read its bits as int16
    if stack.dtype == torch.uint16:
        return (stack.view(torch.int16)[tuple(idx)].to(torch.int32) & 0xFFFF).to(torch.float32)
    out = stack[tuple(idx)].to(torch.float32)
    return torch.nan_to_num(out) if stack.dtype.is_floating_point else out


def _fuse_chunk_batch_kernel_shear(slabs, t, bundle, out_shape, mode, use_bw, out_dtype):
    """Fuse a batch of B chunks with up to K views each through the shear
    tier (the reference's ``_fuse_chunk_batch_kernel_shear``): ``slabs``
    (B * K, *S) float32, edge-padded and free of NaN; ``t`` the tables of
    :func:`_build_exact_batch`; ``bundle`` from :func:`_plan_shear_bundle`.
    The 5^ndim weight grids are refined 4x (``refine_grid``) and resampled
    through their own plan. Returns (B, *out_shape) in ``out_dtype``."""
    from multiview_stitcher_torch.ops import shear as shear_ops

    plan, ctx, wplan, wctx = bundle
    B, K = t["valid"].shape
    ndim = len(out_shape)
    BK = B * K
    dev = slabs.device
    valid = t["valid"].reshape(BK)
    # padding slots take a real slot's maps for their coefficients: the
    # identity does not factor under a plan that permutes the axes (the
    # reference's ShearCtx raises there); the slots are masked anyway
    fill = np.where(valid, np.arange(BK), int(np.argmax(valid)))

    def coeffs(c, mats, offs):
        return c.coeffs(mats[fill], offs[fill])

    mats = t["mats"].reshape(BK, ndim, ndim)
    offs = t["offs"].reshape(BK, ndim)
    keep = torch.as_tensor(valid, device=dev).reshape((BK,) + (1,) * ndim)
    with profiling.stage("batched.resample"):
        data_t = shear_ops.shear_resample_batch(
            slabs, coeffs(ctx, mats, offs), mats, offs, t["extents"].reshape(BK, ndim), plan,
            float("nan"),
        )
        data_t = torch.where(keep, data_t, torch.nan)
        bw = None
        if use_bw:
            wmats = 4.0 * t["wmats"].reshape(BK, ndim, ndim)
            woffs = 4.0 * t["woffs"].reshape(BK, ndim)
            wg = shear_ops.refine_grid(
                torch.as_tensor(t["wgrids"].reshape((BK,) + (5,) * ndim), device=dev), 4,
                ndim=ndim,
            )
            bw = shear_ops.shear_resample_batch(
                wg, coeffs(wctx, wmats, woffs), wmats, woffs,
                np.full((BK, ndim), 17.0, np.float32), wplan, 0.0,
            ) * keep
            bw = bw.reshape((B, K) + tuple(out_shape))
    split = (B, K) + tuple(out_shape)
    with profiling.stage("batched.blend"):
        return _blend_batch(data_t.reshape(split), bw, mode, use_bw, out_dtype)


def _untrimmed_axis_positions(plan, sdims, overlap_in_pixels):
    """Per-axis start offsets of each chunk's extended region in the
    untrimmed (``trim_overlap=False``) output layout, where chunk i occupies
    ``core_shape_i + 2 * overlap`` pixels side by side."""
    sizes = [dict() for _ in sdims]
    for e in plan["per_chunk_entries"]:
        for i, d in enumerate(sdims):
            sizes[i][e["block_index"][i]] = int(e["output_bb"]["shape"][d])
    pos = []
    for i, d in enumerate(sdims):
        cum, acc = {}, 0
        for bi in sorted(sizes[i]):
            cum[bi] = acc
            acc += sizes[i][bi] + 2 * overlap_in_pixels[d]
        pos.append(cum)
    return pos


def _chunk_regions(entry, osp, sdims, untrimmed_pos):
    """(source, destination) slices of one fused chunk: its core inside its
    kernel grid (which starts at the chunk's extended origin) and in the
    output; with ``untrimmed_pos`` the whole extended region and its place in
    the untrimmed layout."""
    chunk_bb, chunk_bb_ov = entry["output_bb"], entry["output_bb_overlap"]
    src, dst = [], []
    for i, d in enumerate(sdims):
        if untrimmed_pos is not None:
            n = int(chunk_bb_ov["shape"][d])
            c0, o0 = 0, untrimmed_pos[i][entry["block_index"][i]]
        else:
            n = int(chunk_bb["shape"][d])
            c0 = int(round(
                (chunk_bb["origin"][d] - chunk_bb_ov["origin"][d]) / chunk_bb_ov["spacing"][d]
            ))
            o0 = int(round((chunk_bb["origin"][d] - osp["origin"][d]) / osp["spacing"][d]))
        src.append(slice(c0, c0 + n))
        dst.append(slice(o0, o0 + n))
    return tuple(src), tuple(dst)


def _untrimmed(trim_overlap, overlap_in_pixels, sdims) -> bool:
    return (not trim_overlap) and any(overlap_in_pixels[d] > 0 for d in sdims)


def _float_views_may_hold_nan(field_sims) -> bool:
    """The reference's guard between its exact and gather tiers: float views
    that hold NaN, and lazy float views (which cannot be scanned cheaply)."""
    if not np.issubdtype(np.dtype(field_sims[0].data.dtype), np.floating):
        return False
    return any(
        si_utils._is_lazy(s.data) or bool(np.isnan(s.data).any()) for s in field_sims
    )


# what the last batched-tier call ran: its route ("exact", "gather" or
# "shear"), the exact kernel's kind ("2d", "sepy" or "general", else None),
# whether it read host slabs, its batches and chunks, the most views of a
# chunk (K_max), the largest source window (S_max) and the bytes of the tile
# stack it read on the device (0 with host slabs)
last_batched_telemetry: dict = {}


def _execute_fusion_plan_batched(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    mode,
    use_bw,
    overlap_in_pixels,
    trim_overlap,
    blending_widths,
    shrink_distance,
    out,
    device,
):
    """Run a chunk plan for a builtin fusion function and write the chunks
    into ``out``, trimmed or, with ``trim_overlap=False`` and halos, in the
    untrimmed layout.

    Every chunk's view list is padded to K_max slots and every kernel grid
    to the plan-wide largest chunk; chunks go in batches of
    ``MAX_BATCH_ELEMENTS // (K_max * prod(S_max))`` (the reference's rule,
    S_max being the largest source window), in order. The route, as the
    reference picks it: with ``MVS_TPU_SHEAR=1`` the shear tier
    (``ops.shear``) when every map factors, else the gather route; without
    it, the gather route for float views that may hold NaN
    (:func:`_float_views_may_hold_nan`), which reads their NaN-padded
    windows so that NaN pixels drop out of each view's contribution, else
    the exact-affine kernels.

    The source: the tile stack on the device while the tiles fit
    (:func:`_tiles_fit_on_device`), the exact kernels reading it at window
    starts clamped so that an S_max window fits, the other routes at the
    unclamped starts; else host slabs, (B, K, *S_max) a batch, read window by
    window from the views (:func:`_iter_slabs`) at unclamped starts, padded
    with NaN for the gather route (float views), by edge replication for the
    shear tier and not at all for the exact kernels (which mask by the
    windows' extents, as the gather does), and uploaded in the views'
    dtype. The fused chunks are assembled on the
    device and downloaded once."""
    ndim = len(sdims)
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    if not entries:
        return
    K_max, S_max, O_max = _plan_window_shapes(entries, sdims)
    batch_size = max(1, int(MAX_BATCH_ELEMENTS // max(K_max * int(np.prod(S_max)), 1)))
    host_slabs = not _tiles_fit_on_device(field_sims)
    shear = _shear_tier_enabled()
    route = "gather" if shear or _float_views_may_hold_nan(field_sims) else "exact"
    # window starts are clamped only for the exact kernels on the stack
    stack_shape = None if route != "exact" or host_slabs else tuple(
        max(int(s.data.shape[i]) for s in field_sims) for i in range(ndim)
    )
    # the tables are kept on the (cached) plan: a repeat call skips them
    prep_key = (
        "prep:exact", stack_shape, bool(use_bw), batch_size,
        json.dumps(blending_widths, sort_keys=True, default=float),
        json.dumps(shrink_distance, sort_keys=True, default=float),
    )
    if prep_key not in plan:
        with profiling.stage("batched.tables"):
            params = exact_kernel_params(
                entries, field_sims, plan["sparams"], sdims, S_max, O_max, stack_shape,
                use_bw, blending_widths, shrink_distance,
            )
            plan[prep_key] = (params, [
                _build_exact_batch(params[i0 : i0 + batch_size], K_max, ndim, use_bw)
                for i0 in range(0, len(entries), batch_size)
            ])
    params, tables = plan[prep_key]
    bundle = _plan_shear_bundle(params, S_max, O_max, use_bw) if shear else None
    if bundle is not None:
        route = "shear"
    if route == "exact":
        kind = _exact_kind(ndim, params, use_bw)
    batches = list(zip(
        (entries[i0 : i0 + batch_size] for i0 in range(0, len(entries), batch_size)), tables
    ))
    if host_slabs:
        dtype = np.dtype(field_sims[0].data.dtype)
        pad = {"gather": "nan", "exact": None, "shear": "edge"}[route]
        if pad == "nan" and not np.issubdtype(dtype, np.floating):
            pad = None  # the gather masks by the windows' extents
        _slab_telemetry_start("batched", route, field_sims)
        units = [
            ((len(batch), K_max) + S_max,
             [((bi, vi), int(t["tile_idx"][bi, vi]), t["starts"][bi, vi],
               t["starts"][bi, vi] + t["extents"][bi, vi].astype(np.int64))
              for bi in range(len(batch)) for vi in range(K_max) if t["valid"][bi, vi]])
            for batch, t in batches
        ]
        sources = _iter_slabs(units, field_sims, dtype, pad, device)
    elif route == "exact":
        tiles = residency.tiles_to_device(field_sims, device)
        if tiles.is_cuda:
            # read as float32 once for all launches where the kernels do not
            # read the dtype (the wrappers would cast it at every launch)
            tiles = exact_affine.kernel_input(tiles)
    elif route == "gather":
        tiles = residency.tiles_to_device(field_sims, device, keep_nan=True).to(torch.float32)
    else:
        tiles = residency.tiles_to_device(field_sims, device)
    last_batched_telemetry.clear()
    last_batched_telemetry.update(
        route=route, kind=kind if route == "exact" else None, host_slabs=host_slabs,
        batches=len(batches), chunks=len(entries), K_max=K_max, S_max=S_max,
        stack_bytes=0 if host_slabs else tiles.numel() * tiles.element_size(),
    )
    out_dtype = residency.torch_dtype(out.dtype)
    out_dev = torch.zeros(out.shape, dtype=out_dtype, device=device)
    untrimmed_pos = (
        _untrimmed_axis_positions(plan, sdims, overlap_in_pixels)
        if _untrimmed(trim_overlap, overlap_in_pixels, sdims) else None
    )
    for batch, t in batches:
        B = len(batch)
        BK = B * K_max
        slabs = next(sources) if host_slabs else None
        if route == "exact" and host_slabs:
            fused = _fuse_chunk_batch_kernel_exact(
                exact_affine.kernel_input(slabs), t["mats"], t["offs"], t["extents"],
                t["wgrids"], t["wmats"], t["woffs"], t["valid"], O_max, mode, use_bw, kind,
                out_dtype,
            )
        elif route == "exact":
            fused = _fuse_chunk_batch_kernel_exact_devtiles(
                tiles, t["tile_idx"], t["starts"], t["mats"], t["offs"], t["extents"],
                t["wgrids"], t["wmats"], t["woffs"], t["valid"],
                O_max, mode, use_bw, kind, out_dtype,
            )
        elif route == "gather" and host_slabs:
            # each slab is its own source, read from its origin
            t_slabs = dict(t, tile_idx=np.arange(BK, dtype=np.int32).reshape(B, K_max),
                           starts=np.zeros_like(t["starts"]))
            fused = _fuse_chunk_batch_kernel_gather(
                slabs.reshape((BK,) + S_max).to(torch.float32), t_slabs, S_max, O_max, mode,
                use_bw, out_dtype,
            )
        elif route == "gather":
            fused = _fuse_chunk_batch_kernel_gather(
                tiles, t, S_max, O_max, mode, use_bw, out_dtype
            )
        else:
            if host_slabs:
                slabs = slabs.reshape((BK,) + S_max).to(torch.float32)
                if np.issubdtype(dtype, np.floating):
                    slabs = torch.nan_to_num(slabs)
            else:
                slabs = _slabs_from_stack(
                    tiles, t["tile_idx"].reshape(BK), t["starts"].reshape(BK, ndim),
                    t["extents"].reshape(BK, ndim), S_max,
                )
            fused = _fuse_chunk_batch_kernel_shear(
                slabs, t, bundle, O_max, mode, use_bw, out_dtype
            )
        with profiling.stage("batched.blend"):
            for bi, entry in enumerate(batch):
                src, dst = _chunk_regions(entry, output_stack_properties, sdims, untrimmed_pos)
                out_dev[dst] = fused[bi][src]
    residency.download(out_dev, out)


# ---------------------------------------------------------------------------
# tiles tier: axis-aligned plans of builtin fusion functions
# ---------------------------------------------------------------------------


def _plan_is_axis_aligned(sparams, ndim) -> bool:
    for p in sparams:
        lin = np.asarray(p)[:ndim, :ndim]
        if not np.allclose(lin, np.diag(np.diag(lin)), atol=1e-12):
            return False
        if np.any(np.diag(lin) <= 0):
            return False
    return True


def _resample_tiles(tiles, view_idx, diags, offs, wgrids, wdiags, woffs, valid, out_shape,
                    use_bw):
    """The separable resample of N whole tiles (``tiles[view_idx[n]]``) and
    their blending grids at axis-aligned maps; items whose ``valid`` is False
    give NaN data and weight 0. Returns the (N, *out_shape) data and weights
    (None without ``use_bw``)."""
    ndim = len(out_shape)
    dev = tiles.device
    keep = torch.as_tensor(valid, device=dev).reshape((-1,) + (1,) * ndim)
    data_t = resample_ops.separable_axis_aligned_resample(
        tiles[torch.as_tensor(view_idx, dtype=torch.int64, device=dev)],
        diags, offs, out_shape, cval=float("nan"),
    )
    data_t = torch.where(keep, data_t, torch.nan)
    bw = None
    if use_bw:
        bw = resample_ops.separable_axis_aligned_resample(
            torch.as_tensor(wgrids, device=dev), wdiags, woffs, out_shape, cval=0.0,
        ) * keep
    return data_t, bw


def _tiles_tier_tables(plan, entries, field_sims, output_stack_properties, sdims, K_max, O_max,
                       use_bw, blending_widths, shrink_distance):
    """The tiles tier's host tables over the non-empty ``entries`` of a chunk
    plan: (C, K_max) view indices, pixel maps and blending-weight grids, and
    which slots hold a view."""
    ndim = len(sdims)
    views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
    osp_spacing = np.array([output_stack_properties["spacing"][d] for d in sdims])
    C = len(entries)
    view_idx = np.zeros((C, K_max), dtype=np.int64)
    diags = np.ones((C, K_max, ndim), dtype=np.float32)
    offs = np.zeros((C, K_max, ndim), dtype=np.float32)
    wgrids = np.zeros((C, K_max) + (5,) * ndim, dtype=np.float32)
    wdiags = np.ones((C, K_max, ndim), dtype=np.float32)
    woffs = np.zeros((C, K_max, ndim), dtype=np.float32)
    valid = np.zeros((C, K_max), dtype=bool)
    for ci, entry in enumerate(entries):
        chunk_bb_ov = entry["output_bb_overlap"]
        kernel_bb = {
            "origin": dict(chunk_bb_ov["origin"]),
            "spacing": dict(chunk_bb_ov["spacing"]),
            "shape": {d: O_max[i] for i, d in enumerate(sdims)},
        }
        for vi, (iview, _window) in enumerate(entry["views"]):
            pm = plan["sparams"][iview]
            m, o = resample_ops.physical_to_pixel_params(
                np.linalg.inv(pm),
                input_spacing=np.array([views_bb[iview]["spacing"][d] for d in sdims]),
                input_origin=np.array([views_bb[iview]["origin"][d] for d in sdims]),
                output_spacing=osp_spacing,
                output_origin=np.array([kernel_bb["origin"][d] for d in sdims]),
            )
            view_idx[ci, vi] = iview
            diags[ci, vi] = np.diag(m)
            offs[ci, vi] = o
            valid[ci, vi] = True
            if use_bw:
                g, wm, wo = weights.blending_weights_pixel_params(
                    kernel_bb, views_bb[iview], pm,
                    blending_widths=blending_widths, shrink_distance=shrink_distance,
                )
                wgrids[ci, vi] = g
                wdiags[ci, vi] = np.diag(wm)
                woffs[ci, vi] = wo
    return view_idx, diags, offs, wgrids, wdiags, woffs, valid


def _execute_fusion_plan_tiles(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    mode,
    use_bw,
    blending_widths,
    shrink_distance,
    out,
    device,
    mesh=None,
):
    """The reference's tiles tier for axis-aligned plans of equal-shape
    tiles: the whole tiles sit on the device once (the device tile cache, as
    float32), and each chunk's views are resampled from them by the
    separable axis-aligned resample, blended over the views and cast on the
    device. Chunks go in batches of ``MAX_BATCH_ELEMENTS // (K_max *
    prod(O_max))``; the fused chunks are assembled on the device and
    downloaded once. With a sharded ``mesh`` (the reference's
    ``_fuse_chunks_tiles_map_kernel_sharded``) each entry fuses its
    contiguous slice of the chunks (:func:`~.parallel.mesh.shard_parts`:
    the reference's split of the chunk axis padded to a mesh multiple, the
    padding chunks not fused) from its device's tile stack."""
    ndim = len(sdims)
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    if not entries:
        return
    K_max = max(len(e["views"]) for e in entries)
    O_max = tuple(max(int(e["output_bb_overlap"]["shape"][d]) for e in entries) for d in sdims)
    C = len(entries)
    # the tables are kept on the (cached) plan: a repeat call skips them
    prep_key = (
        "prep:tiles", O_max, bool(use_bw),
        json.dumps(blending_widths, sort_keys=True, default=float),
        json.dumps(shrink_distance, sort_keys=True, default=float),
    )
    if prep_key not in plan:
        plan[prep_key] = _tiles_tier_tables(
            plan, entries, field_sims, output_stack_properties, sdims, K_max, O_max, use_bw,
            blending_widths, shrink_distance,
        )
    view_idx, diags, offs, wgrids, wdiags, woffs, valid = plan[prep_key]

    out_dtype = residency.torch_dtype(out.dtype)
    out_device = mesh_utils.indexed_device(device)
    parts = (
        mesh_utils.shard_parts(C, mesh) if mesh_utils.is_sharded(mesh)
        else [(slice(0, C), out_device)]
    )
    replicas = {
        d: residency.tiles_to_device(field_sims, d).to(torch.float32) for d in dict.fromkeys(
            d for _, d in parts
        )
    }
    out_dev = torch.zeros(out.shape, dtype=out_dtype, device=out_device)
    batch_size = max(1, int(MAX_BATCH_ELEMENTS // max(K_max * int(np.prod(O_max)), 1)))
    for part, d in parts:
        for c0 in range(part.start, part.stop, batch_size):
            sl = slice(c0, min(c0 + batch_size, part.stop))
            B = len(entries[sl])
            N = B * K_max
            data_t, bw = _resample_tiles(
                replicas[d], view_idx[sl].reshape(N), diags[sl].reshape(N, ndim),
                offs[sl].reshape(N, ndim), wgrids[sl].reshape((N,) + (5,) * ndim),
                wdiags[sl].reshape(N, ndim), woffs[sl].reshape(N, ndim), valid[sl].reshape(N),
                O_max, use_bw,
            )
            split = (B, K_max) + O_max
            fused = _blend_batch(data_t.reshape(split),
                                 None if bw is None else bw.reshape(split),
                                 mode, use_bw, out_dtype)
            for bi, entry in enumerate(entries[sl]):
                src, dst = _chunk_regions(entry, output_stack_properties, sdims, None)
                out_dev[dst] = fused[bi][src]
    residency.download(out_dev, out)


# ---------------------------------------------------------------------------
# host tier: fuse_np per chunk, for any fusion and weights function
# ---------------------------------------------------------------------------


def _slab_window(sim, window_bb):
    """The integer pixel window of ``window_bb`` in a tile, cut to the tile:
    (starts, stops, origin of the window)."""
    sdims = si_utils.get_spatial_dims_from_sim(sim)
    origin = si_utils.get_origin_from_sim(sim)
    spacing = si_utils.get_spacing_from_sim(sim)
    starts, stops = [], []
    for d in sdims:
        start = max(0, int(round((window_bb["origin"][d] - origin[d]) / spacing[d])))
        starts.append(start)
        stops.append(min(int(sim.sizes[d]), start + int(window_bb["shape"][d])))
    slab_origin = {d: origin[d] + starts[i] * spacing[d] for i, d in enumerate(sdims)}
    return starts, stops, slab_origin


def _fuse_views(
    stack, tile_idx, starts, extents, slab_origins, params, view_bbs, output_properties,
    sdims, *, fusion_func, fusion_func_kwargs, weights_func, weights_func_kwargs,
    trim_overlap_in_pixels, blending_widths, shrink_distance, out_dtype,
):
    """:func:`fuse_np` of K views on the device: view k is the slab of
    ``stack[tile_idx[k]]`` (float32, NaN kept) from ``starts[k]`` of shape
    ``extents[k]``, with its origin ``slab_origins[k]``. Returns the fused,
    trimmed window in ``out_dtype``, on the stack's device."""
    ndim = len(sdims)
    K = len(tile_idx)
    out_shape = tuple(int(output_properties["shape"][d]) for d in sdims)
    fusion_func_kwargs = dict(fusion_func_kwargs or {})
    weights_func_kwargs = dict(weights_func_kwargs or {})
    needs_bw = misc_utils.has_keyword(fusion_func, "blending_weights") or misc_utils.has_keyword(
        weights_func, "blending_weights"
    )
    param_mats = []
    for p in params:
        m = np.asarray(param_utils.to_xaffine(p).squeeze())
        param_mats.append(m[0] if m.ndim == 3 else m)
    osp_spacing = np.array([output_properties["spacing"][d] for d in sdims])
    osp_origin = np.array([output_properties["origin"][d] for d in sdims])
    mats = np.zeros((K, ndim, ndim), np.float32)
    offs = np.zeros((K, ndim), np.float32)
    wgrids = np.zeros((K,) + (5,) * ndim, np.float32)
    wmats = np.tile(np.eye(ndim, dtype=np.float32), (K, 1, 1))
    woffs = np.zeros((K, ndim), np.float32)
    for k in range(K):
        mats[k], offs[k] = resample_ops.physical_to_pixel_params(
            np.linalg.inv(param_mats[k]),
            input_spacing=np.array([view_bbs[k]["spacing"][d] for d in sdims]),
            input_origin=np.array([slab_origins[k][d] for d in sdims]),
            output_spacing=osp_spacing,
            output_origin=osp_origin,
        )
        if needs_bw:
            wgrids[k], wmats[k], woffs[k] = weights.blending_weights_pixel_params(
                output_properties, view_bbs[k], param_mats[k],
                blending_widths=blending_widths, shrink_distance=shrink_distance,
            )
    extents = np.asarray(extents, dtype=np.int64).reshape(K, ndim)
    window = tuple(int(x) for x in extents.max(axis=0))
    data_t, bw = _resample_views(
        stack, tile_idx, starts, extents, window, mats, offs, wgrids, wmats, woffs,
        np.ones(K, bool), out_shape, needs_bw,
    )

    builtin_mode = _BUILTIN_FUSION_MODES.get(fusion_func)
    if builtin_mode is not None and weights_func is None and not fusion_func_kwargs:
        fused, _ = _reduce_views(data_t, bw, builtin_mode, needs_bw)
    else:
        # the extension path: each function gets the inputs it names
        if needs_bw:
            bw = _normalized_bw(data_t, bw)
        fusion_func_kwargs["transformed_views"] = data_t
        if misc_utils.has_keyword(fusion_func, "params"):
            fusion_func_kwargs["params"] = params
        if needs_bw:
            fusion_func_kwargs["blending_weights"] = bw
        if (
            misc_utils.has_keyword(fusion_func, "output_spacing")
            and "output_spacing" not in fusion_func_kwargs
        ):
            fusion_func_kwargs["output_spacing"] = output_properties["spacing"]
        if weights_func is not None and misc_utils.has_keyword(fusion_func, "fusion_weights"):
            weights_func_kwargs["transformed_views"] = data_t
            if misc_utils.has_keyword(weights_func, "params"):
                weights_func_kwargs["params"] = params
            if misc_utils.has_keyword(weights_func, "blending_weights"):
                weights_func_kwargs["blending_weights"] = bw
            if (
                misc_utils.has_keyword(weights_func, "output_chunksize")
                and "output_chunksize" not in weights_func_kwargs
            ):
                weights_func_kwargs["output_chunksize"] = output_properties["shape"]
            fusion_func_kwargs["fusion_weights"] = weights_func(**weights_func_kwargs)
        fused = func_ignore_nan_warning(fusion_func, **fusion_func_kwargs)
        fused = torch.as_tensor(fused, device=data_t.device)

    trim = trim_overlap_in_pixels
    if not isinstance(trim, dict):
        trim = {d: trim for d in sdims}
    fused = fused[tuple(
        slice(trim[d], -trim[d]) if trim[d] > 0 else slice(None) for d in sdims
    )]
    return translation_fusion._cast(fused, out_dtype)


def fuse_np(
    sims: Sequence,
    params,
    output_properties: BoundingBox,
    fusion_func: Callable = weighted_average_fusion,
    fusion_func_kwargs: Optional[dict] = None,
    weights_func: Optional[Callable] = None,
    weights_func_kwargs: Optional[dict] = None,
    trim_overlap_in_pixels=0,
    interpolation_order: int = 1,
    full_view_bbs=None,
    blending_widths=None,
    shrink_distance=0,
    device=None,
) -> np.ndarray:
    """Fuse views into one output window: the extension API.

    Each view is resampled onto ``output_properties`` (linear interpolation,
    NaN outside the view and where it holds NaN; ``interpolation_order``
    only widens the source windows the fusion plan reads, as in the
    reference) and the views are fused by ``fusion_func``. A builtin fusion
    function without ``weights_func`` or ``fusion_func_kwargs`` reduces on
    the device as the batched tiers do. Any other function is called with
    the inputs it names among its parameters (a ``**kwargs`` catch-all names
    none), as tensors on the device: ``transformed_views`` (K, *window)
    float32, ``blending_weights`` (normalized), ``params``,
    ``output_spacing``, and ``fusion_weights`` from ``weights_func``, which
    is called in the same way (with ``output_chunksize`` the window's shape).
    The result is trimmed by ``trim_overlap_in_pixels`` per side, NaN set to
    0 and cast (truncating) to the views' dtype, and returned as a numpy
    array. Runs on ``device``: the CUDA device by default (raising if there
    is none), or the CPU with ``device="cpu"``."""
    device = misc_utils.resolve_device(device)
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    ndim = len(sdims)
    if full_view_bbs is None:
        full_view_bbs = [si_utils.get_stack_properties_from_sim(sim) for sim in sims]
    shapes = np.array([[int(x) for x in sim.data.shape] for sim in sims])
    window = tuple(int(x) for x in shapes.max(axis=0))
    slabs = np.full((len(sims),) + window, np.nan, dtype=np.float32)
    for i, sim in enumerate(sims):
        slabs[i][tuple(slice(0, s) for s in shapes[i])] = np.asarray(sim.data, dtype=np.float32)
    fused = _fuse_views(
        torch.from_numpy(slabs).to(device), np.arange(len(sims)), np.zeros((len(sims), ndim), int),
        shapes, [si_utils.get_origin_from_sim(sim) for sim in sims], params, full_view_bbs,
        output_properties, sdims,
        fusion_func=fusion_func, fusion_func_kwargs=fusion_func_kwargs,
        weights_func=weights_func, weights_func_kwargs=weights_func_kwargs,
        trim_overlap_in_pixels=trim_overlap_in_pixels, blending_widths=blending_widths,
        shrink_distance=shrink_distance, out_dtype=residency.torch_dtype(sims[0].data.dtype),
    )
    return fused.cpu().numpy()


def _execute_fusion_plan_host(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    fusion_func,
    fusion_func_kwargs,
    weights_func,
    weights_func_kwargs,
    overlap_in_pixels,
    trim_overlap,
    blending_widths,
    shrink_distance,
    out,
    device,
):
    """The reference's per-chunk tier: each chunk with views is fused by
    :func:`fuse_np`'s computation on its extended bounding box, from the
    views' source windows, and written trimmed, or, with
    ``trim_overlap=False`` and halos, untrimmed in the untrimmed layout.
    While the tiles fit (:func:`_tiles_fit_on_device`) the views sit on the
    device once (float32, NaN kept) and each window is read from there, which
    gives the samples the reference's host windows give; else each chunk's
    windows are read from the views on the host into a (K, *window) slab,
    uploaded in the views' dtype (:func:`_iter_slabs`, the next chunk read
    while this one fuses). The fused chunks are assembled on the device and
    downloaded once."""
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    if not entries:
        return
    views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
    chunk_windows = [
        [_slab_window(field_sims[iview], bb) for iview, bb in e["views"]] for e in entries
    ]
    host_slabs = not _tiles_fit_on_device(field_sims)
    if host_slabs:
        dtype = np.dtype(field_sims[0].data.dtype)
        _slab_telemetry_start("host", "gather", field_sims)
        units = []
        for entry, windows in zip(entries, chunk_windows):
            shape = tuple(max(w[1][i] - w[0][i] for w in windows) for i in range(len(sdims)))
            units.append(((len(windows),) + shape, [
                (k, iview, w[0], w[1]) for k, ((iview, _), w) in enumerate(zip(entry["views"], windows))
            ]))
        sources = _iter_slabs(
            units, field_sims, dtype, "nan" if np.issubdtype(dtype, np.floating) else None,
            device,
        )
    else:
        stack = residency.tiles_to_device(field_sims, device, keep_nan=True).to(torch.float32)
    out_dtype = residency.torch_dtype(out.dtype)
    out_dev = torch.zeros(out.shape, dtype=out_dtype, device=device)
    untrimmed = _untrimmed(trim_overlap, overlap_in_pixels, sdims)
    untrimmed_pos = (
        _untrimmed_axis_positions(plan, sdims, overlap_in_pixels) if untrimmed else None
    )
    trim = overlap_in_pixels if trim_overlap else {d: 0 for d in sdims}
    for entry, windows in zip(entries, chunk_windows):
        iviews = [iview for iview, _ in entry["views"]]
        starts = np.array([w[0] for w in windows])
        if host_slabs:
            # the chunk's slab stack: view k at position k, read from its origin
            stack = next(sources).to(torch.float32)
            tile_idx, starts = np.arange(len(iviews)), np.zeros_like(starts)
        else:
            tile_idx = np.array(iviews)
        fused = _fuse_views(
            stack, tile_idx, starts,
            np.array([np.subtract(w[1], w[0]) for w in windows]), [w[2] for w in windows],
            [plan["sparams"][i] for i in iviews], [views_bb[i] for i in iviews],
            entry["output_bb_overlap"], sdims,
            fusion_func=fusion_func, fusion_func_kwargs=fusion_func_kwargs,
            weights_func=weights_func, weights_func_kwargs=weights_func_kwargs,
            trim_overlap_in_pixels=trim, blending_widths=blending_widths,
            shrink_distance=shrink_distance, out_dtype=out_dtype,
        )
        if untrimmed:
            _, dst = _chunk_regions(entry, output_stack_properties, sdims, untrimmed_pos)
        else:
            # the window is trimmed to the chunk already
            _, dst = _chunk_regions(entry, output_stack_properties, sdims, None)
        out_dev[dst] = fused
    residency.download(out_dev, out)


# ---------------------------------------------------------------------------
# tier choice
# ---------------------------------------------------------------------------


def _execute_fusion_plan(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    fusion_func,
    fusion_func_kwargs,
    weights_func,
    weights_func_kwargs,
    output_chunksize,
    overlap_in_pixels,
    trim_overlap,
    interpolation_order,
    blending_widths,
    shrink_distance,
    out,
    device,
    mesh=None,
):
    """Fuse one set of spatial views into ``out`` through the tier the
    reference takes (its ``_execute_fusion_plan``), in its order: for the
    default weighted average of translation-placed views whose pixel scales
    the kernels take, the streaming or the monolithic translation tier; else
    the output is planned in chunks (``_build_spatial_fusion_plan``) and a
    builtin fusion function (without ``weights_func`` or
    ``fusion_func_kwargs``) takes the tiles tier for an axis-aligned plan of
    equal-shape tiles written trimmed, else the batched tier (the
    exact-affine kernels, or the gather route for float views that may hold
    NaN, the shear tier with ``MVS_TPU_SHEAR=1``); every other call takes the
    host tier. Lazy tiles above :data:`TILES_MAX_BYTES` that do not band skip
    the monolithic translation and the tiles tier, and the batched and host
    tiers read them as host slabs, window by window. A sharded ``mesh``
    splits the translation and the tiles tier over its entries.

    ``plan`` is the call's entry of the plan cache (``fuse()`` keys it):
    ``{"sparams": [...]}`` at first, the chunk plan added the first time a
    chunked tier needs it, so that a repeat call plans nothing."""
    ndim = len(sdims)
    param_mats = plan["sparams"]
    builtin_mode = _BUILTIN_FUSION_MODES.get(fusion_func)
    builtin = builtin_mode is not None and weights_func is None and not fusion_func_kwargs
    untrimmed = _untrimmed(trim_overlap, overlap_in_pixels, sdims)
    if (
        builtin_mode == "weighted_average" and builtin and not untrimmed
        and _plan_is_translation(param_mats, ndim)
    ):
        scale = _views_output_scale(field_sims, output_stack_properties, sdims)
        scales = (
            None if scale is not None
            else _views_output_scales_per_view(field_sims, output_stack_properties, sdims)
        )
        if (scale is not None or scales is not None) and _fuse_translation_views(
            plan, field_sims, output_stack_properties, sdims,
            scale=scale, scales=scales, blending_widths=blending_widths,
            shrink_distance=shrink_distance, out=out, device=device,
            output_chunksize=output_chunksize, mesh=mesh,
        ):
            return

    if "per_chunk_entries" not in plan:
        with profiling.stage("fuse.plan"):
            views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
            chunk_bbs, block_indices = mv_graph.get_chunk_bbs(
                output_stack_properties, output_chunksize
            )
            plan.update(_build_spatial_fusion_plan(
                sparams=param_mats,
                views_bb=views_bb,
                output_stack_properties=output_stack_properties,
                output_chunksize=output_chunksize,
                output_chunk_bbs=chunk_bbs,
                output_chunk_bbs_with_overlap=[
                    _extend_bb(bb, overlap_in_pixels) for bb in chunk_bbs
                ],
                block_indices=block_indices,
                overlap_in_pixels=overlap_in_pixels,
                interpolation_order=interpolation_order,
                sdims=sdims,
                extra_source_margin_in_pixels=_shear_source_margin(ndim),
            ))
    common = dict(blending_widths=blending_widths, shrink_distance=shrink_distance,
                  out=out, device=device)
    if not builtin:
        _execute_fusion_plan_host(
            plan, field_sims, output_stack_properties, sdims,
            fusion_func=fusion_func, fusion_func_kwargs=fusion_func_kwargs,
            weights_func=weights_func, weights_func_kwargs=weights_func_kwargs,
            overlap_in_pixels=overlap_in_pixels, trim_overlap=trim_overlap, **common,
        )
        return
    use_bw = misc_utils.has_keyword(fusion_func, "blending_weights")
    if (
        not untrimmed
        and len({tuple(s.data.shape) for s in field_sims}) == 1
        and _tiles_fit_on_device(field_sims)
        and _plan_is_axis_aligned(param_mats, ndim)
    ):
        _execute_fusion_plan_tiles(
            plan, field_sims, output_stack_properties, sdims,
            mode=builtin_mode, use_bw=use_bw, mesh=mesh, **common,
        )
        return
    _execute_fusion_plan_batched(
        plan, field_sims, output_stack_properties, sdims,
        mode=builtin_mode, use_bw=use_bw, overlap_in_pixels=overlap_in_pixels,
        trim_overlap=trim_overlap, **common,
    )


def _tile_bytes(field_sims) -> int:
    return sum(int(np.prod(s.data.shape)) * np.dtype(s.data.dtype).itemsize for s in field_sims)


def _tiles_fit_on_device(field_sims) -> bool:
    """In-memory tiles always go to the device; lazy ones up to
    :data:`TILES_MAX_BYTES`."""
    return all(not si_utils._is_lazy(s.data) for s in field_sims) or (
        _tile_bytes(field_sims) <= TILES_MAX_BYTES
    )


def fuse(
    images: Sequence = None,
    transform_key: str = None,
    fusion_func: Callable = weighted_average_fusion,
    fusion_func_kwargs: Optional[dict] = None,
    weights_func: Optional[Callable] = None,
    weights_func_kwargs: Optional[dict] = None,
    output_spacing: Optional[Dict[str, float]] = None,
    output_stack_mode: str = "union",
    output_origin: Optional[Dict[str, float]] = None,
    output_shape: Optional[Dict[str, int]] = None,
    output_stack_properties: Optional[BoundingBox] = None,
    output_chunksize: Optional[Union[int, Dict[str, int]]] = None,
    overlap_in_pixels: Optional[Union[int, Dict[str, int]]] = None,
    trim_overlap: bool = True,
    interpolation_order: int = 1,
    blending_widths: Optional[Dict[str, float]] = None,
    output_zarr_url: Optional[str] = None,
    zarr_options: Optional[dict] = None,
    batch_options: Optional[dict] = None,
    backend: Optional[str] = None,
    output_on_backend: bool = False,
    sims: Optional[Sequence] = None,
    mesh=None,
    device=None,
):
    """Fuse views into a single image.

    ``fusion_func`` is a builtin (``weighted_average_fusion``, the default,
    ``max_fusion``, ``simple_average_fusion``) or any function of the
    resampled views, and ``weights_func`` (with ``weights_func_kwargs``) any
    function that gives it ``fusion_weights``; see :func:`fuse_np` for how
    each is called. The chunks of ``output_chunksize`` are fused with the
    halo the functions declare (``overlap_in_pixels`` overrides it); with
    ``trim_overlap=False`` and a halo each chunk's extended region is kept,
    chunks side by side, and the output's origin is the first chunk's first
    halo pixel. ``interpolation_order`` only widens the source windows the
    chunks read, as in the reference: views are resampled linearly. The
    module docstring says which tier takes which call. Views may hold numpy
    arrays or lazy zarr arrays (``io.zarr_backend``). Returns a Sim in the
    input dtype with an identity affine under ``transform_key``: in host
    memory, or, with ``output_zarr_url``, backed by the zarr array written
    there. Given msims (:class:`~.msi_utils.Msim`), it returns an msim (see
    :func:`_fuse_msims`; ``output_origin``, ``output_shape`` and
    ``output_stack_properties`` are not read then, as in the reference).
    ``zarr_options``: ``ome_zarr`` (default True: an OME-Zarr
    with level 0 at ``{url}/0``, its pyramid and metadata; False: a plain
    array at ``url``), ``ngff_version`` ("0.4": zarr v2; "0.5": zarr v3),
    ``create_output`` (default True; False writes into the array already
    there), ``overwrite`` (default True) and ``zarr_array_creation_kwargs``
    (for example a v2 ``compressor``, or ``shards`` at 0.5: level 0 sharded,
    each shard a multiple of the chunks and the granularity of the streaming
    tier's band writes). The output's zarr chunks are ``output_chunksize``,
    1 on each non-spatial dim; the values do not depend on the layout.

    The fusion runs on ``device``: the CUDA device by default (raising if
    there is none), or the CPU with ``device="cpu"``, which takes the
    kernels' plain PyTorch versions. ``backend`` is the reference's array
    library: None, "numpy" or "torch" (the computation is torch's either
    way). With ``output_on_backend=True`` an in-memory output is a torch
    tensor on ``device`` (msims and zarr outputs are not affected, as in the
    reference). ``sims`` is the deprecated name of ``images``;
    ``batch_options`` is accepted and not read, as in the reference.

    ``mesh`` (a :class:`~.parallel.mesh.Mesh`) of more than one entry
    shards the translation and the tiles tier over its entries (see the
    module docstring); without ``device`` the call runs on the mesh's first
    device, which holds the output. The result equals the unsharded one.
    """
    if backend not in (None, "numpy", "torch"):
        raise ValueError(
            f"Unsupported backend {backend!r}: this package computes on torch; "
            "use backend=None and output_on_backend to control the result placement."
        )
    if images is None:
        if sims is None:
            raise TypeError("fuse() missing required argument 'images'")
        warnings.warn(
            "The fuse(..., sims=...) parameter is deprecated; use images=... instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        images = sims
    elif sims is not None:
        raise TypeError("fuse() got both 'images' and deprecated 'sims'. Use only 'images'.")
    mesh, device = mesh_utils.resolve(mesh, device)
    if not len(images):
        raise ValueError("images must contain at least one image.")
    input_is_msim = [msi_utils.is_msim(im) for im in images]
    if any(input_is_msim) and not all(input_is_msim):
        raise ValueError("All input images must be of the same kind (all sims or all msims).")
    if all(input_is_msim):
        return _fuse_msims(
            images,
            transform_key=transform_key,
            fusion_func=fusion_func,
            fusion_func_kwargs=fusion_func_kwargs,
            weights_func=weights_func,
            weights_func_kwargs=weights_func_kwargs,
            output_spacing=output_spacing,
            output_stack_mode=output_stack_mode,
            output_chunksize=output_chunksize,
            overlap_in_pixels=overlap_in_pixels,
            trim_overlap=trim_overlap,
            interpolation_order=interpolation_order,
            blending_widths=blending_widths,
            output_zarr_url=output_zarr_url,
            zarr_options=zarr_options,
            mesh=mesh,
            device=device,
        )
    zarr_options = dict(zarr_options or {})
    ngff_version = zarr_options.get("ngff_version", "0.4")
    sims_in = list(images)
    sdims = si_utils.get_spatial_dims_from_sim(sims_in[0])
    nsdims = si_utils.get_nonspatial_dims_from_sim(sims_in[0])
    ndim = len(sdims)

    # spatial-only views for output geometry
    field_sims0 = [
        si_utils.sim_sel_coords(sim, {nd: sim.coords[nd][0] for nd in nsdims})
        if nsdims
        else sim
        for sim in sims_in
    ]
    output_stack_properties = process_output_stack_properties(
        field_sims0,
        output_spacing=output_spacing,
        output_origin=output_origin,
        output_shape=output_shape,
        output_stack_properties=output_stack_properties,
        output_stack_mode=output_stack_mode,
        transform_key=transform_key,
    )
    output_stack_properties = {
        "shape": {d: int(output_stack_properties["shape"][d]) for d in sdims},
        "spacing": {d: float(output_stack_properties["spacing"][d]) for d in sdims},
        "origin": {d: float(output_stack_properties["origin"][d]) for d in sdims},
    }
    output_chunksize = process_output_chunksize(sims_in, output_chunksize)

    # the halo: what the fusion and the weights functions declare
    required_overlap = misc_utils.get_required_overlap(fusion_func, fusion_func_kwargs or {})
    if weights_func is not None:
        wreq = misc_utils.get_required_overlap(
            weights_func, dict(weights_func_kwargs or {}, output_chunksize=output_chunksize)
        )
        required_overlap = max(
            np.max(list(wreq.values())) if isinstance(wreq, dict) else wreq,
            np.max(list(required_overlap.values()))
            if isinstance(required_overlap, dict) else required_overlap,
        )
    if overlap_in_pixels is None:
        overlap_in_pixels = required_overlap
    if not isinstance(overlap_in_pixels, dict):
        overlap_in_pixels = {d: int(overlap_in_pixels) for d in sdims}
    overlap_in_pixels = {
        d: int(min(overlap_in_pixels[d], output_chunksize[d])) for d in sdims
    }
    shrink_distance = misc_utils.get_required_source_shrinkage(
        fusion_func, fusion_func_kwargs or {}
    )

    ns_coord_lists = {nd: np.asarray(sims_in[0].coords[nd]) for nd in nsdims}
    for nd, vals in ns_coord_lists.items():
        if len(np.unique(vals)) != len(vals):
            raise ValueError(
                f"duplicate {nd!r} coordinates {vals.tolist()} in the "
                "fusion input; give each entry a distinct coordinate "
                f"(e.g. sim.coords[{nd!r}] = range(n)) before fusing."
            )
    ns_combos = (
        list(product(*[ns_coord_lists[nd] for nd in nsdims])) if nsdims else [()]
    )
    # trim_overlap=False with halos keeps each chunk's halo: chunk i occupies
    # its extended region, chunks side by side
    untrimmed = _untrimmed(trim_overlap, overlap_in_pixels, sdims)
    if untrimmed:
        spatial_out_shape = tuple(
            sum(c + 2 * overlap_in_pixels[d] for c in chunks_d)
            for d, chunks_d in zip(sdims, mv_graph.normalize_chunks(
                [output_chunksize[d] for d in sdims],
                [output_stack_properties["shape"][d] for d in sdims],
            ))
        )
        # the layout's grid: anchored at the first chunk's first halo pixel
        sink_stack_properties = {
            "shape": dict(zip(sdims, spatial_out_shape)),
            "spacing": dict(output_stack_properties["spacing"]),
            "origin": {
                d: output_stack_properties["origin"][d]
                - overlap_in_pixels[d] * output_stack_properties["spacing"][d]
                for d in sdims
            },
        }
    else:
        spatial_out_shape = tuple(output_stack_properties["shape"][d] for d in sdims)
        sink_stack_properties = output_stack_properties
    out_full_shape = tuple(len(ns_coord_lists[nd]) for nd in nsdims) + spatial_out_shape
    out_dtype = np.dtype(sims_in[0].dtype)
    ome_zarr = zarr_options.get("ome_zarr", True)
    if output_zarr_url is None and output_on_backend:
        output_array = torch.zeros(out_full_shape, dtype=residency.torch_dtype(out_dtype),
                                   device=device)
    elif output_zarr_url is None:
        output_array = np.zeros(out_full_shape, dtype=out_dtype)
    else:
        # fused regions go straight into the zarr array, nothing is
        # assembled in memory
        level0_url = f"{output_zarr_url}/0" if ome_zarr else str(output_zarr_url)
        # one zarr chunk a fused chunk (with its halo in the untrimmed layout),
        # so that region writes stay chunk-aligned
        halo = overlap_in_pixels if untrimmed else {d: 0 for d in sdims}
        zarr_chunks = tuple(1 for _ in nsdims) + tuple(
            min(output_chunksize[d] + 2 * halo[d], spatial_out_shape[i])
            for i, d in enumerate(sdims)
        )
        if zarr_options.get("create_output", True):
            output_array = zarr_backend.create_zarr_array(
                level0_url,
                shape=out_full_shape,
                chunks=zarr_chunks,
                dtype=out_dtype,
                zarr_format=ngff_utils._zarr_format(ngff_version),
                overwrite=zarr_options.get("overwrite", True),
                **(zarr_options.get("zarr_array_creation_kwargs") or {}),
            )
        else:
            output_array = zarr_backend.attach_zarr_array(level0_url)

    for combo in ns_combos:
        sel = dict(zip(nsdims, combo))
        field_sims = [
            si_utils.sim_sel_coords(sim, sel) if sel else sim for sim in sims_in
        ]
        param_mats = []
        for s in field_sims:
            m = np.asarray(
                si_utils.get_affine_from_sim(s, transform_key=transform_key).squeeze()
            )
            param_mats.append(m[0] if m.ndim == 3 else m)
        # plans are cached module-wide, keyed on the geometry (the reference's
        # key): a repeat call over the same views, output and chunking plans
        # nothing
        plan_key = (
            tuple(np.asarray(m).tobytes() for m in param_mats),
            tuple(
                (
                    tuple(s.data.shape),
                    tuple(float(si_utils.get_spacing_from_sim(s)[d]) for d in sdims),
                    tuple(float(si_utils.get_origin_from_sim(s)[d]) for d in sdims),
                )
                for s in field_sims
            ),
            json.dumps(output_stack_properties, sort_keys=True, default=float),
            tuple(sorted(output_chunksize.items())),
            tuple(sorted(overlap_in_pixels.items())),
            int(interpolation_order),
            _shear_source_margin(ndim),
        )
        if plan_key not in _plan_cache:
            _plan_cache_insert(plan_key, {"sparams": param_mats})
        plan = _plan_cache[plan_key]
        ns_idx = tuple(
            int(np.where(ns_coord_lists[nd] == c)[0][0]) for nd, c in zip(nsdims, combo)
        )
        out = (
            output_array[ns_idx] if isinstance(output_array, (np.ndarray, torch.Tensor))
            else _PrefixedSink(output_array, ns_idx)
        )
        _execute_fusion_plan(
            plan,
            field_sims,
            output_stack_properties,
            sdims,
            fusion_func=fusion_func,
            fusion_func_kwargs=fusion_func_kwargs,
            weights_func=weights_func,
            weights_func_kwargs=weights_func_kwargs,
            output_chunksize=output_chunksize,
            overlap_in_pixels=overlap_in_pixels,
            trim_overlap=trim_overlap,
            interpolation_order=interpolation_order,
            blending_widths=blending_widths,
            shrink_distance=shrink_distance,
            out=out,
            device=device,
            mesh=mesh,
        )

    if output_zarr_url is not None and ome_zarr:
        ngff_utils.finalize_ome_zarr_levels(
            output_zarr_url,
            dims=tuple(nsdims) + tuple(sdims),
            stack_properties=sink_stack_properties,
            ngff_version=ngff_version,
            c_coords=ns_coord_lists.get("c"),
            device=device,
        )
        out_sim = ngff_utils.read_sim_from_ome_zarr(output_zarr_url)
    else:
        out_sim = si_utils.to_spatial_image(
            output_array if output_zarr_url is None
            else zarr_backend.open_zarr_array(str(output_zarr_url)),
            dims=tuple(nsdims) + tuple(sdims),
            scale=sink_stack_properties["spacing"],
            translation=dict(sink_stack_properties["origin"]),
            t_coords=ns_coord_lists.get("t"),
            c_coords=ns_coord_lists.get("c"),
        )
    si_utils.set_sim_affine(
        out_sim,
        param_utils.identity_transform(ndim, t_coords=ns_coord_lists.get("t")),
        transform_key=transform_key,
    )
    return out_sim


def _fuse_msims(msims, output_spacing=None, output_stack_mode="union", output_zarr_url=None,
                zarr_options=None, **kwargs):
    """Multiscale fusion. The output's level 0 has the geometry of the
    union (or ``output_stack_mode``) of the views at ``output_spacing`` (by
    default level 0's spacing); its pyramid is :func:`calc_resolution_levels`'
    plan of that shape, each level's origin moved by ``(factor - 1) / 2 *
    spacing``. Each output level is fused by :func:`fuse` from the input
    level that ``get_res_level_from_spacing`` picks for its spacing, through
    the tier that level takes. Returns an msim in memory; with
    ``output_zarr_url``, only level 0 is fused, into the store (an OME-Zarr
    with its pyramid unless ``zarr_options["ome_zarr"]`` is False), and the
    result is the store read back as a lazy msim of every level where
    ``zarr_options["ome_zarr"]`` is set, as the reference does, else a
    one-level msim over the fused level 0."""
    transform_key = kwargs.get("transform_key")
    sims0 = [msi_utils.get_sim_from_msim(m, scale="scale0") for m in msims]
    sdims = si_utils.get_spatial_dims_from_sim(sims0[0])
    if output_spacing is None:
        output_spacing = si_utils.get_spacing_from_sim(sims0[0])
    props0 = process_output_stack_properties(
        [
            si_utils.sim_sel_coords(s, {nd: s.coords[nd][0] for nd in s.nsdims}) if s.nsdims
            else s
            for s in sims0
        ],
        output_spacing=output_spacing,
        output_stack_mode=output_stack_mode,
        transform_key=transform_key,
    )
    if output_zarr_url is not None:
        selected = [
            msi_utils.get_sim_from_msim(
                m, scale=msi_utils.get_res_level_from_spacing(m, props0["spacing"])
            )
            for m in msims
        ]
        fused = fuse(
            selected,
            output_stack_properties={k: dict(props0[k]) for k in ("shape", "spacing", "origin")},
            output_zarr_url=output_zarr_url,
            zarr_options=zarr_options,
            **kwargs,
        )
        if (zarr_options or {}).get("ome_zarr", False):
            return ngff_utils.read_msim_from_ome_zarr(
                output_zarr_url,
                transform_key=(
                    transform_key if transform_key is not None else si_utils.DEFAULT_TRANSFORM_KEY
                ),
            )
        return msi_utils.get_msim_from_sim(fused, scale_factors=[])

    shapes, _, abs_factors = msi_utils.calc_resolution_levels(
        {d: int(props0["shape"][d]) for d in sdims}
    )
    out_sims = []
    for level, abs_factor in enumerate(abs_factors):
        level_spacing = {d: float(props0["spacing"][d]) * abs_factor[d] for d in sdims}
        level_props = {
            "shape": shapes[level],
            "spacing": level_spacing,
            "origin": {
                d: float(props0["origin"][d])
                + (abs_factor[d] - 1) / 2 * float(props0["spacing"][d])
                for d in sdims
            },
        }
        level_inputs = [
            msi_utils.get_sim_from_msim(
                m, scale=msi_utils.get_res_level_from_spacing(m, level_spacing)
            )
            for m in msims
        ]
        out_sims.append(fuse(level_inputs, output_stack_properties=level_props, **kwargs))
    return msi_utils.Msim(sims=out_sims)


def prepare_block_fusion(
    output_zarr_url: str,
    fuse_kwargs: dict,
    zarr_array_creation_kwargs: dict = None,
    create_output: bool = True,
    overwrite: bool = True,
    verbose: bool = False,
):
    """Prepare the fusion of one zarr v2 array block by block, for workers
    that each fuse a disjoint set of blocks into the shared array.

    ``fuse_kwargs`` are :func:`fuse`'s, with the views under ``images`` (or
    ``sims``). The array's blocks are the output chunks
    (``output_chunksize``), one a non-spatial coordinate. With
    ``create_output=False`` the array already at ``output_zarr_url`` is
    attached to (a second worker's call). Returns ``{"func":
    fuse_block(block_id), "nblocks": [...], "output_stack_properties":
    ...}``: ``block_id`` indexes the non-spatial dims, then the spatial block
    grid; ``fuse_block`` fuses that block's box with :func:`fuse` (on the
    device ``fuse_kwargs`` name, the CUDA device by default), writes it and
    returns the block id.
    """
    fuse_kwargs = dict(fuse_kwargs)
    sims = fuse_kwargs.pop("images", None)
    if sims is None:
        sims = fuse_kwargs.pop("sims", None)
    if sims is None:
        raise ValueError("fuse_kwargs must carry 'images' (or 'sims')")
    transform_key = fuse_kwargs.get("transform_key")
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    nsdims = [d for d in sims[0].dims if d not in sdims]
    ns_coord_lists = {nd: np.asarray(sims[0].coords[nd]) for nd in nsdims}

    osp = process_output_stack_properties(
        [si_utils.get_sim_field(s) for s in sims],
        output_stack_properties=fuse_kwargs.pop("output_stack_properties", None),
        output_spacing=fuse_kwargs.pop("output_spacing", None),
        output_origin=fuse_kwargs.pop("output_origin", None),
        output_shape=fuse_kwargs.pop("output_shape", None),
        output_stack_mode=fuse_kwargs.pop("output_stack_mode", "union"),
        transform_key=transform_key,
    )
    osp = {
        k: {d: (int(v[d]) if k == "shape" else float(v[d])) for d in sdims}
        for k, v in osp.items()
    }
    output_chunksize = process_output_chunksize(sims, fuse_kwargs.pop("output_chunksize", None))

    full_shape = [len(ns_coord_lists[d]) for d in nsdims] + [osp["shape"][d] for d in sdims]
    full_chunks = [1] * len(nsdims) + [
        min(int(output_chunksize[d]), osp["shape"][d]) for d in sdims
    ]
    normalized = mv_graph.normalize_chunks(full_chunks, full_shape)
    nblocks = [len(nc) for nc in normalized]
    block_offsets = [np.cumsum((0,) + tuple(nc[:-1])) for nc in normalized]
    if verbose:
        print(
            f"Fusing into an output stack: shape={full_shape} spacing={osp['spacing']} "
            f"origin={osp['origin']} nblocks={nblocks}"
        )

    if create_output:
        output_array = zarr_backend.create_zarr_array(
            str(output_zarr_url),
            shape=tuple(full_shape),
            chunks=tuple(full_chunks),
            dtype=np.dtype(sims[0].dtype),
            zarr_format=2,
            overwrite=overwrite,
            **(zarr_array_creation_kwargs or {}),
        )
    else:
        output_array = zarr_backend.attach_zarr_array(str(output_zarr_url))

    def fuse_block(block_id):
        block_id = tuple(int(b) for b in block_id)
        if len(block_id) != len(nblocks):
            raise ValueError(
                f"block_id {block_id} must index {len(nblocks)} dims (nblocks={nblocks})"
            )
        sel = {nd: ns_coord_lists[nd][block_id[i]] for i, nd in enumerate(nsdims)}
        block_sims = [si_utils.sim_sel_coords(s, sel) if sel else s for s in sims]
        spatial_ids = block_id[len(nsdims):]
        starts = [int(block_offsets[len(nsdims) + j][b]) for j, b in enumerate(spatial_ids)]
        sizes = [int(normalized[len(nsdims) + j][b]) for j, b in enumerate(spatial_ids)]
        block_props = {
            "origin": {
                d: osp["origin"][d] + osp["spacing"][d] * starts[j] for j, d in enumerate(sdims)
            },
            "spacing": dict(osp["spacing"]),
            "shape": {d: sizes[j] for j, d in enumerate(sdims)},
        }
        fused = fuse(
            block_sims,
            output_stack_properties=block_props,
            output_chunksize=output_chunksize,
            **fuse_kwargs,
        )
        region = tuple(slice(b, b + 1) for b in block_id[: len(nsdims)]) + tuple(
            slice(s, s + z) for s, z in zip(starts, sizes)
        )
        output_array[region] = fused.to_numpy().reshape([1] * len(nsdims) + sizes)
        return block_id

    return {"func": fuse_block, "nblocks": nblocks, "output_stack_properties": osp}


def fuse_to_zarr(*args, **kwargs):
    """Deprecated: use ``fuse(..., output_zarr_url=<path>)``."""
    warnings.warn(
        "fuse_to_zarr() is deprecated. Use fuse(..., output_zarr_url=<path>) instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    raise RuntimeError(
        "fuse_to_zarr() is deprecated. Please call fuse(..., output_zarr_url=<path>) instead."
    )


def fuse_to_multiscale_ome_zarr(*args, **kwargs):
    """Deprecated: use ``fuse(..., output_zarr_url=...,
    zarr_options={'ome_zarr': True})``."""
    warnings.warn(
        "fuse_to_multiscale_ome_zarr() is deprecated. Use "
        "fuse(..., output_zarr_url=<path>, zarr_options={'ome_zarr': True}) instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    raise RuntimeError(
        "fuse_to_multiscale_ome_zarr() is deprecated. Please call "
        "fuse(..., output_zarr_url=<path>, zarr_options={'ome_zarr': True}) instead."
    )


def func_ignore_nan_warning(func, *args, **kwargs):
    """Call ``func`` with numpy's all-NaN and empty-slice warnings silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings(action="ignore", message="All-NaN slice encountered")
        warnings.filterwarnings(action="ignore", message="Mean of empty slice")
        return func(*args, **kwargs)


def get_interpolated_image(
    image: np.ndarray,
    mask: np.ndarray = None,
    method: str = "nearest",
    fill_value: int = 0,
):
    """Fill the masked (missing) pixels of a 2D image by interpolating from
    the known ones (scipy's ``griddata``, on the host).

    ``mask``: True marks missing pixels; by default ``isnan(image)``.
    ``fill_value`` fills outside the convex hull of the known pixels for
    "linear" and "cubic" (no effect for "nearest")."""
    from scipy import interpolate

    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError(f"get_interpolated_image takes 2D images, got {image.ndim}D")
    if mask is None:
        mask = np.isnan(image)
    mask = np.asarray(mask, dtype=bool)
    if mask.min() or not mask.any():
        return image
    filled = image.copy()
    filled[mask] = interpolate.griddata(
        np.argwhere(~mask), image[~mask], np.argwhere(mask), method=method,
        fill_value=fill_value,
    )
    return filled
