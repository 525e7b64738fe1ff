"""Fusion core: ``fuse`` of translation-placed tile grids.

The port of ``multiview_stitcher_tpu.fusion._core`` for the library's main
path: a grid of translation-placed 2D or 3D tiles fused with the default
weighted-average blending. Planning (output geometry, per-view kernel
tables, per-tile view lists) is host-side numpy, as in the reference; the
fusion itself is one call of the translation kernel over the whole output
(``ops.translation_fusion``).

Unlike the reference, which streams inputs above 192 MB through banded
calls, the port runs the whole output in one call whenever it is given the
tiles in memory: the main path's 537 MB of tiles fit the H100's 80 GB, and
banded calls agree with one call over the full grid.

Any input this slice does not cover raises ``NotImplementedError`` naming
the ROADMAP.md item that will cover it; nothing falls back quietly.
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from multiview_stitcher_torch import msi_utils, param_utils, si_utils, weights
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.ops import translation_fusion
from multiview_stitcher_torch.utils import misc as misc_utils

BoundingBox = Dict[str, Dict[str, Union[float, int]]]

# where the inputs this slice refuses are queued
_ROADMAP = "ROADMAP.md, queue 1"


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


_BUILTIN_FUSION_MODES = {weighted_average_fusion: "weighted_average"}


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


def _edge_pad(view: torch.Tensor, shape) -> torch.Tensor:
    """Pad ``view`` at its far ends to ``shape`` by repeating its last
    row/column/plane (numpy's ``mode="edge"``), for any dtype."""
    out = view.new_empty(shape)
    out[tuple(slice(0, s) for s in view.shape)] = view
    for d, (s, m) in enumerate(zip(view.shape, shape)):
        if m > s:
            src = [slice(None)] * len(shape)
            dst = [slice(None)] * len(shape)
            src[d], dst[d] = slice(s - 1, s), slice(s, m)
            out[tuple(dst)] = out[tuple(src)]
    return out


def _tiles_to_device(field_sims, device) -> torch.Tensor:
    """(V, *tile) stack of the views on ``device`` in their native dtype.

    Float tiles get ``nan_to_num`` before the upload. Mixed tile shapes are
    uploaded as they are, one group per shape, and edge-padded on the device
    to the common maximum shape; the kernels mask each view by its true
    extents."""

    def put(arrays):
        stack = np.stack([np.asarray(a) for a in arrays])
        if np.issubdtype(stack.dtype, np.floating):
            stack = np.nan_to_num(stack)
        return torch.from_numpy(stack).to(device)

    shapes = [tuple(int(x) for x in s.data.shape) for s in field_sims]
    if len(set(shapes)) == 1:
        return put([s.data for s in field_sims])
    max_shape = tuple(max(s[i] for s in shapes) for i in range(len(shapes[0])))
    groups: dict = {}
    for i, shp in enumerate(shapes):
        groups.setdefault(shp, []).append(i)
    tiles = None
    for idxs in groups.values():
        dev = put([field_sims[i].data for i in idxs])
        if tiles is None:
            tiles = torch.empty(
                (len(field_sims),) + max_shape, dtype=dev.dtype, device=dev.device
            )
        for slot, i in enumerate(idxs):
            tiles[i] = _edge_pad(dev[slot], max_shape)
    return tiles


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _download(fused: torch.Tensor, out: np.ndarray) -> None:
    """Copy the fused output into the host array ``out``."""
    if out.flags.c_contiguous:
        torch.from_numpy(out).copy_(fused)
    else:
        out[...] = fused.cpu().numpy()


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
):
    """The whole output in one translation-kernel call with per-tile view
    lists. ``scale`` is the per-dim output-pixel -> view-pixel scale shared
    by all views; ``scales`` the (V, ndim) per-view variant."""
    ndim = len(sdims)
    tile_shape = (
        translation_fusion.TILE_SHAPE_3D if ndim == 3 else translation_fusion.TILE_SHAPE_2D
    )
    out_shape = tuple(int(output_stack_properties["shape"][d]) for d in sdims)
    views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
    if scales is not None:
        scale_arr = np.asarray(scales, dtype=np.float64)
        # the per-dim max stands where the reference sized its windows; the
        # kernels read the true per-view scales
        scale = tuple(float(x) for x in scale_arr.max(axis=0))
    else:
        scale_arr = np.asarray(scale, dtype=np.float64)
    offs, extents, wdiags, woffs, wgrids = translation_kernel_params(
        plan, views_bb, output_stack_properties, sdims,
        blending_widths, shrink_distance, scale_arr,
    )
    view_idx = tile_view_lists(offs, extents, scale_arr, out_shape, tile_shape)

    tiles = _tiles_to_device(field_sims, device)
    fuse_fn = (
        translation_fusion.fuse_translation_3d
        if ndim == 3
        else translation_fusion.fuse_translation_2d
    )
    kscale = scale
    if ndim == 3:
        kscale = (int(np.ceil(scale[0])),) + tuple(scale[1:])
    fused = fuse_fn(
        tiles, view_idx, offs, extents, wdiags, woffs, wgrids,
        out_shape=out_shape, tile_shape=tile_shape, K=view_idx.shape[-1],
        out_dtype=_torch_dtype(out.dtype),
        scale=kscale,
        scales=None if scales is None else np.asarray(scales, np.float32),
    )
    _download(fused, out)


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fuse runs on the CUDA device by default and this machine has "
            "none; pass device='cpu' for the plain PyTorch path"
        )
    return device


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
    device=None,
):
    """Fuse translation-placed views into a single image.

    Returns a Sim holding the fused output in host memory, in the input
    dtype, with an identity affine under ``transform_key``. The fusion runs
    on ``device``: the CUDA device by default (raising if there is none),
    or the CPU with ``device="cpu"``, which takes the kernels' plain
    PyTorch versions.
    """
    device = _resolve_device(device)
    if images is None or not len(images):
        raise ValueError("images must contain at least one image.")
    if any(msi_utils.is_msim(im) for im in images):
        raise NotImplementedError(f"fusing msims is not ported yet ({_ROADMAP}: msims)")
    if output_zarr_url is not None:
        raise NotImplementedError(
            f"fusing into zarr is not ported yet ({_ROADMAP}: zarr output, "
            "item 4 streaming zarr fusion)"
        )
    if (
        _BUILTIN_FUSION_MODES.get(fusion_func) != "weighted_average"
        or fusion_func_kwargs
        or weights_func is not None
    ):
        raise NotImplementedError(
            "only the default weighted_average_fusion without weights_func "
            f"or fusion_func_kwargs is ported ({_ROADMAP}: item 10, the "
            "other fusion tiers)"
        )
    if interpolation_order != 1:
        raise NotImplementedError(
            f"the translation tier interpolates linearly ({_ROADMAP}: item 10)"
        )

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

    if overlap_in_pixels is None:
        overlap_in_pixels = misc_utils.get_required_overlap(
            fusion_func, fusion_func_kwargs or {}
        )
    if not isinstance(overlap_in_pixels, dict):
        overlap_in_pixels = {d: int(overlap_in_pixels) for d in sdims}
    overlap_in_pixels = {
        d: int(min(overlap_in_pixels[d], output_chunksize[d])) for d in sdims
    }
    if not trim_overlap and any(overlap_in_pixels[d] > 0 for d in sdims):
        raise NotImplementedError(
            "trim_overlap=False with halos (per-chunk extended layout) is "
            f"not ported yet ({_ROADMAP}: item 10)"
        )
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
    spatial_out_shape = tuple(output_stack_properties["shape"][d] for d in sdims)
    out_full_shape = tuple(len(ns_coord_lists[nd]) for nd in nsdims) + spatial_out_shape
    output_array = np.zeros(out_full_shape, dtype=np.dtype(sims_in[0].dtype))

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
        if not _plan_is_translation(param_mats, ndim):
            raise NotImplementedError(
                "only translation-placed views are ported; rotated, scaled "
                f"or sheared views need the exact-affine kernels ({_ROADMAP}: "
                "item 10, and queue 2 kernels 3-5)"
            )
        scale = _views_output_scale(field_sims, output_stack_properties, sdims)
        scales = (
            None
            if scale is not None
            else _views_output_scales_per_view(field_sims, output_stack_properties, sdims)
        )
        if scale is None and scales is None:
            raise NotImplementedError(
                "view -> output pixel scales above 8 need the other fusion "
                f"tiers ({_ROADMAP}: item 10)"
            )
        ns_idx = tuple(
            int(np.where(ns_coord_lists[nd] == c)[0][0]) for nd, c in zip(nsdims, combo)
        )
        _execute_fusion_plan_translation(
            {"sparams": param_mats},
            field_sims,
            output_stack_properties,
            sdims,
            blending_widths=blending_widths,
            shrink_distance=shrink_distance,
            out=output_array[ns_idx],
            device=device,
            scale=scale,
            scales=scales,
        )

    out_sim = si_utils.to_spatial_image(
        output_array,
        dims=tuple(nsdims) + tuple(sdims),
        scale=output_stack_properties["spacing"],
        translation=dict(output_stack_properties["origin"]),
        t_coords=ns_coord_lists.get("t"),
        c_coords=ns_coord_lists.get("c"),
    )
    si_utils.set_sim_affine(
        out_sim,
        param_utils.identity_transform(ndim, t_coords=ns_coord_lists.get("t")),
        transform_key=transform_key,
    )
    return out_sim
