"""Chunk grids and back-projected overlap windows (host-side planning).

Copy of the chunk-planning functions of ``multiview_stitcher_tpu.mv_graph``.
The view adjacency graph (networkx) stays in the JAX package until
registration is ported.
"""

from __future__ import annotations

from itertools import product
from typing import Dict, Optional, Sequence, Union

import numpy as np

from multiview_stitcher_torch import param_utils, si_utils

BoundingBox = Dict[str, Dict[str, Union[float, int]]]


def _props_arrays(stack_props):
    sdims = [d for d in si_utils.SPATIAL_DIMS if d in stack_props["origin"]]
    shape = np.array([stack_props["shape"][d] for d in sdims], dtype=float)
    spacing = np.array([stack_props["spacing"][d] for d in sdims], dtype=float)
    origin = np.array([stack_props["origin"][d] for d in sdims], dtype=float)
    return sdims, shape, spacing, origin


def get_vertices_from_stack_props(stack_props) -> np.ndarray:
    """Pixel-center corner vertices in world coordinates."""
    sdims, shape, spacing, origin = _props_arrays(stack_props)
    corners = np.array(list(np.ndindex(tuple([2] * len(sdims)))), dtype=float)
    vertices = corners * (shape - 1) * spacing + origin
    if "transform" in stack_props:
        mat = np.asarray(param_utils.to_xaffine(stack_props["transform"]).data)
        vertices = param_utils.transform_pts(vertices, mat[0] if mat.ndim == 3 else mat)
    return vertices


def normalize_chunks(chunksizes: Sequence, shape: Sequence[int]):
    """Split each dim of ``shape`` into chunk extents (last may be smaller)."""
    out = []
    for cs, s in zip(chunksizes, shape):
        if isinstance(cs, (list, tuple)):
            if sum(cs) != s:
                raise ValueError(f"explicit chunks {cs} != size {s}")
            out.append(tuple(int(c) for c in cs))
        else:
            cs = int(min(cs, s))
            n_full, rem = divmod(int(s), cs)
            out.append((cs,) * n_full + ((rem,) if rem else ()))
    return tuple(out)


def get_chunk_bbs(array_bb: BoundingBox, chunksizes: Dict[str, Union[int, list]]):
    """Chunk bounding boxes + block indices for an output grid."""
    spatial_dims = sorted(array_bb["origin"].keys())[::-1]
    normalized = normalize_chunks(
        [chunksizes[d] for d in spatial_dims],
        [array_bb["shape"][d] for d in spatial_dims],
    )
    block_indices = list(product(*(range(len(bds)) for bds in normalized)))
    block_offsets = [np.cumsum((0,) + bds[:-1]) for bds in normalized]
    chunk_bbs = [
        {
            "origin": {
                d: array_bb["origin"][d]
                + array_bb["spacing"][d] * block_offsets[idim][bi[idim]]
                for idim, d in enumerate(spatial_dims)
            },
            "shape": {
                d: normalized[idim][bi[idim]] for idim, d in enumerate(spatial_dims)
            },
            "spacing": dict(array_bb["spacing"]),
        }
        for bi in block_indices
    ]
    return chunk_bbs, block_indices


def get_overlap_for_bbs(
    target_bb: BoundingBox,
    query_bbs: Sequence[BoundingBox],
    param,
    additional_extent_in_pixels: Optional[Dict[str, int]] = None,
    tol: float = 1e-6,
    param_is_inverse: bool = False,
):
    """Back-project a target chunk bbox into each query (tile) frame and clip.

    Returns per query either None (no overlap) or the source window bbox.
    ``param`` maps query -> target world coordinates (a view param); pass
    its inverse with ``param_is_inverse``.
    """
    ndim = len(target_bb["origin"])
    spatial_dims = si_utils.SPATIAL_DIMS[-ndim:]
    if additional_extent_in_pixels is None:
        additional_extent_in_pixels = {d: 0 for d in spatial_dims}

    param_mat = np.asarray(param_utils.to_xaffine(param).squeeze())
    if param_mat.ndim == 3:
        param_mat = param_mat[0]
    inv_param = param_mat if param_is_inverse else np.linalg.inv(param_mat)
    corners_query = param_utils.transform_pts(
        get_vertices_from_stack_props(target_bb), inv_param
    )
    cq_min = corners_query.min(axis=0)
    cq_max = corners_query.max(axis=0)

    overlap_bbs = []
    for query_bb in query_bbs:
        sp = query_bb["spacing"]
        q_lo = query_bb["origin"]
        q_hi = {d: q_lo[d] + (query_bb["shape"][d] - 1) * sp[d] for d in spatial_dims}
        bp_origin = {
            d: cq_min[i] - additional_extent_in_pixels[d] * sp[d]
            for i, d in enumerate(spatial_dims)
        }
        bp_shape = {
            d: int(np.ceil((cq_max[i] - cq_min[i]) / sp[d]))
            + 1
            + 2 * additional_extent_in_pixels[d]
            for i, d in enumerate(spatial_dims)
        }
        bp_hi = {d: bp_origin[d] + (bp_shape[d] - 1) * sp[d] for d in spatial_dims}
        if any(bp_origin[d] - tol > q_hi[d] for d in spatial_dims) or any(
            bp_hi[d] < q_lo[d] - tol for d in spatial_dims
        ):
            overlap_bbs.append(None)
            continue
        ov_origin = {d: max(bp_origin[d], q_lo[d]) for d in spatial_dims}
        ov_shape = {
            d: int(np.ceil((min(bp_hi[d], q_hi[d]) - ov_origin[d]) / sp[d])) + 1
            for d in spatial_dims
        }
        if any(ov_shape[d] < 1 for d in spatial_dims):
            overlap_bbs.append(None)
            continue
        overlap_bbs.append(
            {"origin": ov_origin, "shape": ov_shape, "spacing": dict(sp)}
        )
    return overlap_bbs
