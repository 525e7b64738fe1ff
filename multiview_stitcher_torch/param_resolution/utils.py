"""Shared helpers of groupwise resolution: virtual beads from the overlap
boxes of registration edges, edge residuals, graph introspection.

Copy of ``multiview_stitcher_tpu.param_resolution.utils`` on this package's
:class:`~multiview_stitcher_torch.mv_graph.Graph`. An edge's ``transform``
maps the lower-indexed view's world coordinates into the higher-indexed
view's; global params map view world coordinates into the shared frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from multiview_stitcher_torch import mv_graph, param_utils
from multiview_stitcher_torch.param_utils import XAffine


def _edge_transform_matrix(value) -> np.ndarray:
    """Plain (ndim+1, ndim+1) matrix of an edge or param entry."""
    if not isinstance(value, XAffine):
        return np.asarray(value, dtype=float)
    m = value.squeeze()
    return m if m.ndim == 2 else m[0]


def get_graph_ndim(g_reg) -> int:
    """Spatial dimensionality of a registration graph: from an edge
    transform, else from a node's stack_props."""
    for _u, _v, data in g_reg.edges(data=True):
        return _edge_transform_matrix(data["transform"]).shape[-1] - 1
    for _node, data in g_reg.nodes(data=True):
        spacing = data.get("stack_props", {}).get("spacing")
        if spacing is not None:
            return len(spacing)
    raise ValueError("Cannot determine dimensionality from graph.")


def get_graph_timepoints(g_reg) -> list:
    """Sorted union of the t coordinates of the edge transforms."""
    ts: set = set()
    for _u, _v, data in g_reg.edges(data=True):
        tf = data.get("transform")
        if isinstance(tf, XAffine) and tf.has_t:
            ts.update(np.asarray(tf.t_coords).tolist())
    return sorted(ts)


def get_reg_graph_with_single_tp_transforms(g_reg, t):
    """A copy of ``g_reg`` with every time-varying edge attribute narrowed
    to timepoint ``t``: its affines, and a per-t quality array aligned with
    the edge transform's t axis."""
    out = g_reg.copy()
    for _u, _v, data in out.edges(data=True):
        tf = data.get("transform")
        t_axis = np.asarray(tf.t_coords) if isinstance(tf, XAffine) and tf.has_t else None
        for key in list(data):
            val = data[key]
            if isinstance(val, XAffine) and val.has_t:
                data[key] = val.sel_t(t)
            elif key == "quality" and np.ndim(val) > 0 and t_axis is not None:
                data[key] = np.asarray(val).ravel()[int(np.flatnonzero(t_axis == t)[0])]
    return out


@dataclass
class EdgeBeads:
    """Virtual beads of one registration edge: the overlap-box corners in
    both incident views' world frames."""

    u: int
    v: int
    pts_u: np.ndarray
    pts_v: np.ndarray
    quality: float
    overlap: float


def _bbox_corners(bbox) -> np.ndarray:
    lower, upper = np.asarray(bbox, dtype=float)
    corners = np.stack(
        np.meshgrid(*[(lo, hi) for lo, hi in zip(lower, upper)], indexing="ij"), axis=-1
    )
    return corners.reshape(-1, lower.shape[0])


def iter_edge_beads(g_reg):
    """An :class:`EdgeBeads` per edge of a single-timepoint graph."""
    for u, v, data in g_reg.edges(data=True):
        u, v = sorted((u, v))
        corners = _bbox_corners(np.asarray(data["bbox"], dtype=float))
        mat = _edge_transform_matrix(data["transform"])
        q = np.asarray(data.get("quality", 1.0), dtype=float)
        yield EdgeBeads(
            u=u,
            v=v,
            pts_u=corners,
            pts_v=param_utils.transform_pts(corners, mat),
            quality=float(np.nanmean(q)) if np.isfinite(q).any() else np.nan,
            overlap=float(data.get("overlap", 1.0)),
        )


def get_beads_graph_from_reg_graph(g_reg_subgraph, ndim: int) -> mv_graph.Graph:
    """Bead graph of the global optimiser: an edge per registration edge
    with both point sets, node affines starting at identity."""
    g = mv_graph.Graph()
    g.add_nodes_from(g_reg_subgraph.nodes)
    for eb in iter_edge_beads(g_reg_subgraph):
        g.add_edge(eb.u, eb.v, beads={eb.u: eb.pts_u, eb.v: eb.pts_v}, quality=eb.quality,
                   overlap=eb.overlap)
    identity = np.eye(ndim + 1)
    for node in g.nodes:
        g.nodes[node]["affine"] = identity.copy()
    return g


def compute_edge_residuals(g_reg, params, ndim=None) -> dict:
    """Per-edge RMS distance between the two bead sets under the global
    params, for all edges in one batch. ``ndim`` is not read: the points
    give it."""
    edge_beads = list(iter_edge_beads(g_reg))
    if not edge_beads:
        return {}
    pts_u = np.stack([eb.pts_u for eb in edge_beads])
    pts_v = np.stack([eb.pts_v for eb in edge_beads])
    mats_u = np.stack([_edge_transform_matrix(params[eb.u]) for eb in edge_beads])
    mats_v = np.stack([_edge_transform_matrix(params[eb.v]) for eb in edge_beads])

    def apply(mats, pts):
        nd = pts.shape[-1]
        return np.einsum("eij,epj->epi", mats[:, :nd, :nd], pts) + mats[:, None, :nd, nd]

    delta = apply(mats_u, pts_u) - apply(mats_v, pts_v)
    rms = np.sqrt(np.mean(np.sum(delta**2, axis=-1), axis=-1))
    return {(eb.u, eb.v): float(r) for eb, r in zip(edge_beads, rms)}
