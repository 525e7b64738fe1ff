"""Linear two-pass groupwise resolution (Laplacian least squares).

The port of ``multiview_stitcher_tpu.param_resolution.linear_two_pass`` on
this package's :class:`~multiview_stitcher_torch.mv_graph.Graph` and numpy
columns instead of networkx and pandas: pairwise affines are
polar-decomposed, rotations linearised (omega_ij ~ omega_i - omega_j), and
rotations then translations solved as sparse weighted incidence least
squares (scipy's ``lsqr``); edges whose residual exceeds an absolute or
median + k * MAD threshold are dropped, a minimum spanning tree of the
residuals keeping the graph connected, and the system is solved again.
Nodes and edges are taken in the graph's (networkx's) order, which fixes
``lsqr``'s column and row order.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import lsqr
from scipy.spatial.transform import Rotation

from multiview_stitcher_torch import mv_graph, param_utils
from multiview_stitcher_torch.param_resolution.utils import (
    _edge_transform_matrix,
    compute_edge_residuals,
    get_graph_ndim,
)

_LSQR_KEYS = {"damp", "atol", "btol", "conlim", "iter_lim", "show", "calc_var"}


def _edge_weight(edge_data, weight_mode: str) -> float:
    quality = float(np.mean(np.asarray(edge_data.get("quality", 1.0), dtype=float)))
    overlap = float(np.mean(np.asarray(edge_data.get("overlap", 1.0), dtype=float)))
    if weight_mode == "quality_overlap":
        w = quality * overlap
    elif weight_mode == "quality":
        w = quality
    elif weight_mode == "overlap":
        w = overlap
    elif weight_mode == "uniform":
        w = 1.0
    else:
        raise ValueError(f"Unknown weight_mode: {weight_mode}")
    return w if np.isfinite(w) and w >= 0 else 0.0


def _closest_rotation(linear: np.ndarray) -> np.ndarray:
    u, _s, vt = np.linalg.svd(linear)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def _rot_to_vec(rmat: np.ndarray, ndim: int) -> np.ndarray:
    if ndim == 2:
        return np.array([np.arctan2(rmat[1, 0], rmat[0, 0])])
    return Rotation.from_matrix(rmat).as_rotvec()


def _vec_to_rot(rotvec: np.ndarray, ndim: int) -> np.ndarray:
    if ndim == 2:
        theta = float(rotvec[0])
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, -s], [s, c]])
    return Rotation.from_rotvec(rotvec).as_matrix()


def _bbox_center(edge_data, ndim: int) -> np.ndarray:
    bbox = edge_data.get("bbox")
    if bbox is None:
        return np.zeros(ndim)
    bbox = np.asarray(bbox, dtype=float)
    if bbox.shape[0] < 2:
        return np.zeros(ndim)
    return np.mean(bbox[:2], axis=0)


def _solve_incidence(edges, nodes, ref_node, dim, rhs_fn, prior_lambda, lsqr_kwargs):
    """Weighted incidence least squares ``x_u - x_v ~ rhs(edge)`` with the
    reference node fixed at 0, assembled as one sparse matrix."""
    slot = {}
    idx = 0
    for node in nodes:
        if node == ref_node:
            continue
        slot[node] = idx
        idx += dim
    n_params = idx
    values = {node: np.zeros(dim) for node in nodes}
    if not edges or n_params == 0:
        return values

    E = len(edges)
    u_start = np.array([slot.get(e["u"], -1) for e in edges], dtype=np.int64)
    v_start = np.array([slot.get(e["v"], -1) for e in edges], dtype=np.int64)
    scales = np.sqrt(np.array([e["weight"] for e in edges], dtype=float))
    rhs = np.array([rhs_fn(e) for e in edges], dtype=float)
    row_base = np.arange(E, dtype=np.int64)[:, None] * dim + np.arange(dim)
    b = (scales[:, None] * rhs).ravel()

    rows_list, cols_list, data_list = [], [], []
    for starts, sign in ((u_start, 1.0), (v_start, -1.0)):
        mask = starts >= 0
        rows_list.append(row_base[mask].ravel())
        cols_list.append((starts[mask, None] + np.arange(dim)).ravel())
        data_list.append(np.repeat(sign * scales[mask], dim))
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    data = np.concatenate(data_list)
    n_rows = E * dim
    if prior_lambda > 0:
        s = float(np.sqrt(prior_lambda))
        rows = np.concatenate([rows, n_rows + np.arange(n_params)])
        cols = np.concatenate([cols, np.arange(n_params)])
        data = np.concatenate([data, np.full(n_params, s)])
        b = np.concatenate([b, np.zeros(n_params)])
        n_rows += n_params

    mat = sparse.coo_matrix((data, (rows, cols)), shape=(n_rows, n_params)).tocsr()
    sol = lsqr(mat, b, **lsqr_kwargs)[0]
    for node, start in slot.items():
        values[node] = sol[start:start + dim]
    return values


def groupwise_resolution_linear_two_pass(
    g_reg_component_tp,
    reference_view=None,
    transform: str = "rigid",
    residual_threshold=None,
    mad_k: float = 2.0,
    keep_mst: bool = True,
    weight_mode: str = "quality_overlap",
    prior_lambda: float = 0.0,
    **kwargs,
):
    """Resolve one ``transform`` ("translation" or "rigid") per node of a
    connected registration graph in two linear passes. Returns (params by
    node, info) with ``info["metrics"]`` the per-edge columns ``u``, ``v``,
    ``weight``, ``residual`` and ``kept_pass2`` and ``info["used_edges"]``
    the edges of the second pass. ``mode`` is taken for ``transform``; the
    kwargs that ``lsqr`` names go to it."""
    if "mode" in kwargs:
        transform = kwargs.pop("mode")
    g = g_reg_component_tp
    if not g.number_of_edges():
        ndim = get_graph_ndim(g)
        return {n: param_utils.identity_transform(ndim) for n in g.nodes}, {
            "metrics": None, "used_edges": [],
        }
    if transform not in ("translation", "rigid"):
        raise ValueError(f"Unknown transform: {transform}")
    ndim = get_graph_ndim(g)
    if ndim not in (2, 3):
        raise ValueError("Only 2D and 3D supported.")
    use_rot = transform == "rigid"
    rot_dim = 1 if ndim == 2 else 3

    if reference_view is not None and reference_view in g:
        ref_node = reference_view
    else:
        ref_node = mv_graph.get_node_with_maximal_edge_weight_sum_from_graph(
            g, weight_key="quality"
        )
    nodes = list(g.nodes)

    edges = []
    for edge in g.edges:
        sorted_e = tuple(sorted(edge))
        affine = _edge_transform_matrix(g.edges[sorted_e]["transform"])
        center = _bbox_center(g.edges[edge], ndim)
        linear = affine[:ndim, :ndim]
        dvec = affine[:ndim, ndim]
        rot_uv = None
        if use_rot:
            rmat = _closest_rotation(linear)
            rot_uv = _rot_to_vec(rmat, ndim)
            # the translational mismatch at the overlap centre, rotation removed
            dvec = (linear @ center + dvec) - (rmat @ center)
        else:
            dvec = (linear @ center + dvec) - center
        edges.append({
            "u": sorted_e[0], "v": sorted_e[1], "trans": dvec, "rot": rot_uv,
            "weight": _edge_weight(g.edges[edge], weight_mode),
        })
    lsqr_kwargs = {k: v for k, v in kwargs.items() if k in _LSQR_KEYS}

    def solve_pass(edge_list):
        if use_rot:
            rot_vecs = _solve_incidence(
                edge_list, nodes, ref_node, rot_dim, lambda e: e["rot"], prior_lambda,
                lsqr_kwargs,
            )
        else:
            rot_vecs = {n: np.zeros(rot_dim) for n in nodes}

        def trans_rhs(e):
            if not use_rot:
                return e["trans"]
            return _vec_to_rot(rot_vecs[e["v"]], ndim) @ e["trans"]

        translations = _solve_incidence(
            edge_list, nodes, ref_node, ndim, trans_rhs, prior_lambda, lsqr_kwargs
        )
        return translations, rot_vecs

    def build_params(translations, rotations):
        params = {}
        for node in nodes:
            M = np.eye(ndim + 1)
            M[:ndim, :ndim] = _vec_to_rot(rotations[node], ndim) if use_rot else np.eye(ndim)
            M[:ndim, ndim] = translations[node]
            params[node] = param_utils.affine_to_xaffine(M)
        return params

    t1, r1 = solve_pass(edges)
    residuals_by_edge = compute_edge_residuals(g, build_params(t1, r1))
    residuals = np.asarray(
        [residuals_by_edge.get(tuple(sorted((e["u"], e["v"]))), np.nan) for e in edges],
        dtype=float,
    )
    finite = residuals[np.isfinite(residuals)]
    if residual_threshold is not None:
        threshold = float(residual_threshold)
    elif finite.size:
        median = float(np.median(finite))
        mad = float(np.median(np.abs(finite - median)))
        threshold = median + float(mad_k) * mad
    else:
        threshold = np.inf
    residuals_inf = np.where(np.isfinite(residuals), residuals, np.inf)
    keep_mask = residuals_inf <= threshold

    kept_edges = set()
    if keep_mst:
        mst_graph = mv_graph.Graph()
        for edge, res in zip(edges, residuals_inf):
            mst_graph.add_edge(edge["u"], edge["v"], weight=res)
        kept_edges.update(tuple(sorted(e)) for e in mv_graph.minimum_spanning_edges(mst_graph))

    kept_pass2 = []
    final_edges = []
    for edge, keep in zip(edges, keep_mask):
        key = tuple(sorted((edge["u"], edge["v"])))
        keep_edge = bool(keep) or key in kept_edges
        kept_pass2.append(keep_edge)
        if keep_edge:
            final_edges.append(edge)
            kept_edges.add(key)
    if not final_edges:
        final_edges = edges
        kept_edges = {tuple(sorted((e["u"], e["v"]))) for e in edges}
        kept_pass2 = [True] * len(edges)

    t2, r2 = solve_pass(final_edges)
    metrics = {
        "u": np.asarray([e["u"] for e in edges]),
        "v": np.asarray([e["v"] for e in edges]),
        "weight": np.asarray([e["weight"] for e in edges], dtype=float),
        "residual": residuals,
        "kept_pass2": np.asarray(kept_pass2, dtype=bool),
    }
    return build_params(t2, r2), {"metrics": metrics, "used_edges": list(kept_edges)}
