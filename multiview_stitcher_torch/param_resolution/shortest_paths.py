"""Shortest-path groupwise resolution: chain pairwise transforms along
quality-weighted shortest paths from a reference view.

Copy of ``multiview_stitcher_tpu.param_resolution.shortest_paths`` on this
package's graph.
"""

from __future__ import annotations

import numpy as np

from multiview_stitcher_torch import mv_graph, param_utils
from multiview_stitcher_torch.param_resolution.utils import _edge_transform_matrix, get_graph_ndim


def _mean_quality(data) -> float:
    return float(np.mean(np.asarray(data["quality"], dtype=float)))


def groupwise_resolution_shortest_paths(g_reg, reference_view=None, **_ignored):
    """Per-view params of one connected component at one timepoint, by
    composing edge transforms along paths weighted ``1 / (0.5 + quality -
    min_quality)``; the reference view defaults to the one with the largest
    summed edge quality."""
    ndim = get_graph_ndim(g_reg)
    if not g_reg.number_of_edges():
        return (
            {n: param_utils.identity_transform(ndim) for n in g_reg.nodes},
            {"metrics": None, "used_edges": []},
        )
    q = {tuple(sorted(e)): _mean_quality(g_reg.edges[e]) for e in g_reg.edges}
    q_floor = min(q.values())
    for e, qe in q.items():
        g_reg.edges[e]["quality_mean"] = qe
        g_reg.edges[e]["quality_mean_inv"] = 1.0 / (0.5 + qe - q_floor)
    ref_node = (
        reference_view
        if reference_view is not None and reference_view in g_reg.nodes
        else mv_graph.get_node_with_maximal_edge_weight_sum_from_graph(
            g_reg, weight_key="quality_mean"
        )
    )

    def hop_cost(a, b, _data):
        return 1.0 / (0.5 + q[tuple(sorted((a, b)))] - q_floor)

    paths = mv_graph.single_source_dijkstra_path(g_reg, ref_node, weight=hop_cost)
    fwd = {e: _edge_transform_matrix(g_reg.edges[e]["transform"]) for e in q}
    used_edges: set = set()
    resolved = {}
    for node, path in paths.items():
        chain = np.eye(ndim + 1)
        for a, b in zip(path[:-1], path[1:]):
            key = tuple(sorted((a, b)))
            used_edges.add(key)
            hop = fwd[key] if (a, b) == key else np.linalg.inv(fwd[key])
            chain = hop @ chain
        # chain maps the reference frame into the node's frame; the node's
        # param is its inverse
        resolved[node] = param_utils.affine_to_xaffine(np.linalg.inv(chain))
    return resolved, {"metrics": None, "used_edges": sorted(used_edges)}
