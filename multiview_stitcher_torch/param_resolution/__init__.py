"""Groupwise parameter resolution: the method registry and the resolution of
one transform per view from a pairwise registration graph.

The port of ``multiview_stitcher_tpu.param_resolution``, on this package's
:class:`~multiview_stitcher_torch.mv_graph.Graph` and without pandas:
``info["metrics"]`` is a dict of numpy columns with the reference
DataFrame's column names. A graph whose edge transforms vary over ``t`` is
resolved one timepoint at a time; each connected component is resolved on
its own, in the order of its first node.

Resolver contract: ``resolver(g_component, **kwargs) -> (params_by_node,
info_or_None)``, where info may carry ``metrics`` and ``used_edges``.
"""

from __future__ import annotations

import numpy as np

from multiview_stitcher_torch import mv_graph, param_utils
from multiview_stitcher_torch.param_resolution.global_optimization import (
    groupwise_resolution_global_optimization,
)
from multiview_stitcher_torch.param_resolution.linear_two_pass import (
    groupwise_resolution_linear_two_pass,
)
from multiview_stitcher_torch.param_resolution.shortest_paths import (
    groupwise_resolution_shortest_paths,
)
from multiview_stitcher_torch.param_resolution.utils import (
    compute_edge_residuals,
    get_graph_ndim,
    get_graph_timepoints,
    get_reg_graph_with_single_tp_transforms,
)
from multiview_stitcher_torch.param_utils import XAffine

_RESOLVER_REGISTRY: dict = {}


def register_groupwise_resolution_method(name, resolver=None):
    """Add a resolver to the registry under ``name``; usable directly or as
    a decorator."""
    if resolver is None:
        def _decorator(f):
            register_groupwise_resolution_method(name, f)
            return f

        return _decorator
    if not callable(resolver):
        raise TypeError("Resolver must be callable.")
    _RESOLVER_REGISTRY[name] = resolver
    return resolver


def _lookup_resolver(method):
    if callable(method):
        return method
    try:
        return _RESOLVER_REGISTRY[method]
    except KeyError:
        raise ValueError(f"Unknown groupwise optimization method: {method}") from None


def _concat_metrics(frames):
    """Row-wise concatenation of metric tables (dicts of equal-length
    columns)."""
    if not frames:
        return None
    return {k: np.concatenate([np.asarray(f[k]) for f in frames]) for k in frames[0]}


def _resolve_one_timepoint(g_t, resolver, resolver_kwargs):
    """The resolver over every connected component of a graph of one
    timepoint: (params_by_node, metric tables with their component index,
    used edges, edge residuals)."""
    params: dict = {}
    frames = []
    used: set = set()
    for icc, comp in enumerate(mv_graph.connected_components(g_t)):
        sub = g_t.subgraph(list(comp))
        if sub.number_of_edges() == 0:
            ident = param_utils.identity_transform(get_graph_ndim(sub))
            params.update({node: ident for node in comp})
            continue
        comp_params, info = resolver(sub, **resolver_kwargs)
        params.update({node: comp_params[node] for node in comp})
        if not info:
            continue
        df = info.get("metrics")
        if df is not None:
            df = dict(df)
            if "icc" not in df:
                n = len(next(iter(df.values()))) if df else 0
                df["icc"] = np.full(n, icc)
            frames.append(df)
        used.update(tuple(sorted(e)) for e in (info.get("used_edges") or []))
    residuals = compute_edge_residuals(g_t, params)
    return params, frames, used, residuals


def groupwise_resolution(g_reg, method="global_optimization", **kwargs):
    """Resolve global per-view params from a pairwise registration graph.

    ``method`` is a registry name ('global_optimization', 'shortest_paths',
    'linear_two_pass')
    or a resolver callable; the other kwargs go to it. Returns
    ``(params_by_node, info)``: params stacked over t (``XAffine`` with
    ``t_coords``) when the edge transforms carry timepoints; info holding the
    per-edge residuals and used edges keyed by timepoint index (0 without t)
    and the resolvers' metrics, with a ``t`` column when resolved over t."""
    if g_reg.number_of_edges() == 0:
        raise mv_graph.NotEnoughOverlapError("Not enough overlap between views for stitching.")
    resolver = _lookup_resolver(method)
    # a two-view graph follows the [fixed, moving] convention: anchor the
    # lower-indexed view unless the caller chose a reference
    if len(g_reg.nodes) == 2:
        kwargs.setdefault("reference_view", min(g_reg.nodes))

    t_coords = get_graph_timepoints(g_reg)
    per_t_params = []
    all_frames = []
    edge_residuals: dict = {}
    used_edges: dict = {}
    for it, t in enumerate(t_coords or [None]):
        g_t = g_reg if t is None else get_reg_graph_with_single_tp_transforms(g_reg, t)
        params_t, frames, used, residuals = _resolve_one_timepoint(g_t, resolver, kwargs)
        if t is not None:
            for df in frames:
                df["t"] = np.full(len(df["icc"]), t)
        per_t_params.append(params_t)
        all_frames.extend(frames)
        edge_residuals[it] = residuals
        used_edges[it] = sorted(used)

    if t_coords:
        params = {
            node: XAffine(
                np.stack([np.asarray(p[node].squeeze()) for p in per_t_params]),
                t_coords=np.asarray(t_coords),
            )
            for node in g_reg.nodes
        }
    else:
        params = per_t_params[0]
    info = {
        "metrics": _concat_metrics(all_frames),
        "edge_residuals": edge_residuals,
        "used_edges": used_edges,
    }
    return params, info


register_groupwise_resolution_method(
    "global_optimization", groupwise_resolution_global_optimization
)
register_groupwise_resolution_method("shortest_paths", groupwise_resolution_shortest_paths)
register_groupwise_resolution_method("linear_two_pass", groupwise_resolution_linear_two_pass)

__all__ = [
    "groupwise_resolution",
    "groupwise_resolution_global_optimization",
    "groupwise_resolution_linear_two_pass",
    "groupwise_resolution_shortest_paths",
    "register_groupwise_resolution_method",
]
