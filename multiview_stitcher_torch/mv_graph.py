"""Overlap geometry, the view adjacency graph and chunk grids (host-side
planning).

Copy of ``multiview_stitcher_tpu.mv_graph`` for what registration and fusion
run, on a small undirected :class:`Graph` of this package's own instead of
networkx (which the card's machine does not have). The graph keeps
networkx's dict-of-dicts layout and iteration orders (nodes and each node's
neighbours in insertion order, ``copy`` re-inserting edges as networkx
does), and the algorithms registration calls (connected components, edge
betweenness, greedy colouring, degree centrality, Dijkstra paths, Kruskal's
spanning forest, the edge subgraph, the in-place relabelling) follow
networkx's traversal orders, so that ties break as they do in the reference.
"""

from __future__ import annotations

import heapq
import warnings
from collections import deque
from functools import lru_cache
from itertools import chain, count, product
from typing import Dict, Optional, Sequence, Union

import numpy as np
from scipy.optimize import linprog
from scipy.spatial import ConvexHull, HalfspaceIntersection, QhullError, cKDTree

from multiview_stitcher_torch import msi_utils, param_utils, si_utils
from multiview_stitcher_torch.utils.misc import threshold_otsu

BoundingBox = Dict[str, Dict[str, Union[float, int]]]


class NotEnoughOverlapError(Exception):
    pass


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


class _NodeView:
    def __init__(self, g):
        self._g = g

    def __iter__(self):
        return iter(self._g._node)

    def __len__(self):
        return len(self._g._node)

    def __contains__(self, n):
        return n in self._g._node

    def __getitem__(self, n):
        return self._g._node[n]

    def __call__(self, data=False):
        if data:
            return list(self._g._node.items())
        return list(self._g._node)


class _EdgeView:
    def __init__(self, g):
        self._g = g

    def _iter(self, data, nbunch=None):
        adj = self._g._adj
        nodes = adj if nbunch is None else [n for n in nbunch if n in adj]
        seen = set()
        for n in nodes:
            for nbr, dd in adj[n].items():
                if nbr not in seen:
                    yield (n, nbr, dd) if data else (n, nbr)
            seen.add(n)

    def __iter__(self):
        return self._iter(False)

    def __call__(self, nbunch=None, data=False):
        if nbunch is not None and nbunch in self._g._adj:
            nbunch = [nbunch]
        return list(self._iter(data, nbunch))

    def __getitem__(self, e):
        return self._g._adj[e[0]][e[1]]


class Graph:
    """Undirected graph with node and edge attribute dicts, in networkx's
    layout: ``_node[n]`` holds a node's attributes, ``_adj[u][v]`` the
    attribute dict its edge shares with ``_adj[v][u]``."""

    def __init__(self):
        self._node: dict = {}
        self._adj: dict = {}

    @property
    def nodes(self) -> _NodeView:
        return _NodeView(self)

    @property
    def edges(self) -> _EdgeView:
        return _EdgeView(self)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __getitem__(self, n):
        return self._adj[n]

    def add_node(self, n, **attr):
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = {}
        self._node[n].update(attr)

    def add_nodes_from(self, nodes):
        for n in nodes:
            if isinstance(n, tuple):
                self.add_node(n[0], **n[1])
            else:
                self.add_node(n)

    def add_edge(self, u, v, **attr):
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        datadict = self._adj[u].get(v, {})
        datadict.update(attr)
        self._adj[u][v] = datadict
        self._adj[v][u] = datadict

    def add_edges_from(self, ebunch):
        for e in ebunch:
            self.add_edge(e[0], e[1], **(e[2] if len(e) == 3 else {}))

    def remove_node(self, n):
        for nbr in list(self._adj[n]):
            del self._adj[nbr][n]
        del self._adj[n]
        del self._node[n]

    def remove_edge(self, u, v):
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def remove_edges_from(self, ebunch):
        for e in ebunch:
            u, v = e[:2]
            if u in self._adj and v in self._adj[u]:
                self.remove_edge(u, v)

    def degree(self, n) -> int:
        return len(self._adj[n]) + (n in self._adj[n])

    def number_of_edges(self) -> int:
        return sum(self.degree(n) for n in self._node) // 2

    def copy(self) -> "Graph":
        """Copy with copied attribute dicts, edges re-inserted in adjacency
        order (networkx's ``Graph.copy``)."""
        g = Graph()
        g.add_nodes_from((n, d.copy()) for n, d in self._node.items())
        g.add_edges_from(
            (u, v, dd.copy()) for u, nbrs in self._adj.items() for v, dd in nbrs.items()
        )
        return g

    def subgraph(self, nodes) -> "Graph":
        """The induced subgraph, sharing the attribute dicts. Its nodes (and
        each node's neighbours) come in networkx's subgraph-view order: that
        of ``set(nodes)`` where the set holds under half of the dict it
        filters, this graph's order otherwise."""
        keep = set(n for n in nodes if n in self._node)

        def order(atlas):
            if 2 * len(keep) < len(atlas):
                return [n for n in keep if n in atlas]
            return [n for n in atlas if n in keep]

        g = Graph()
        for n in order(self._node):
            g._node[n] = self._node[n]
            g._adj[n] = {m: self._adj[n][m] for m in order(self._adj[n])}
        return g


def edge_subgraph_copy(g: Graph, edges) -> Graph:
    """networkx's ``nx.Graph(g.edge_subgraph(edges))``: a graph of copied
    attribute dicts holding ``edges`` and their end nodes, in the view's
    order (nodes as :meth:`Graph.subgraph` orders them, each node's
    neighbours in this graph's order)."""
    edges = set(tuple(e[:2]) for e in edges)
    keep = set(n for e in edges for n in e)

    def edge_ok(u, v):
        return (u, v) in edges or (v, u) in edges

    if 2 * len(keep) < len(g._node):
        nodes = [n for n in keep if n in g._node]
    else:
        nodes = [n for n in g._node if n in keep]
    out = Graph()
    out.add_nodes_from(nodes)
    out.add_edges_from(
        (u, v, g._adj[u][v]) for u in nodes for v in g._adj[u] if v in keep and edge_ok(u, v)
    )
    for n in nodes:
        out._node[n].update(g._node[n])
    return out


def minimum_spanning_edges(g: Graph, weight="weight") -> list:
    """The edges of networkx's Kruskal minimum spanning forest: edges taken
    in a stable sort by weight (missing weights count 1) when they join two
    trees. Raises on a NaN weight, as networkx does."""
    weighted = []
    for u, v, d in g.edges(data=True):
        wt = d.get(weight, 1)
        if np.isnan(wt):
            raise ValueError(f"NaN found as an edge weight. Edge {(u, v, d)}")
        weighted.append((wt, u, v))
    parent = {n: n for n in g.nodes}

    def root(n):
        while parent[n] != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    out = []
    for _wt, u, v in sorted(weighted, key=lambda e: e[0]):
        ru, rv = root(u), root(v)
        if ru != rv:
            out.append((u, v))
            parent[ru] = rv
    return out


def get_edge_attributes(g: Graph, name) -> dict:
    return {(u, v): d[name] for u, v, d in g.edges(data=True) if name in d}


def connected_components(g: Graph):
    """Node sets of the components, in the order of their first node."""
    seen = set()
    for v in g:
        if v in seen:
            continue
        comp = {v}
        nextlevel = [v]
        while nextlevel:
            thislevel, nextlevel = nextlevel, []
            for u in thislevel:
                for w in g._adj[u]:
                    if w not in comp:
                        comp.add(w)
                        nextlevel.append(w)
        seen.update(comp)
        yield comp


def has_path(g: Graph, source, target) -> bool:
    seen, queue = {source}, deque([source])
    while queue:
        u = queue.popleft()
        if u == target:
            return True
        for w in g._adj[u]:
            if w not in seen:
                seen.add(w)
                queue.append(w)
    return False


def edge_betweenness_centrality(g: Graph) -> dict:
    """Normalised edge betweenness (Brandes), accumulated in networkx's
    order so that the sums round alike."""
    betweenness = dict.fromkeys(g, 0.0)
    betweenness.update(dict.fromkeys(g.edges, 0.0))
    for s in g:
        stack = []
        pred = {v: [] for v in g}
        sigma = dict.fromkeys(g, 0.0)
        dist = {s: 0}
        sigma[s] = 1.0
        queue = deque([s])
        while queue:
            v = queue.popleft()
            stack.append(v)
            dv, sigmav = dist[v], sigma[v]
            for w in g._adj[v]:
                if w not in dist:
                    queue.append(w)
                    dist[w] = dv + 1
                if dist[w] == dv + 1:
                    sigma[w] += sigmav
                    pred[w].append(v)
        delta = dict.fromkeys(stack, 0)
        while stack:
            w = stack.pop()
            coeff = (1 + delta[w]) / sigma[w]
            for v in pred[w]:
                c = sigma[v] * coeff
                if (v, w) not in betweenness:
                    betweenness[(w, v)] += c
                else:
                    betweenness[(v, w)] += c
                delta[v] += c
            if w != s:
                betweenness[w] += delta[w]
    for n in g:
        del betweenness[n]
    n = len(g)
    if n >= 2:
        scale = 1 / (n * (n - 1))
        for e in betweenness:
            betweenness[e] *= scale
    return betweenness


def greedy_color(g: Graph) -> dict:
    """Greedy colouring, nodes by degree (largest first, ties in node
    order), each taking the smallest colour its neighbours do not hold."""
    colors: dict = {}
    for u in sorted(g, key=g.degree, reverse=True):
        neighbour_colors = {colors[v] for v in g._adj[u] if v in colors}
        color = 0
        while color in neighbour_colors:
            color += 1
        colors[u] = color
    return colors


def degree_centrality(g: Graph) -> dict:
    if len(g) <= 1:
        return {n: 1 for n in g}
    s = 1.0 / (len(g) - 1.0)
    return {n: g.degree(n) * s for n in g}


def single_source_dijkstra_path(g: Graph, source, weight) -> dict:
    """Shortest paths from ``source``; ``weight`` is an edge attribute name
    (default 1) or a function ``(u, v, data)``. Equal distances keep the
    path found first, as networkx does."""
    if not callable(weight):
        name = weight
        weight = lambda u, v, d: d.get(name, 1)  # noqa: E731
    dist, seen, paths = {}, {source: 0}, {source: [source]}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u, e in g._adj[v].items():
            vu_dist = dist[v] + weight(v, u, e)
            if u in dist:
                continue
            if u not in seen or vu_dist < seen[u]:
                seen[u] = vu_dist
                heapq.heappush(fringe, (vu_dist, next(c), u))
                paths[u] = paths[v] + [u]
    return paths


def _topological_sort(edges, nodes):
    """Kahn's generations over a directed graph given by its node order and
    edges (networkx's ``topological_sort``)."""
    succ = {n: [] for n in nodes}
    indeg = dict.fromkeys(nodes, 0)
    for u, v in edges:
        succ[u].append(v)
        indeg[v] += 1
    indegree_map = {v: d for v, d in indeg.items() if d > 0}
    zero = [v for v, d in indeg.items() if d == 0]
    order = []
    while zero:
        generation, zero = zero, []
        for node in generation:
            for child in succ[node]:
                indegree_map[child] -= 1
                if indegree_map[child] == 0:
                    zero.append(child)
                    del indegree_map[child]
        order.extend(generation)
    if indegree_map:
        raise ValueError("the node label sets overlap in a cycle")
    return order


def relabel_nodes_inplace(g: Graph, mapping: dict) -> Graph:
    """Relabel ``g`` in place, in networkx's order of operations (which
    decides the node and edge order of the result)."""
    if mapping.keys() & mapping.values():
        nodes, edges = [], []
        for u, v in mapping.items():
            for n in (u, v):
                if n not in nodes:
                    nodes.append(n)
            if u != v:
                edges.append((u, v))
        order = reversed(_topological_sort(edges, nodes))
    else:
        order = [n for n in g if n in mapping]
    for old in order:
        if old not in mapping or old not in g._node:
            continue
        new = mapping[old]
        g.add_node(new, **g._node[old])
        if new == old:
            continue
        new_edges = [
            (new, new if old == target else target, data)
            for (_, target, data) in g.edges(old, data=True)
        ]
        g.remove_node(old)
        g.add_edges_from(new_edges)
    return g


# ---------------------------------------------------------------------------
# stack-props geometry
# ---------------------------------------------------------------------------


def get_spatial_dims_from_stack_properties(stack_props):
    return [d for d in si_utils.SPATIAL_DIMS if d in stack_props["origin"]]


def get_ndim_from_stack_props(stack_props) -> int:
    return len(stack_props["origin"])


def _props_arrays(stack_props):
    sdims = get_spatial_dims_from_stack_properties(stack_props)
    shape = np.array([stack_props["shape"][d] for d in sdims], dtype=float)
    spacing = np.array([stack_props["spacing"][d] for d in sdims], dtype=float)
    origin = np.array([stack_props["origin"][d] for d in sdims], dtype=float)
    return sdims, shape, spacing, origin


def _props_transform_matrix(stack_props) -> Optional[np.ndarray]:
    if "transform" not in stack_props:
        return None
    mat = np.asarray(param_utils.to_xaffine(stack_props["transform"]).data)
    return mat[0] if mat.ndim == 3 else mat


@lru_cache(maxsize=8)
def _corner_grid(ndim: int) -> np.ndarray:
    return np.array(list(np.ndindex(tuple([2] * ndim))), dtype=float)


def get_vertices_from_stack_props(stack_props) -> np.ndarray:
    """Pixel-center corner vertices in world coordinates."""
    sdims, shape, spacing, origin = _props_arrays(stack_props)
    vertices = _corner_grid(len(sdims)) * (shape - 1) * spacing + origin
    mat = _props_transform_matrix(stack_props)
    if mat is not None:
        vertices = param_utils.transform_pts(vertices, mat)
    return vertices


def get_faces_from_stack_props(stack_props) -> np.ndarray:
    """Face vertex sets in world coordinates."""
    sdims, shape, spacing, origin = _props_arrays(stack_props)
    ndim = len(sdims)
    gv = _corner_grid(ndim)
    faces = np.array(
        [gv[np.where(gv[:, iax] == lface)[0]] for iax in range(ndim) for lface in (0, 1)]
    )
    faces = faces * (shape - 1) * spacing + origin
    mat = _props_transform_matrix(stack_props)
    if mat is not None:
        faces = param_utils.transform_pts(faces.reshape(-1, ndim), mat).reshape(faces.shape)
    return faces


def get_center_from_stack_props(stack_props) -> np.ndarray:
    sdims, shape, spacing, origin = _props_arrays(stack_props)
    center = origin + spacing * (shape - 1) / 2
    mat = _props_transform_matrix(stack_props)
    if mat is not None:
        center = param_utils.transform_pts(center[None], mat)[0]
    return center


def get_halfspace_equations_from_stack_props(stack_props) -> np.ndarray:
    """Inward halfspace equations ``n·x + c <= 0`` of the (transformed) box."""
    ndim = len(stack_props["origin"])
    faces = get_faces_from_stack_props(stack_props)
    center = get_center_from_stack_props(stack_props)
    equations = []
    for face in faces:
        if ndim == 2:
            normal = np.array([-(face[1][1] - face[0][1]), face[1][0] - face[0][0]])
        elif ndim == 3:
            normal = np.cross(face[1] - face[0], face[2] - face[0])
        else:
            raise NotImplementedError(ndim)
        normal = normal / np.linalg.norm(normal)
        c = -np.dot(normal, face[0])
        if np.dot(normal, center) + c > 0:
            normal = -normal
            c = -np.dot(normal, face[0])
        equations.append(np.concatenate([normal, [c]]))
    return np.array(equations)


def _is_axis_aligned(stack_props, tol=1e-12) -> bool:
    """True if the stack's world transform is a translation and a positive
    diagonal scaling, so that overlaps are box intersections."""
    mat = _props_transform_matrix(stack_props)
    if mat is None:
        return True
    ndim = mat.shape[-1] - 1
    lin = mat[:ndim, :ndim]
    off_diag = lin - np.diag(np.diag(lin))
    return bool(np.all(np.abs(off_diag) <= tol) and np.all(np.diag(lin) > 0))


def _world_aabb(stack_props):
    verts = get_vertices_from_stack_props(stack_props)
    return verts.min(axis=0), verts.max(axis=0)


class BoxIntersection:
    """The overlap of two axis-aligned boxes, with the attributes of scipy's
    ``HalfspaceIntersection`` that the pipeline reads."""

    def __init__(self, lower, upper):
        self.lower = np.asarray(lower, dtype=float)
        self.upper = np.asarray(upper, dtype=float)

    @property
    def intersections(self):
        return self.lower + _corner_grid(len(self.lower)) * (self.upper - self.lower)

    @property
    def halfspaces(self):
        ndim = len(self.lower)
        eqs = []
        for d in range(ndim):
            n = np.zeros(ndim)
            n[d] = -1.0
            eqs.append(np.concatenate([n, [self.lower[d]]]))
            n = np.zeros(ndim)
            n[d] = 1.0
            eqs.append(np.concatenate([n, [-self.upper[d]]]))
        return np.array(eqs)

    @property
    def interior_point(self):
        return (self.lower + self.upper) / 2


def get_overlap_between_pair_of_stack_props(stack_props1, stack_props2):
    """Convex overlap (volume, intersection) of two transformed boxes: a box
    intersection when both are axis-aligned, else a halfspace intersection
    from a Chebyshev-centre feasible point. (-1, None) when empty."""
    if _is_axis_aligned(stack_props1) and _is_axis_aligned(stack_props2):
        lo1, up1 = _world_aabb(stack_props1)
        lo2, up2 = _world_aabb(stack_props2)
        lower = np.maximum(lo1, lo2)
        upper = np.minimum(up1, up2)
        if np.any(upper < lower):
            return -1, None
        return float(np.prod(upper - lower)), BoxIntersection(lower, upper)

    eqs = np.concatenate(
        [
            get_halfspace_equations_from_stack_props(stack_props1),
            get_halfspace_equations_from_stack_props(stack_props2),
        ]
    )
    norm_vector = np.linalg.norm(eqs[:, :-1], axis=1, keepdims=True)
    c = np.zeros(eqs.shape[1])
    c[-1] = -1
    A = np.hstack((eqs[:, :-1], norm_vector))
    b = -eqs[:, -1:]
    res = linprog(c, A_ub=A, b_ub=b, bounds=(None, None))
    if not res.success or res.x[-1] <= 0:
        return -1, None
    try:
        intersection = HalfspaceIntersection(eqs, res.x[:-1])
    except QhullError:
        return -1, None
    return ConvexHull(intersection.intersections).volume, intersection


def expand_halfspace(halfspace, distance):
    """The intersection with every boundary plane moved outward by
    ``distance``. A box intersection stays a box, ``[lower - distance, upper
    + distance]``, whose ``halfspaces`` are bit for bit those of the
    reference's expanded equations; any other intersection is rebuilt by
    scipy from its shifted equations."""
    if isinstance(halfspace, BoxIntersection):
        return BoxIntersection(halfspace.lower - distance, halfspace.upper + distance)
    equations = np.array(halfspace.halfspaces, dtype=float)
    equations[:, -1] -= distance
    try:
        return HalfspaceIntersection(equations, halfspace.interior_point)
    except QhullError as e:
        raise ValueError("Cannot expand halfspace by the given distance; result infeasible.") from e


def transform_halfspace(halfspace, affine):
    """The intersection mapped through ``affine``, as scipy's
    ``HalfspaceIntersection`` (a box intersection too)."""
    affine = np.asarray(affine, dtype=float)
    eqs_transformed = np.asarray(halfspace.halfspaces) @ np.linalg.inv(affine)
    interior_transformed = param_utils.transform_pts(
        np.asarray(halfspace.interior_point)[None], affine
    )[0]
    return HalfspaceIntersection(eqs_transformed, interior_transformed)


def points_inside_sim(pts, sim, transform_key) -> np.ndarray:
    """Which of the (N, ndim) world points lie inside the sim's box placed by
    ``transform_key``."""
    stack_props = si_utils.get_stack_properties_from_sim(sim, transform_key=transform_key)
    eqs = get_halfspace_equations_from_stack_props(stack_props)
    pts = np.asarray(pts, dtype=float)
    inside = np.ones(len(pts), dtype=bool)
    for eq in eqs:
        inside &= pts @ eq[:-1] + eq[-1] <= 0
    return inside


def get_mask_from_halfspace(sim, halfspace_eqs) -> np.ndarray:
    """Boolean mask of the sim's pixels (at their physical coordinates)
    inside every halfspace ``eq[:-1] . x + eq[-1] <= 0``."""
    sdims = si_utils.get_spatial_dims_from_sim(sim)
    axes = [sim.origin[d] + sim.spacing[d] * np.arange(sim.sizes[d], dtype=float) for d in sdims]
    grids = np.meshgrid(*axes, indexing="ij")
    mask = np.ones(grids[0].shape, dtype=bool)
    for eq in halfspace_eqs:
        val = sum(eq[i] * grids[i] for i in range(len(sdims))) + eq[-1]
        mask &= val <= 0
    return mask


# ---------------------------------------------------------------------------
# the view adjacency graph and its pruning
# ---------------------------------------------------------------------------


def build_view_adjacency_graph_from_msims(
    msims, transform_key, overlap_tolerance=None, expand: bool = False, pairs=None
) -> Graph:
    """Graph of overlapping views: nodes carry ``stack_props``, edges the
    overlap volume. Candidate pairs come from a k-d tree over view centres."""
    g = Graph()
    for iview in range(len(msims)):
        g.add_node(iview)

    sims = [msi_utils.get_sim_from_msim(m) for m in msims]
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    nsdims = si_utils.get_nonspatial_dims_from_sim(sims[0])
    if len(nsdims):
        sims = [
            si_utils.sim_sel_coords(sim, {nsdim: sim.coords[nsdim][0] for nsdim in nsdims})
            for sim in sims
        ]
    stack_propss = [
        si_utils.get_stack_properties_from_sim(sim, transform_key=transform_key) for sim in sims
    ]
    if overlap_tolerance is not None:
        stack_propss = [si_utils.extend_stack_props(sp, overlap_tolerance) for sp in stack_propss]
    for i, sp in enumerate(stack_propss):
        g._node[i]["stack_props"] = sp

    if pairs is None:
        sim_centers = np.array([get_center_from_stack_props(sp) for sp in stack_propss])
        sim_diameters = np.array(
            [
                np.linalg.norm(np.array([sp["shape"][d] * sp["spacing"][d] for d in sdims]))
                for sp in stack_propss
            ]
        )
        max_diameter = float(np.max(sim_diameters))
        tree = cKDTree(sim_centers)
        pairs = []
        for iview in range(len(msims)):
            for close_view in tree.query_ball_point(sim_centers[iview], max_diameter + 1):
                if iview != close_view:
                    pairs.append((iview, close_view))

    aligned = np.array([_is_axis_aligned(sp) for sp in stack_propss])
    if pairs and np.all(aligned):
        idx = np.asarray(list(pairs))
        aabbs = [_world_aabb(sp) for sp in stack_propss]
        lows = np.array([a[0] for a in aabbs])
        ups = np.array([a[1] for a in aabbs])
        extent = np.minimum(ups[idx[:, 0]], ups[idx[:, 1]]) - np.maximum(
            lows[idx[:, 0]], lows[idx[:, 1]]
        )
        empty = np.any(extent < 0, axis=1)
        vols = np.where(empty, -1.0, np.prod(extent, axis=1))
        for (a, b), vol in zip(pairs, vols):
            if vol > 0 or (expand and vol >= 0):
                g.add_edge(a, b, overlap=float(vol))
        return g

    for pair in pairs:
        overlap_area, _ = get_overlap_between_pair_of_stack_props(
            stack_propss[pair[0]], stack_propss[pair[1]]
        )
        # overlap 0 is a one-pixel overlap: not usable for registration
        # unless `expand` is asked for
        if overlap_area > 0 or (expand and overlap_area >= 0):
            g.add_edge(pair[0], pair[1], overlap=overlap_area)
    return g


def get_node_with_maximal_edge_weight_sum_from_graph(g: Graph, weight_key):
    total = {node: 0.0 for node in g.nodes}
    for a, b, attrs in g.edges(data=True):
        w_arr = np.asarray(attrs[weight_key], dtype=float)
        finite = w_arr[np.isfinite(w_arr)]
        w = float(finite.mean()) if finite.size else 0.0
        total[a] += w
        total[b] += w
    return max(total, key=total.get)


def prune_graph_to_alternating_colors(g: Graph, n_colors=2, return_colors=True):
    """Thin the adjacency graph until a greedy colouring uses at most
    ``n_colors``: edges ranked by overlap, with normalised edge betweenness
    scaled into half the smallest overlap as a tiebreak, are removed rank by
    rank (never isolating a node)."""
    if not g.number_of_edges():
        return (g, dict.fromkeys(g.nodes, 0)) if return_colors else g

    overlaps = get_edge_attributes(g, "overlap")
    tiebreak_span = 0.5 * min(overlaps.values())
    centrality = edge_betweenness_centrality(g)
    c_lo, c_hi = min(centrality.values()), max(centrality.values())
    c_scale = tiebreak_span / (c_hi - c_lo) if c_hi > c_lo else 0.0
    rank = {e: overlaps[e] + (centrality[e] - c_lo) * c_scale for e in overlaps}

    pruned = g.copy()
    colors = greedy_color(pruned)
    for threshold in sorted(set(rank.values())):
        if len(set(colors.values())) <= n_colors:
            break
        # degree guard against the graph before this batch is removed
        batch = [
            e
            for e in pruned.edges
            if rank[tuple(e)] <= threshold
            and min(pruned.degree(e[0]), pruned.degree(e[1])) > 1
        ]
        pruned.remove_edges_from(batch)
        colors = greedy_color(pruned)
    return (pruned, colors) if return_colors else pruned


def get_greedy_colors(sims, n_colors=2, transform_key=None):
    """A colouring of the views (node -> colour) in which overlapping views
    differ, from the view graph thinned to ``n_colors`` alternating colours
    (for display)."""
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    g = build_view_adjacency_graph_from_msims(
        [msi_utils.get_msim_from_sim(sim, scale_factors=[]) for sim in sims],
        overlap_tolerance={d: 1e-5 for d in sdims},
        transform_key=transform_key,
    )
    _, greedy_colors = prune_graph_to_alternating_colors(g, n_colors=n_colors)
    return greedy_colors


def prune_to_shortest_weighted_paths(g: Graph) -> Graph:
    """Keep the edges on overlap-weighted shortest paths from each
    component's best-connected view (weight ``1 / (overlap + 1)``)."""
    components = list(connected_components(g))
    if not any(len(cc) > 1 for cc in components):
        raise NotEnoughOverlapError("No view/tile in the adjacency graph overlaps any other.")
    isolated = sorted(chain.from_iterable(cc for cc in components if len(cc) == 1))
    if isolated:
        warnings.warn(f"Views/tiles without any overlap link: {isolated}", UserWarning, stacklevel=1)
    for _u, _v, attrs in g.edges(data=True):
        attrs["overlap_inv"] = 1.0 / (attrs["overlap"] + 1)
    g_reg = Graph()
    g_reg.add_nodes_from((n, dict(d)) for n, d in g.nodes(data=True))
    for cc in components:
        anchor = get_node_with_maximal_edge_weight_sum_from_graph(
            g.subgraph(cc), weight_key="overlap"
        )
        tree_paths = single_source_dijkstra_path(g, anchor, weight="overlap_inv")
        for node in cc:
            path = tree_paths[node]
            for a, b in zip(path, path[1:]):
                g_reg.add_edge(a, b, overlap=g[a][b]["overlap"])
    return g_reg


def prune_to_axis_aligned_edges(g: Graph, max_angle=0.05) -> Graph:
    """Keep the edges whose direction (centre to centre) lies within
    ``max_angle`` radians of an axis of the first view's stack; every node
    stays."""
    edges_to_keep = []
    for edge in g.edges:
        verts1 = get_vertices_from_stack_props(g.nodes[edge[0]]["stack_props"])
        verts2 = get_vertices_from_stack_props(g.nodes[edge[1]]["stack_props"])
        ndim = len(verts1[0])
        edge_vec = np.mean(verts2, 0) - np.mean(verts1, 0)
        edge_vec = edge_vec / np.linalg.norm(edge_vec)
        vert_grid_inds = np.array(list(np.ndindex(tuple([2] * ndim))))
        ax_vecs = []
        for ind in range(len(vert_grid_inds)):
            if np.sum(vert_grid_inds[ind]) != 1:
                continue
            ax_vec = verts1[ind] - verts1[0]
            ax_vecs.append(ax_vec / np.linalg.norm(ax_vec))
        for ax_vec in ax_vecs:
            angle = np.arccos(np.clip(np.abs(np.dot(edge_vec, ax_vec)), 0, 1))
            if angle < max_angle:
                edges_to_keep.append(edge)
                break
    g_pruned = edge_subgraph_copy(g, edges_to_keep)
    for node in g.nodes:
        if node not in g_pruned.nodes:
            g_pruned.add_node(node, **g.nodes[node])
    return g_pruned


def filter_edges(g: Graph, weight_key="overlap", threshold=None) -> Graph:
    """Drop edges whose weight is below ``threshold`` (Otsu's by default)."""
    edges = list(g.edges(data=True))
    if not edges:
        return g
    weights = [e[2][weight_key] for e in edges]
    scalar_weights = np.array([np.min(w) if np.ndim(w) > 0 else w for w in weights], dtype=float)
    if threshold is None:
        threshold = threshold_otsu(
            np.array([np.asarray(w).ravel() for w in weights]).ravel()
            if np.ndim(weights[0])
            else scalar_weights
        )
    g_filtered = g.copy()
    g_filtered.remove_edges_from(
        [(a, b) for (a, b, _), w in zip(edges, scalar_weights) if w < threshold]
    )
    return g_filtered


def prune_view_adjacency_graph(g: Graph, method=None, pruning_method_kwargs=None) -> Graph:
    """Dispatch to a pruning method by name."""
    if not g.number_of_edges():
        raise NotEnoughOverlapError("Not enough overlap between views for stitching.")
    pruning_method_kwargs = pruning_method_kwargs or {}
    if method is None:
        return g
    if method == "alternating_pattern":
        return prune_graph_to_alternating_colors(g, return_colors=False, **pruning_method_kwargs)
    if method == "shortest_paths_overlap_weighted":
        return prune_to_shortest_weighted_paths(g, **pruning_method_kwargs)
    if method == "otsu_threshold_on_overlap":
        return filter_edges(g, **pruning_method_kwargs)
    if method == "keep_axis_aligned":
        return prune_to_axis_aligned_edges(g, **pruning_method_kwargs)
    raise ValueError(f"Unknown graph pruning method: {method}")


# ---------------------------------------------------------------------------
# chunk grids and back-projected overlap windows (fusion planning)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# label connectivity (pair discovery from sample masks)
# ---------------------------------------------------------------------------


def project_bb_along_dim(bb: BoundingBox, dim: str) -> BoundingBox:
    """The bounding box without ``dim``."""
    return {key: {d: bb[key][d] for d in bb[key] if d != dim} for key in bb}


def unique_along_axis(a, axis=0):
    at = np.ascontiguousarray(a.swapaxes(0, axis))
    dt = np.dtype([("values", at.dtype, at.shape[1:])])
    atv = at.view(dt)
    return np.unique(atv)["values"].swapaxes(0, axis)


def get_connected_labels(labels, structure=None):
    """Pairs of label values that touch under the full 3^ndim structure.
    Labels are offset by +1 (0 is background); the pairs are 0-based."""
    ndim = labels.ndim
    structure = np.ones((3,) * ndim)
    chunks = []
    for pos in np.array(np.where(structure)).T:
        if not (min(pos) < 1 or max(pos) < 2):
            continue
        sl_a = tuple(slice(1 if p > 1 else 0, None) for p in pos)
        sl_b = tuple(slice(0, -1 if p > 1 else None) for p in pos)
        pair = np.array([labels[sl_a], labels[sl_b]]).reshape((2, -1))
        keep = pair.all(axis=0) & (np.diff(pair, axis=0)[0] != 0)
        chunks.append(pair[:, keep])
    pairs = np.concatenate(chunks, axis=1)
    pairs = unique_along_axis(pairs, axis=1).T
    pairs -= 1
    return pairs


# ---------------------------------------------------------------------------
# graph attributes and distance pre-filters
# ---------------------------------------------------------------------------


def compute_graph_edges(input_g: Graph, weight_name: str = "transform") -> Graph:
    """A copy of the graph whose ``weight_name`` edge attributes are host
    arrays (the reference computes lazy ones here)."""
    g = input_g.copy()
    for e in g.edges:
        if weight_name not in g.edges[e]:
            continue
        w = g.edges[e][weight_name]
        if isinstance(w, param_utils.XAffine):
            g.edges[e][weight_name] = param_utils.XAffine(np.asarray(w.data), t_coords=w.t_coords)
        elif hasattr(w, "__array__"):
            g.edges[e][weight_name] = np.asarray(w)
    return g


def strack_props_are_far_apart(stack_props_1, stack_props_2) -> bool:
    """True when the bounding spheres of two stacks cannot intersect: their
    centres lie further apart than the sum of their half-diagonals (a
    cheap pre-filter before an exact overlap)."""
    verts = [get_vertices_from_stack_props(sp) for sp in (stack_props_1, stack_props_2)]
    centers = [np.mean(v, axis=0) for v in verts]
    center_dist = float(np.linalg.norm(centers[1] - centers[0]))
    half_diags = [float(np.max(np.linalg.norm(v - c, axis=1))) for v, c in zip(verts, centers)]
    return center_dist > sum(half_diags)


def sims_are_far_apart(sim1, sim2, transform_key) -> bool:
    """:func:`strack_props_are_far_apart` of two views placed by
    ``transform_key``."""
    sps = [
        si_utils.get_stack_properties_from_sim(sim, transform_key=transform_key)
        for sim in (sim1, sim2)
    ]
    return strack_props_are_far_apart(*sps)


def get_nodes_dataset_from_graph(g: Graph, node_attribute: str) -> dict:
    """{node: attribute} of the nodes that carry ``node_attribute`` (the
    reference returns an xarray Dataset)."""
    return {n: g.nodes[n][node_attribute] for n in g.nodes if node_attribute in g.nodes[n]}
