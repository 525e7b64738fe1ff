"""Registration quality: image metrics over the overlaps of view pairs.

The port of ``multiview_stitcher_tpu.metrics``. For each pair of adjacent
views, the fixed view is sampled on a grid over the pair's overlap in its
own space and the moving view through ``inv(T_moving) @ T_fixed`` of each
candidate transform key, so that metric differences across keys come from
the transforms alone. Pixels outside the overlap's halfspaces (expanded by a
thousandth of the finest spacing) and outside either view are NaN.

The default metric, NaN-aware normalised cross-correlation, takes a batched
path: every (edge, key) unit of a grid shape is resampled, masked and
reduced in one batch of torch ops on the device, with both views' source
windows uploaded in one copy each. Any other metric function runs a host
loop: both views resampled by ``transformation.transform_sim`` on the
device, then ``func(fixed, moving)`` on numpy arrays (so skimage-style
functions work); a function that names ``device`` gets the call's device.

Two modes, as in the reference: pairs from the views' overlaps under
``base_transform_key``, scored under ``query_transform_keys``; or pairs and
their transforms from a registration graph (``pairs_graph``: any graph with
``nodes()``, ``edges()`` and ``edges[i, j]["transform"]``, the port's
``mv_graph.Graph`` or a networkx graph). The directed metric graph keeps
networkx ``DiGraph`` iteration order, which sets the order of ``"pairs"``
and of the summary's sums.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from multiview_stitcher_torch import msi_utils, mv_graph, param_utils, registration, si_utils
from multiview_stitcher_torch import transformation
from multiview_stitcher_torch.msi_utils import Msim
from multiview_stitcher_torch.ops import image_metrics as im_metrics
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.utils import misc as misc_utils

logger = logging.getLogger(__name__)

# output voxels resampled in one batch of the batched NCC (the items of a
# shape bucket are split into batches of at most this many voxels)
BATCH_VOXELS = 1 << 25

# the last call of tile_pair_image_metrics: host seconds of the metric graph
# and its edge geometry (graph_s), of the per-edge grids (plan_s), of the
# source windows and bucket slabs (prepare_s), of the host loop (host_loop_s);
# the batched path's shape buckets, units and device ms (CUDA events)
last_telemetry: Dict[str, object] = {}


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float64)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def normalized_cross_correlation(im1, im2, device=None) -> float:
    """NaN-aware NCC in [-1, 1] over the pixels where neither image is NaN;
    NaN where it is undefined. Runs on ``device`` (the CUDA device unless
    the caller names another)."""
    device = misc_utils.resolve_device(device)
    return float(im_metrics.nan_aware_ncc(_as_tensor(im1, device), _as_tensor(im2, device)))


def structural_similarity(im1, im2, win_size: int = 7, data_range=None, device=None) -> float:
    """NaN-aware mean SSIM, usable as a ``metric_funcs`` entry.

    Pixels where either image is NaN (outside the overlap) are filled with
    each image's mean over the pixels valid in both; the window shrinks to
    the largest odd size that fits the smallest extent; ``data_range``
    defaults to the joint range (1.0 for two constant images). The SSIM
    runs on ``device`` (the CUDA device unless the caller names another)."""
    device = misc_utils.resolve_device(device)
    a = np.asarray(im1, dtype=np.float32)
    b = np.asarray(im2, dtype=np.float32)
    valid = np.isfinite(a) & np.isfinite(b)
    if not valid.any():
        return float("nan")
    a = np.where(valid, a, float(a[valid].mean()))
    b = np.where(valid, b, float(b[valid].mean()))
    max_win = min(a.shape)
    if win_size > max_win:
        win_size = max_win if max_win % 2 == 1 else max_win - 1
        if win_size < 1:
            return float("nan")
    if data_range is None:
        data_range = float(max(a.max(), b.max()) - min(a.min(), b.min()))
        if data_range == 0:
            return 1.0
    return float(im_metrics.structural_similarity(
        torch.from_numpy(a).to(device), torch.from_numpy(b).to(device),
        win_size=win_size, data_range=float(data_range),
    ))


class _DiGraph:
    """The directed graph of metric units: nodes in insertion order, each
    node's successors in insertion order, edges iterated node by node as
    networkx's ``DiGraph.edges()`` does; ``edges[(u, v)]`` is the edge's
    attribute dict."""

    def __init__(self, nodes=()):
        self._succ: Dict[object, Dict[object, dict]] = {}
        for n in nodes:
            self._succ.setdefault(n, {})
        self.edges = _DiEdges(self)

    def add_edge(self, u, v, **attr):
        self._succ.setdefault(u, {})
        self._succ.setdefault(v, {})
        self._succ[u].setdefault(v, {}).update(attr)


class _DiEdges:
    def __init__(self, g: _DiGraph):
        self._g = g

    def __call__(self):
        return [(u, v) for u, nbrs in self._g._succ.items() for v in nbrs]

    def __iter__(self):
        return iter(self())

    def __getitem__(self, e):
        return self._g._succ[e[0]][e[1]]


def _compute_metrics_from_arrays(fixed_sim, moving_sim, metric_funcs, intersection_halfspace=None,
                                 device=None):
    fixed_np = np.array(np.asarray(fixed_sim.data, dtype=np.float32))
    moving_np = np.asarray(moving_sim.data, dtype=np.float32)
    if intersection_halfspace is not None:
        mask = mv_graph.get_mask_from_halfspace(fixed_sim, intersection_halfspace)
        fixed_np[~mask] = np.nan
    out = {}
    for k, f in metric_funcs.items():
        kw = {"device": device} if misc_utils.has_keyword(f, "device") else {}
        out[k] = float(f(fixed_np, moving_np, **kw))
    return out


def _sims_t0(sims, metric_channel):
    out = []
    for sim in sims:
        sel = {}
        if "t" in sim.dims:
            sel["t"] = np.asarray(sim.coords["t"])[0]
        if "c" in sim.dims:
            sel["c"] = np.asarray(sim.coords["c"])[0] if metric_channel is None else metric_channel
        if sel:
            sim = si_utils.sim_sel_coords(sim, sel)
        out.append(sim)
    return out


def _tolerance(max_tolerance, sdims):
    if max_tolerance is None:
        return None
    if isinstance(max_tolerance, (int, float)):
        return -float(max_tolerance)
    return {d: -float(max_tolerance.get(d, 0.0)) for d in sdims}


def _edge_geometry(sim_fixed, sim_moving, base_transform_key, tol, geom_cache, keys):
    overlap_dict = registration._get_overlap_bboxes(
        sim_fixed, sim_moving, input_transform_key=base_transform_key,
        output_transform_key=None, overlap_tolerance=tol, geom_cache=geom_cache,
        cache_keys=keys,
    )
    lower = np.asarray(overlap_dict["lowers"][0], dtype=float)
    upper = np.asarray(overlap_dict["uppers"][0], dtype=float)
    comparison_bbox = None if np.any(lower >= upper) else {"lower": lower, "upper": upper}
    return comparison_bbox, overlap_dict["intersection"], overlap_dict["vol"]


def _affine_of(sim, key):
    m = np.asarray(si_utils.get_affine_from_sim(sim, key).squeeze())
    return m[0] if m.ndim == 3 else m


def _build_metrics_graph(msims, sims_t0, base_transform_key, query_transform_keys,
                         max_tolerance, bidirectional=False):
    sdims = si_utils.get_spatial_dims_from_sim(sims_t0[0])
    tol = _tolerance(max_tolerance, sdims)
    g_adj = mv_graph.build_view_adjacency_graph_from_msims(
        msims, transform_key=base_transform_key, overlap_tolerance=tol
    )
    g_metrics = _DiGraph(g_adj.nodes())
    geom_cache = {}
    for i, j in g_adj.edges():
        directions = [(i, j), (j, i)] if bidirectional else [(min(i, j), max(i, j))]
        for fixed_idx, moving_idx in directions:
            comparison_bbox, intersection, vol = _edge_geometry(
                sims_t0[fixed_idx], sims_t0[moving_idx], base_transform_key, tol,
                geom_cache, (fixed_idx, moving_idx),
            )
            transforms = {}
            for q in query_transform_keys:
                T_f = _affine_of(sims_t0[fixed_idx], q)
                T_m = _affine_of(sims_t0[moving_idx], q)
                transforms[q] = np.linalg.inv(T_m) @ T_f
            g_metrics.add_edge(
                fixed_idx, moving_idx, comparison_bbox=comparison_bbox, transforms=transforms,
                intersection_halfspace=intersection, vol=vol,
            )
    return g_metrics


def _edge_matrix(T_edge_raw):
    if isinstance(T_edge_raw, param_utils.XAffine):
        return T_edge_raw.matrix(T_edge_raw.t_coords[0] if T_edge_raw.has_t else None)
    T_edge = np.asarray(T_edge_raw).squeeze()
    return T_edge[0] if T_edge.ndim == 3 else T_edge


def _build_metrics_graph_from_pairs_graph(msims, sims_t0, base_transform_key, pairs_graph,
                                          max_tolerance, bidirectional=False):
    sdims = si_utils.get_spatial_dims_from_sim(sims_t0[0])
    tol = _tolerance(max_tolerance, sdims)
    g_metrics = _DiGraph(pairs_graph.nodes())
    geom_cache = {}
    for i, j in pairs_graph.edges():
        fixed_base, moving_base = min(i, j), max(i, j)
        T_edge = _edge_matrix(pairs_graph.edges[fixed_base, moving_base]["transform"])
        directions = [(fixed_base, moving_base)]
        if bidirectional:
            directions.append((moving_base, fixed_base))
        for fixed_idx, moving_idx in directions:
            comparison_bbox, intersection, vol = _edge_geometry(
                sims_t0[fixed_idx], sims_t0[moving_idx], base_transform_key, tol,
                geom_cache, (fixed_idx, moving_idx),
            )
            T_f = _affine_of(sims_t0[fixed_idx], base_transform_key)
            T_m = _affine_of(sims_t0[moving_idx], base_transform_key)
            if fixed_idx < moving_idx:
                p_moving = np.linalg.inv(T_m) @ T_edge @ T_f
            else:
                p_moving = np.linalg.inv(T_f) @ np.linalg.inv(T_edge) @ T_m
            g_metrics.add_edge(
                fixed_idx, moving_idx, comparison_bbox=comparison_bbox,
                transforms={"transform": p_moving}, intersection_halfspace=intersection, vol=vol,
            )
    return g_metrics


def _ncc_pair_batch(f_slabs, fmats, foffs, m_slabs, mmats, moffs, planes, origins, spacings,
                    out_shape):
    """Overlap NCC of B units: fixed and moving resampled onto the
    comparison grid (order 1, NaN outside), the fixed masked by the
    intersection halfspaces evaluated at the grid's world coordinates (in
    float32), then the NaN-aware NCC of each item."""
    ndim = len(out_shape)
    B = f_slabs.shape[0]
    fixed = resample_ops.affine_resample_batch(f_slabs, fmats, foffs, out_shape, order=1,
                                               cval=float("nan"))
    moving = resample_ops.affine_resample_batch(m_slabs, mmats, moffs, out_shape, order=1,
                                                cval=float("nan"))
    per_item = (B,) + (1,) * ndim
    coords = []
    for d in range(ndim):
        iota = torch.arange(out_shape[d], dtype=torch.float32, device=f_slabs.device).reshape(
            (1,) + (1,) * d + (-1,) + (1,) * (ndim - d - 1)
        )
        coords.append(origins[:, d].reshape(per_item) + spacings[:, d].reshape(per_item) * iota)
    inside = torch.ones((B,) + tuple(out_shape), dtype=torch.bool, device=f_slabs.device)
    for h in range(planes.shape[1]):
        val = planes[:, h, ndim].reshape(per_item)
        for d in range(ndim):
            val = val + planes[:, h, d].reshape(per_item) * coords[d]
        inside = inside & (val <= 0)
    fixed = torch.where(inside, fixed, torch.nan)
    return im_metrics.nan_aware_ncc(fixed, moving, ndim)


def _source_window(sim, p, output_sp, sdims, margin=2):
    """Slab of ``sim`` covering the back-projection of the output box
    through ``p`` (output world -> input world), with the pixel parameters
    that map output pixels to slab pixels."""
    ndim = len(sdims)
    lower = np.array([output_sp["origin"][d] for d in sdims])
    spacing_o = np.array([output_sp["spacing"][d] for d in sdims])
    shape_o = np.array([output_sp["shape"][d] for d in sdims])
    corners01 = np.array(list(np.ndindex((2,) * ndim)), dtype=float)
    corners_w = lower + corners01 * (shape_o - 1) * spacing_o
    p = np.asarray(p, dtype=float)
    src_w = corners_w @ p[:ndim, :ndim].T + p[:ndim, ndim]
    origin_i = si_utils.get_origin_from_sim(sim, asarray=True)
    spacing_i = si_utils.get_spacing_from_sim(sim, asarray=True)
    px = (src_w - origin_i) / spacing_i
    lo = np.maximum(0, np.floor(px.min(axis=0)).astype(int) - margin)
    hi = np.minimum(np.array(sim.shape), np.ceil(px.max(axis=0)).astype(int) + margin + 1)
    hi = np.maximum(hi, lo + 1)
    slab = np.asarray(sim.data[tuple(slice(a, b) for a, b in zip(lo, hi))], dtype=np.float32)
    m, o = resample_ops.physical_to_pixel_params(
        p, input_spacing=spacing_i, input_origin=origin_i + lo * spacing_i,
        output_spacing=spacing_o, output_origin=lower,
    )
    return slab, m, o


def _batched_ncc_metrics(units, sdims, device, tel):
    """The NCC of every (edge, key) unit, one shape bucket at a time: the
    bucket's source windows NaN-padded to its largest, uploaded in one copy
    each, resampled, masked and reduced on ``device``; the values downloaded
    once at the end and handed to each unit's ``store``."""
    ndim = len(sdims)
    buckets: Dict[tuple, list] = {}
    for u in units:
        out_shape = tuple(int(u["output_sp"]["shape"][d]) for d in sdims)
        buckets.setdefault(out_shape, []).append(u)
    events, results = [], []
    fixed_windows = {}  # an edge's keys share its grid and fixed window

    def fixed_window(u):
        k = (id(u["fixed_sim"]), id(u["output_sp"]))
        if k not in fixed_windows:
            fixed_windows[k] = _source_window(u["fixed_sim"], np.eye(ndim + 1), u["output_sp"],
                                              sdims)
        return fixed_windows[k]

    for out_shape, bucket in buckets.items():
        t0 = time.perf_counter()
        B = len(bucket)
        prepared = [
            fixed_window(u) + _source_window(u["moving_sim"], u["p_moving"], u["output_sp"], sdims)
            for u in bucket
        ]
        fixed_windows.clear()
        fshape = tuple(max(p[0].shape[d] for p in prepared) for d in range(ndim))
        mshape = tuple(max(p[3].shape[d] for p in prepared) for d in range(ndim))
        h_max = max(1, max(len(u["planes"]) for u in bucket))
        f_slabs = np.full((B,) + fshape, np.nan, dtype=np.float32)
        m_slabs = np.full((B,) + mshape, np.nan, dtype=np.float32)
        params = np.zeros((4, B, ndim, ndim + 1), dtype=np.float32)
        planes = np.zeros((B, h_max, ndim + 1), dtype=np.float32)
        grid = np.ones((2, B, ndim), dtype=np.float32)
        for bi, (u, (fs, fm, fo, ms, mm, mo)) in enumerate(zip(bucket, prepared)):
            f_slabs[bi][tuple(slice(0, s) for s in fs.shape)] = fs
            m_slabs[bi][tuple(slice(0, s) for s in ms.shape)] = ms
            params[0, bi, :, :ndim], params[0, bi, :, ndim] = fm, fo
            params[1, bi, :, :ndim], params[1, bi, :, ndim] = mm, mo
            pl_arr = np.asarray(u["planes"], dtype=np.float32)
            if len(pl_arr):
                planes[bi, : len(pl_arr)] = pl_arr
            grid[0, bi] = [u["output_sp"]["origin"][d] for d in sdims]
            grid[1, bi] = [u["output_sp"]["spacing"][d] for d in sdims]
        tel["prepare_s"] += time.perf_counter() - t0
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        f_dev = torch.from_numpy(f_slabs).to(device)
        m_dev = torch.from_numpy(m_slabs).to(device)
        params_dev = torch.from_numpy(params).to(device)
        planes_dev = torch.from_numpy(planes).to(device)
        grid_dev = torch.from_numpy(grid).to(device)
        step = max(1, BATCH_VOXELS // int(np.prod(out_shape)))
        for s in range(0, B, step):
            sl = slice(s, s + step)
            results.append(_ncc_pair_batch(
                f_dev[sl], params_dev[0, sl, :, :ndim], params_dev[0, sl, :, ndim],
                m_dev[sl], params_dev[1, sl, :, :ndim], params_dev[1, sl, :, ndim],
                planes_dev[sl], grid_dev[0, sl], grid_dev[1, sl], out_shape,
            ))
        if device.type == "cuda":
            e1.record()
            events.append((e0, e1))
    vals = torch.cat(results).cpu().numpy() if results else np.zeros(0, np.float32)
    tel["buckets"] = len(buckets)
    tel["units"] = len(units)
    tel["device_ms"] = sum(e0.elapsed_time(e1) for e0, e1 in events) if events else None
    ordered = [u for bucket in buckets.values() for u in bucket]
    for u, v in zip(ordered, vals):
        u["store"](float(v))


def tile_pair_image_metrics(
    msims,
    base_transform_key: str,
    query_transform_keys=None,
    metric_funcs: Optional[Dict[str, Callable]] = None,
    max_tolerance=None,
    spacing: Optional[Dict[str, float]] = None,
    bidirectional: bool = False,
    metric_channel=None,
    n_parallel_pairs: Optional[int] = None,
    input_res_level: Optional[int] = None,
    *,
    pairs_graph=None,
    device=None,
):
    """Overlap metrics of each adjacent pair under candidate transforms.

    Returns ``{"pairs": {(fixed, moving): {key: {metric: value}}},
    "bboxes": {(fixed, moving): comparison box or None}, "summary": {key:
    {metric: overlap-volume-weighted mean}}}``. ``n_parallel_pairs`` is
    accepted for the reference's signature; pairs are batched instead. Runs
    on ``device``: the CUDA device unless the caller names another.
    """
    device = misc_utils.resolve_device(device)
    if (query_transform_keys is None) == (pairs_graph is None):
        raise ValueError(
            "Exactly one of 'query_transform_keys' or 'pairs_graph' must be provided."
        )
    if metric_funcs is None:
        metric_funcs = {"ncc": normalized_cross_correlation}
    if query_transform_keys is not None:
        if isinstance(query_transform_keys, str):
            query_transform_keys = [query_transform_keys]
        candidate_keys = query_transform_keys
    else:
        candidate_keys = ["transform"]

    tel = {"graph_s": 0.0, "plan_s": 0.0, "prepare_s": 0.0, "host_loop_s": 0.0, "buckets": 0,
           "units": 0, "device_ms": None}
    last_telemetry.clear()
    t0 = time.perf_counter()
    msims = [
        m if isinstance(m, Msim) else msi_utils.get_msim_from_sim(m, scale_factors=[])
        for m in msims
    ]
    per_pair_res_level = False
    if input_res_level is None:
        if spacing is None:
            input_res_level = 0
        else:
            per_pair_res_level = True
    graph_scale_key = "scale0" if per_pair_res_level else f"scale{input_res_level}"
    sims = [m.get_scale(graph_scale_key) for m in msims]
    spatial_dims = si_utils.get_spatial_dims_from_sim(sims[0])
    ndim = len(spatial_dims)
    sims_t0 = _sims_t0(sims, metric_channel)

    if query_transform_keys is not None:
        g_metrics = _build_metrics_graph(
            msims, sims_t0, base_transform_key, query_transform_keys, max_tolerance,
            bidirectional=bidirectional,
        )
    else:
        g_metrics = _build_metrics_graph_from_pairs_graph(
            msims, sims_t0, base_transform_key, pairs_graph, max_tolerance,
            bidirectional=bidirectional,
        )
    edges = g_metrics.edges()
    tel["graph_s"] = time.perf_counter() - t0
    tel["edges"] = len(edges)

    # the default NCC takes the batched path: the identity of every function
    use_batched_ncc = all(f is normalized_cross_correlation for f in metric_funcs.values())
    batched_units = []
    computed = {}
    for fixed_idx, moving_idx in edges:
        t0 = time.perf_counter()
        edge = g_metrics.edges[(fixed_idx, moving_idx)]
        comparison_bbox = edge["comparison_bbox"]
        if comparison_bbox is None:
            logger.warning("Empty comparison bbox for pair (%s -> %s)", fixed_idx, moving_idx)
            computed[(fixed_idx, moving_idx)] = {
                q: {k: np.nan for k in metric_funcs} for q in candidate_keys
            }
            continue
        fixed_spacing = si_utils.get_spacing_from_sim(sims_t0[fixed_idx], asarray=True)
        htol = 1e-3 * float(np.min(fixed_spacing))
        intersection = mv_graph.expand_halfspace(edge["intersection_halfspace"], distance=htol)

        if per_pair_res_level:
            pair_scale_key = msi_utils.get_res_level_from_spacing(msims[fixed_idx], spacing)
            sim_fixed = _sims_t0([msims[fixed_idx].get_scale(pair_scale_key)], metric_channel)[0]
            sim_moving = _sims_t0([msims[moving_idx].get_scale(pair_scale_key)], metric_channel)[0]
        else:
            sim_fixed = sims_t0[fixed_idx]
            sim_moving = sims_t0[moving_idx]

        lower = comparison_bbox["lower"]
        upper = comparison_bbox["upper"]
        spacing_d = spacing if spacing is not None else si_utils.get_spacing_from_sim(sim_fixed)
        output_sp = {
            "origin": {d: float(lower[i]) for i, d in enumerate(spatial_dims)},
            "spacing": {d: float(spacing_d[d]) for d in spatial_dims},
            "shape": {
                d: max(1, int(np.floor((upper[i] - lower[i]) / spacing_d[d] + 1)))
                for i, d in enumerate(spatial_dims)
            },
        }
        computed[(fixed_idx, moving_idx)] = {}
        if use_batched_ncc:
            for q in candidate_keys:
                slot = computed[(fixed_idx, moving_idx)].setdefault(q, {})

                def store(v, slot=slot):
                    for k in metric_funcs:
                        slot[k] = v

                batched_units.append({
                    "fixed_sim": sim_fixed, "moving_sim": sim_moving,
                    "p_moving": edge["transforms"][q], "output_sp": output_sp,
                    "planes": intersection.halfspaces, "store": store,
                })
            tel["plan_s"] += time.perf_counter() - t0
            continue

        sim_fixed_t = transformation.transform_sim(
            sim_fixed.copy(data=np.asarray(sim_fixed.data, dtype=np.float32)),
            p=np.eye(ndim + 1), output_stack_properties=output_sp, cval=np.nan, device=device,
        )
        moving_f32 = sim_moving.copy(data=np.asarray(sim_moving.data, dtype=np.float32))
        for q in candidate_keys:
            sim_moving_t = transformation.transform_sim(
                moving_f32, p=edge["transforms"][q], output_stack_properties=output_sp,
                cval=np.nan, device=device,
            )
            computed[(fixed_idx, moving_idx)][q] = _compute_metrics_from_arrays(
                sim_fixed_t, sim_moving_t, metric_funcs, intersection.halfspaces, device=device,
            )
        tel["host_loop_s"] += time.perf_counter() - t0

    if batched_units:
        _batched_ncc_metrics(batched_units, spatial_dims, device, tel)
    last_telemetry.update(tel)

    for e in edges:
        g_metrics.edges[e]["metrics"] = computed[e]

    # overlap-volume-weighted summary, summed in edge order
    summary = {}
    for q in candidate_keys:
        summary[q] = {}
        for metric_key in metric_funcs:
            pairs_vals = [
                (float(computed[e][q].get(metric_key, np.nan)), float(g_metrics.edges[e]["vol"]))
                for e in edges
            ]
            valid = [(v, w) for v, w in pairs_vals if not np.isnan(v)]
            if valid:
                total_w = sum(w for _, w in valid)
                summary[q][metric_key] = (
                    float(sum(v * w for v, w in valid) / total_w) if total_w > 0 else np.nan
                )
            else:
                summary[q][metric_key] = np.nan

    return {
        "pairs": {e: {q: computed[e][q] for q in candidate_keys} for e in edges},
        "bboxes": {e: g_metrics.edges[e]["comparison_bbox"] for e in edges},
        "summary": summary,
    }
