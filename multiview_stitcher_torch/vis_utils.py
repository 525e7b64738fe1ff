"""Visualisation and viewer helpers.

The port of ``multiview_stitcher_tpu.vis_utils``: tile-layout plots with
coloured edges (the registration summaries of ``register(plot_summary=True)``),
image display, metric plots, static file serving and the neuroglancer entry
points. Host code: matplotlib is imported inside the plotting functions only
(the port needs it nowhere else), and a sim over a device tensor is
downloaded where a figure needs its pixels.
"""

from __future__ import annotations

import http.server
import logging
import os
import socketserver
import threading
from typing import List, Optional

import numpy as np

from multiview_stitcher_torch import msi_utils, mv_graph, param_utils, si_utils
from multiview_stitcher_torch.msi_utils import Msim

logger = logging.getLogger(__name__)


def _to_sims(images):
    return [
        msi_utils.get_sim_from_msim(im) if isinstance(im, Msim) else im
        for im in images
    ]


def plot_positions(
    sims,
    transform_key: str,
    edges=None,
    edge_color_vals=None,
    edge_linestyles=None,
    edge_linestyle_labels=None,
    edge_cmap=None,
    edge_clims=None,
    edge_label: str = "edge weight",
    use_positional_colors: bool = True,
    n_colors: int = 2,
    nscoord: Optional[dict] = None,
    display_view_indices: bool = True,
    view_labels: Optional[List[str]] = None,
    view_labels_size: int = 10,
    show_plot: bool = True,
    plot_title: Optional[str] = None,
    spacing: Optional[dict] = None,
    output_filename: Optional[str] = None,
    points_key: Optional[str] = None,
):
    """Plot tile/view positions (2D or 3D) with optional colored edges.

    Returns (fig, ax).
    """
    import matplotlib
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from matplotlib.lines import Line2D

    sims = _to_sims(sims)
    nscoord = nscoord or {}
    sims = [
        si_utils.sim_sel_coords(
            sim,
            {
                nd: nscoord.get(nd, np.asarray(sim.coords[nd])[0])
                for nd in si_utils.get_nonspatial_dims_from_sim(sim)
            },
        )
        if si_utils.get_nonspatial_dims_from_sim(sim)
        else sim
        for sim in sims
    ]
    ndim = si_utils.get_ndim_from_sim(sims[0])
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])

    if spacing is not None:
        for sim in sims:
            sim.spacing = {d: float(spacing[d]) for d in sdims}

    if use_positional_colors:
        colors_idx = mv_graph.get_greedy_colors(
            sims, n_colors=n_colors, transform_key=transform_key
        )
        palette = ["tab:blue", "tab:orange", "tab:green", "tab:red"]
        view_colors = [
            palette[colors_idx[i] % len(palette)] for i in range(len(sims))
        ]
    else:
        view_colors = ["gray"] * len(sims)

    fig = plt.figure()
    if ndim == 3:
        ax = fig.add_subplot(projection="3d")
    else:
        ax = fig.add_subplot()

    centers = []
    for isim, sim in enumerate(sims):
        props = si_utils.get_stack_properties_from_sim(
            sim, transform_key=transform_key
        )
        verts = mv_graph.get_vertices_from_stack_props(props)
        center = verts.mean(axis=0)
        centers.append(center)
        # draw box edges between vertices differing in exactly one bit
        nv = len(verts)
        bits = np.array(list(np.ndindex((2,) * ndim)))
        for i in range(nv):
            for j in range(i + 1, nv):
                if np.sum(bits[i] != bits[j]) == 1:
                    seg = np.stack([verts[i], verts[j]])
                    if ndim == 3:
                        ax.plot(
                            seg[:, 2], seg[:, 1], seg[:, 0],
                            color=view_colors[isim], linewidth=1,
                        )
                    else:
                        ax.plot(
                            seg[:, 1], seg[:, 0],
                            color=view_colors[isim], linewidth=1,
                        )
        if display_view_indices or view_labels is not None:
            label = (
                view_labels[isim] if view_labels is not None else str(isim)
            )
            if ndim == 3:
                ax.text(
                    center[2], center[1], center[0], label,
                    size=view_labels_size,
                )
            else:
                ax.text(center[1], center[0], label, size=view_labels_size)

        if points_key is not None and points_key in sim.attrs.get(
            "point_sets", {}
        ):
            pts = np.asarray(sim.attrs["point_sets"][points_key])
            aff = si_utils.get_affine_from_sim(sim, transform_key)
            mat = np.asarray(aff.squeeze())
            if mat.ndim == 3:
                mat = mat[0]
            pts_w = param_utils.transform_pts(pts, mat)
            if ndim == 3:
                ax.scatter(pts_w[:, 2], pts_w[:, 1], pts_w[:, 0], s=2)
            else:
                ax.scatter(pts_w[:, 1], pts_w[:, 0], s=2)

    centers = np.asarray(centers)

    if edges is not None and len(edges):
        if edge_cmap is None:
            edge_cmap = "viridis"
        cmap = matplotlib.colormaps[edge_cmap]
        vals = (
            np.asarray(edge_color_vals, dtype=float)
            if edge_color_vals is not None
            else np.zeros(len(edges))
        )
        finite = vals[np.isfinite(vals)]
        if edge_clims is None:
            edge_clims = (
                [float(finite.min()), float(finite.max())]
                if finite.size and finite.min() != finite.max()
                else [0, 1]
            )
        if isinstance(edge_linestyles, str) or edge_linestyles is None:
            edge_linestyles = [edge_linestyles or "--"] * len(edges)
        for (i, j), val, ls in zip(edges, vals, edge_linestyles):
            norm_val = (
                (val - edge_clims[0]) / (edge_clims[1] - edge_clims[0])
                if edge_clims[1] > edge_clims[0]
                else 0.5
            )
            color = cmap(np.clip(norm_val, 0, 1)) if np.isfinite(val) else "gray"
            seg = np.stack([centers[i], centers[j]])
            if ndim == 3:
                ax.plot(
                    seg[:, 2], seg[:, 1], seg[:, 0],
                    color=color, linestyle=ls, linewidth=2,
                )
            else:
                ax.plot(
                    seg[:, 1], seg[:, 0], color=color, linestyle=ls,
                    linewidth=2,
                )
        sm = cm.ScalarMappable(
            cmap=cmap,
            norm=matplotlib.colors.Normalize(*edge_clims),
        )
        fig.colorbar(sm, ax=ax, label=edge_label)
        if edge_linestyle_labels:
            items = (
                edge_linestyle_labels.items()
                if isinstance(edge_linestyle_labels, dict)
                else edge_linestyle_labels
            )
            handles = [
                Line2D([0], [0], color="black", linestyle=ls, label=lbl)
                for ls, lbl in items
            ]
            ax.legend(handles=handles)

    ax.set_xlabel(sdims[-1])
    ax.set_ylabel(sdims[-2])
    if ndim == 2:
        ax.invert_yaxis()
        ax.set_aspect("equal")
    if plot_title:
        ax.set_title(plot_title)
    if output_filename:
        fig.savefig(output_filename, dpi=150, bbox_inches="tight")
    if show_plot:
        plt.show(block=False)
    return fig, ax


def imshow(
    image,
    transform_key: Optional[str] = None,
    nscoord: Optional[dict] = None,
    resolution_level: int = 0,
    ax=None,
    project_dim: Optional[str] = None,
    horizontal_dim: Optional[str] = None,
    vertical_dim: Optional[str] = None,
    points_key: Optional[str] = None,
    points_tolerance: float = 1.0,
    figure_kwargs: Optional[dict] = None,
    imshow_kwargs: Optional[dict] = None,
    scatter_kwargs: Optional[dict] = None,
    show_plot: bool = False,
    **extra_imshow_kwargs,
):
    """Display a (projected or sliced) sim with physical extent.

    ``project_dim`` picks the max-projected spatial dim for 3D input
    (default: whichever is not displayed); ``horizontal_dim`` /
    ``vertical_dim`` choose the displayed axes (defaults x / y).
    ``points_key`` overlays the sim's named point set (intrinsic physical
    coords) on the displayed plane. When ``nscoord`` carries a WORLD
    coordinate for the hidden spatial dim, that slice is shown instead of
    the projection and points farther than ``points_tolerance`` pixels
    from it are hidden. ``imshow_kwargs``/extra kwargs forward to
    ``ax.imshow``; ``figure_kwargs`` to ``plt.subplots``. A sim over a
    device tensor is downloaded after the slice or projection.
    """
    import matplotlib.pyplot as plt

    imshow_kwargs = {**(imshow_kwargs or {}), **extra_imshow_kwargs}
    points_tolerance = float(points_tolerance)
    if points_tolerance < 0:
        raise ValueError("points_tolerance must be >= 0.")

    sim = (
        image.get_scale(f"scale{resolution_level}")
        if isinstance(image, Msim)
        else image
    )
    nscoord = nscoord or {}
    nsdims = si_utils.get_nonspatial_dims_from_sim(sim)
    if nsdims:
        sim = si_utils.sim_sel_coords(
            sim,
            {nd: nscoord.get(nd, np.asarray(sim.coords[nd])[0]) for nd in nsdims},
        )
    sdims = si_utils.get_spatial_dims_from_sim(sim)
    for name, val in [
        ("project_dim", project_dim),
        ("horizontal_dim", horizontal_dim),
        ("vertical_dim", vertical_dim),
    ]:
        if val is not None and val not in sdims:
            raise ValueError(f"{name} must be one of {sdims}, got {val!r}")

    def _pick(requested, preferred, other):
        if requested is not None:
            if requested == project_dim:
                raise ValueError(
                    "horizontal/vertical_dim must differ from project_dim"
                )
            return requested
        for d in preferred:
            if d in sdims and d != project_dim and d != other:
                return d
        for d in sdims:
            if d != project_dim and d != other:
                return d
        raise ValueError("need two displayed spatial dimensions")

    horizontal_dim = _pick(horizontal_dim, ["x", "z", "y"], vertical_dim)
    vertical_dim = _pick(vertical_dim, ["y", "z", "x"], horizontal_dim)
    if horizontal_dim == vertical_dim:
        raise ValueError(
            f"horizontal_dim and vertical_dim must differ, both are "
            f"{horizontal_dim!r}"
        )

    pts = keep = None
    col = {d: i for i, d in enumerate(sdims)}
    if points_key is not None:
        pts = np.asarray(si_utils.get_point_set(sim, points_key=points_key))
        keep = np.ones(len(pts), dtype=bool)

    if len(sdims) == 3:
        drop = project_dim or next(
            d for d in sdims if d not in (horizontal_dim, vertical_dim)
        )
        if drop in (horizontal_dim, vertical_dim):
            raise ValueError("3D display needs a projected dimension")
        if drop in nscoord:
            # WORLD coordinate for the hidden dim: show that slice and
            # hide points beyond points_tolerance pixels from it
            o, sp = sim.origin[drop], sim.spacing[drop]
            idx = int(
                np.clip(
                    round((float(nscoord[drop]) - o) / sp),
                    0,
                    sim.sizes[drop] - 1,
                )
            )
            sim = sim.isel({drop: idx})
            if pts is not None:
                keep &= (
                    np.abs(pts[:, col[drop]] - (o + idx * sp))
                    <= points_tolerance * sp
                )
        else:
            sim = si_utils.max_project_sim(sim, dim=drop)
        sdims = sim.spatial_dims

    points = None
    if pts is not None:
        points = pts[keep][:, [col[horizontal_dim], col[vertical_dim]]]

    data = sim.to_numpy()
    if (vertical_dim, horizontal_dim) != tuple(sdims):
        data = data.T
    y0, x0 = sim.origin[vertical_dim], sim.origin[horizontal_dim]
    sy, sx = sim.spacing[vertical_dim], sim.spacing[horizontal_dim]
    extent = [
        x0 - sx / 2,
        x0 + (data.shape[1] - 0.5) * sx,
        y0 + (data.shape[0] - 0.5) * sy,
        y0 - sy / 2,
    ]
    if ax is None:
        _, ax = plt.subplots(**(figure_kwargs or {}))
    ax.imshow(data, extent=extent, **imshow_kwargs)
    if points is not None and len(points):
        ax.scatter(
            points[:, 0], points[:, 1],
            **{"ec": "red", "fc": "none", "s": 40, **(scatter_kwargs or {})},
        )
    ax.set_xlabel(horizontal_dim)
    ax.set_ylabel(vertical_dim)
    if show_plot:
        plt.show()
    return ax


def plot_tile_pair_image_metrics(metrics_result, metric_key: str = "ncc", ax=None):
    """Bar plot of per-pair metrics per candidate key (the result of
    ``metrics.tile_pair_image_metrics``)."""
    import matplotlib.pyplot as plt

    pairs = metrics_result["pairs"]
    candidate_keys = (
        list(next(iter(pairs.values())).keys()) if pairs else []
    )
    if ax is None:
        _, ax = plt.subplots()
    width = 0.8 / max(1, len(candidate_keys))
    pair_labels = [f"{a}-{b}" for a, b in pairs]
    x = np.arange(len(pairs))
    for qi, q in enumerate(candidate_keys):
        vals = [pairs[p][q].get(metric_key, np.nan) for p in pairs]
        ax.bar(x + qi * width, vals, width=width, label=str(q))
    ax.set_xticks(x + 0.4 - width / 2)
    ax.set_xticklabels(pair_labels, rotation=45)
    ax.set_ylabel(metric_key)
    ax.legend()
    return ax


def plot_registration_summaries(
    msims,
    transform_key,
    new_transform_key,
    g_reg_computed,
    groupwise_resolution_info_dict,
    show_plot=True,
):
    """Pairwise-quality and residual summary plots of a ``register()``
    call: the views under ``transform_key`` with each registered edge
    coloured by its quality, and under ``new_transform_key`` by its
    remaining residual (solid where the resolution used it)."""
    edges = list(g_reg_computed.edges())
    fig_pair, ax_pair = plot_positions(
        msims,
        transform_key=transform_key,
        edges=edges,
        edge_color_vals=np.array(
            [
                float(np.nanmean(np.asarray(g_reg_computed[e[0]][e[1]]["quality"], dtype=float)))
                for e in edges
            ]
        ),
        edge_label="Pairwise view correlation",
        display_view_indices=True,
        use_positional_colors=False,
        plot_title="Pairwise registration summary",
        show_plot=show_plot,
    )

    fig_res, ax_res = None, None
    if groupwise_resolution_info_dict is not None and new_transform_key:
        edge_residuals = groupwise_resolution_info_dict.get(
            "edge_residuals", {}
        )
        if isinstance(edge_residuals, dict):
            edge_residuals = edge_residuals.get(0, {})
        used = groupwise_resolution_info_dict.get("used_edges", {})
        if isinstance(used, dict):
            used = used.get(0, [])
        used_set = {tuple(sorted(e)) for e in used} if used else set()
        vals = np.array(
            [edge_residuals.get(tuple(sorted(e)), np.nan) for e in edges]
        )
        styles = ["-" if tuple(sorted(e)) in used_set else ":" for e in edges]
        fig_res, ax_res = plot_positions(
            msims,
            transform_key=new_transform_key,
            edges=edges,
            edge_color_vals=vals,
            edge_linestyles=styles,
            edge_linestyle_labels={"-": "Used edges", ":": "Unused edges"},
            edge_cmap="Spectral_r",
            edge_label="Remaining edge residuals [distance units]",
            display_view_indices=True,
            use_positional_colors=False,
            plot_title="Global parameter resolution summary",
            show_plot=show_plot,
        )
    return {
        "fig_pair_reg": fig_pair,
        "ax_pair_reg": ax_pair,
        "fig_group_res": fig_res,
        "ax_group_res": ax_res,
    }


# ---------------------------------------------------------------------------
# static file serving
# ---------------------------------------------------------------------------


class _CORSHandler(http.server.SimpleHTTPRequestHandler):
    quiet = True

    def end_headers(self):
        self.send_header("Access-Control-Allow-Origin", "*")
        super().end_headers()

    def log_message(self, fmt, *args):
        if not self.quiet:
            logger.info("%s - %s", self.address_string(), fmt % args)


def serve_dir(dir_path: str, port: int = 8000):
    """Serve a directory over HTTP with CORS (for viewer access).

    Returns (server, thread); call ``server.shutdown()`` to stop.
    """
    handler = lambda *args, **kw: _CORSHandler(
        *args, directory=str(dir_path), **kw
    )
    server = socketserver.ThreadingTCPServer(("127.0.0.1", port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


# ---------------------------------------------------------------------------
# viewer entry points
# ---------------------------------------------------------------------------


def view_neuroglancer(
    images=None,
    ome_zarr_paths: Optional[List[str]] = None,
    transform_key: Optional[str] = None,
    port: int = 8000,
    neuroglancer_url: Optional[str] = None,
    open_browser: bool = False,
    **ng_kwargs,
):
    """Serve images as (virtual) OME-Zarr and build a neuroglancer URL.

    Returns (url, server) — the server keeps
    the chunks available; shut it down when done.
    """
    from multiview_stitcher_torch import neuroglancer as ng
    from multiview_stitcher_torch.io import virtual_ngff

    server = None
    if ome_zarr_paths is not None:
        sims = None
        channel_colormaps = ng_kwargs.pop("channel_colormaps", None)
        restore = []
        if channel_colormaps is not None:
            # patch OMERO display metadata into the on-disk stores only
            # while they are served; shutdown restores the originals
            from multiview_stitcher_torch.io import ngff_utils, zarr_backend

            try:
                for p in ome_zarr_paths:
                    attrs, zf = zarr_backend.read_group_metadata(str(p))
                    restore.append((str(p), dict(attrs), zf))
                    zsim = ngff_utils.read_sim_from_ome_zarr(p)
                    patched = dict(attrs)
                    patched["omero"] = _omero_channels_for_colormaps(
                        zsim, channel_colormaps
                    )
                    zarr_backend.write_group_metadata(str(p), patched, zf)
            except BaseException:
                # a mid-loop failure must not leave earlier stores with
                # patched display metadata on disk
                for p, attrs, zf in restore:
                    zarr_backend.write_group_metadata(p, attrs, zf)
                raise
        try:
            server, _ = serve_dir(
                os.path.commonpath(ome_zarr_paths), port=port
            )
        except BaseException:
            if restore:
                from multiview_stitcher_torch.io import zarr_backend

                for p, attrs, zf in restore:
                    zarr_backend.write_group_metadata(p, attrs, zf)
            raise
        if restore:
            orig_shutdown = server.shutdown

            def shutdown(_restore=restore, _orig=orig_shutdown):
                from multiview_stitcher_torch.io import zarr_backend

                for p, attrs, zf in _restore:
                    zarr_backend.write_group_metadata(p, attrs, zf)
                _orig()

            server.shutdown = shutdown
        urls = [
            f"http://127.0.0.1:{port}/"
            + os.path.relpath(p, os.path.commonpath(ome_zarr_paths))
            for p in ome_zarr_paths
        ]
    else:
        sims = _to_sims(images)
        omero_channels = None
        channel_colormaps = ng_kwargs.pop("channel_colormaps", None)
        if channel_colormaps is not None:
            omero_channels = [
                _omero_channels_for_colormaps(s, channel_colormaps)
                for s in sims
            ]
        server = virtual_ngff.serve_virtual_ome_zarrs(
            sims, port=port, transform_key=transform_key,
            omero_channels=omero_channels,
        )
        urls = [
            f"http://127.0.0.1:{port}/{i}.ome.zarr" for i in range(len(sims))
        ]

    ng_json = ng.generate_neuroglancer_json(
        ome_zarr_paths=ome_zarr_paths,
        ome_zarr_urls=urls,
        sims=sims,
        transform_key=transform_key,
        **ng_kwargs,
    )
    url = ng.get_neuroglancer_url(ng_json, neuroglancer_url=neuroglancer_url)
    if open_browser:
        import webbrowser

        webbrowser.open(url)
    return url, server


def _colormap_to_omero_color(colormap) -> str:
    """A colormap's high-intensity color as an OMERO RRGGBB value."""
    from matplotlib import colormaps as mpl_colormaps
    from matplotlib import colors as mpl_colors

    cmap = (
        mpl_colormaps.get_cmap(colormap)
        if isinstance(colormap, str)
        else colormap
    )
    return mpl_colors.to_hex(cmap(1.0), keep_alpha=False)[1:].upper()


def _omero_channels_for_colormaps(sim, channel_colormaps) -> dict:
    """Per-channel OMERO display metadata with colors drawn from the
    given colormaps, for a served source (which it leaves as it is)."""
    labels = (
        [str(c) for c in np.asarray(sim.coords["c"])]
        if "c" in sim.dims
        else ["0"]
    )
    if len(channel_colormaps) != len(labels):
        raise ValueError(
            "The number of colormaps must match the number of channels; "
            f"expected {len(labels)}, got {len(channel_colormaps)}."
        )
    dtype = si_utils.numpy_dtype(sim.dtype)
    hi = float(np.iinfo(dtype).max) if dtype.kind in "iu" else 1.0
    return {
        "channels": [
            {
                "label": label,
                "color": (
                    _colormap_to_omero_color(cm) if cm is not None
                    else "FFFFFF"
                ),
                "active": True,
                "window": {"min": 0, "max": hi, "start": 0, "end": hi},
            }
            for label, cm in zip(labels, channel_colormaps)
        ]
    }


def view_ome_zarr(image_path: str, port: int = 8000, **kwargs):
    """Serve an on-disk OME-Zarr and build its neuroglancer URL."""
    return view_neuroglancer(
        ome_zarr_paths=[str(image_path)], port=port, **kwargs
    )


def serve_dir_https(dir_path: str, port: int = 8000, host: str = "127.0.0.1",
                    certfile: str = "cert.pem", keyfile: str = "key.pem",
                    quiet: bool = False):
    """HTTPS variant of :func:`serve_dir`; ``quiet`` suppresses per-request
    logging."""
    import ssl

    handler_cls = type("Handler", (_CORSHandler,), {"quiet": quiet})
    handler = lambda *args, **kw: handler_cls(
        *args, directory=str(dir_path), **kw
    )
    server = socketserver.ThreadingTCPServer((host, port), handler)
    server.daemon_threads = True
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=certfile, keyfile=keyfile)
    server.socket = ctx.wrap_socket(server.socket, server_side=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def get_contrast_min_max_from_ome_zarr_omero_metadata(
    ome_zarr_path, channel_label=None
):
    """(start, end) display window of one channel from omero metadata,
    selected by label (first channel when None); None without omero
    metadata."""
    from multiview_stitcher_torch.io import zarr_backend

    attrs, _ = zarr_backend.read_group_metadata(str(ome_zarr_path))
    if "omero" not in attrs:
        return None
    channels = attrs["omero"]["channels"]
    if channel_label is None:
        channel_index = 0
    else:
        matches = [
            ic
            for ic, c in enumerate(channels)
            if str(c.get("label")) == str(channel_label)
        ]
        if len(matches) != 1:
            raise ValueError(
                f"Channel {channel_label} not found in metadata in "
                f"{ome_zarr_path}"
            )
        channel_index = matches[0]
    window = channels[channel_index]["window"]
    return np.array([window["start"], window["end"]])


def plot_msim_with_points(*args, **kwargs):
    """Alias of :func:`imshow`."""
    return imshow(*args, **kwargs)


def plot_stack_props(stack_props, ax, color="black", size=10, linewidth=1):
    """Draw a stack-properties bounding box on an existing axes. Works for
    2D and 3D axes; edges
    connect vertices differing in exactly one bit of the index
    hypercube, robust to arbitrary affines."""
    verts = mv_graph.get_vertices_from_stack_props(stack_props)
    ndim = verts.shape[1]
    bits = np.array(list(np.ndindex((2,) * ndim)))
    for i in range(len(verts)):
        for j in range(i + 1, len(verts)):
            if np.sum(bits[i] != bits[j]) == 1:
                seg = np.stack([verts[i], verts[j]])
                if ndim == 3:
                    ax.plot(
                        seg[:, 2], seg[:, 1], seg[:, 0],
                        color=color, linewidth=linewidth,
                    )
                else:
                    ax.plot(
                        seg[:, 1], seg[:, 0],
                        color=color, linewidth=linewidth,
                    )
    return ax
