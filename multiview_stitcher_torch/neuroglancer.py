"""Neuroglancer viewer state.

The port of ``multiview_stitcher_tpu.neuroglancer``: a neuroglancer JSON
state with one zarr layer per source, each layer's affine source transform
taken from a transform key (registration results display without rewriting
pixel data), a time dimension and a layout heuristic; and the state encoded
into a viewer URL. Host code (numpy and the standard library).
"""

from __future__ import annotations

import json
import urllib.parse
from typing import List, Optional

import numpy as np

from multiview_stitcher_torch import si_utils
from multiview_stitcher_torch.param_utils import XAffine

DEFAULT_NEUROGLANCER_URL = "https://neuroglancer-demo.appspot.com"

_NGFF_UNIT_SPECS = {
    "micrometer": (1e-6, "m"),
    "nanometer": (1e-9, "m"),
    "millimeter": (1e-3, "m"),
    "second": (1.0, "s"),
    "millisecond": (1e-3, "s"),
    None: (1, ""),
}


def _dimension_spec(scale, unit):
    factor, ng_unit = _NGFF_UNIT_SPECS.get(unit, (1, unit or ""))
    return [float(scale) * factor, ng_unit]


def _affine_to_source_transform(affine, sdims, output_spacing):
    """Physical affine -> neuroglancer source transform (translation in
    output-dimension units)."""
    affine = np.array(affine, dtype=float, copy=True)
    affine_ndim = affine.shape[-1] - 1
    affine_sdims = sdims[-affine_ndim:]
    spacing_arr = np.array([output_spacing[d] for d in affine_sdims])
    affine[:-1, -1] = affine[:-1, -1] / spacing_arr
    return affine


def _select_affine_sample(affine: XAffine, time_index: int = 0) -> np.ndarray:
    if affine.has_t:
        idx = int(np.clip(time_index or 0, 0, len(affine.t_coords) - 1))
        return np.asarray(affine.data[idx])
    return np.asarray(affine.data)


def _project_source_transform(affine, dims, source_dims):
    indices = [dims.index(d) for d in source_dims]
    keep = indices + [len(dims)]
    return affine[np.ix_(keep, keep)]


def _default_layout(sims) -> str:
    sdims = si_utils.get_spatial_dims_from_sim(sims[0])
    if len(sdims) == 2:
        return "xy"
    shapes = [si_utils.get_shape_from_sim(s) for s in sims]
    displayed = frozenset(
        d for d in sdims if any(shape[d] > 1 for shape in shapes)
    )
    return {
        frozenset(("x", "y")): "xy",
        frozenset(("x", "z")): "xz",
        frozenset(("y", "z")): "yz",
    }.get(displayed, "4panel")


_LAYER_COLORS = ["#ffffff", "#00ff00", "#ff00ff", "#00ffff", "#ffff00", "#ff8000"]

# RGB palette cycled by use_positional_colors
_POSITIONAL_COLORS = [
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 1.0),
    (0.0, 1.0, 1.0),
    (1.0, 1.0, 0.0),
    (1.0, 0.5, 0.0),
    (0.4, 0.4, 1.0),
]


def generate_neuroglancer_json(
    ome_zarr_paths: Optional[List[str]],
    ome_zarr_urls: List[str],
    sims: Optional[list] = None,
    transform_key: Optional[str] = None,
    channel_coord=None,
    single_layer: bool = False,
    contrast_limits: Optional[tuple] = None,
    layer_dicts: Optional[List[dict]] = None,
    global_dict: Optional[dict] = None,
    layout: Optional[str] = None,
    source_dims: Optional[list] = None,
    time_index: int = 0,
    use_positional_colors: bool = False,
    n_positional_colors: int = 2,
) -> dict:
    """Neuroglancer viewer state with one layer per zarr source.

    ``sims`` supply the per-layer transform keys; when None, the sims are
    read from ``ome_zarr_paths`` and carry identity transforms.
    """
    if sims is None:
        if ome_zarr_paths is None:
            raise ValueError("Provide sims when ome_zarr_paths is None.")
        from multiview_stitcher_torch.io import ngff_utils

        sims = [
            ngff_utils.read_sim_from_ome_zarr(p) for p in ome_zarr_paths
        ]
        ome_zarr_paths = None  # stores match the sims by construction

    # on-disk spacing/origin per store: when these differ from the
    # in-memory sims (user rescaled/shifted after writing), the source
    # transform needs a zarr-physical -> mem-physical correction before
    # the registered affine
    zarr_geometry = None
    if ome_zarr_paths is not None:
        from multiview_stitcher_torch.io import ngff_utils

        zarr_geometry = []
        for p in ome_zarr_paths:
            zsim = ngff_utils.read_sim_from_ome_zarr(p)
            zarr_geometry.append((zsim.spacing, zsim.origin))

    sim0 = sims[0]
    sdims = si_utils.get_spatial_dims_from_sim(sim0)
    dims = list(sim0.dims)
    spacing = si_utils.get_spacing_from_sim(sim0)

    if source_dims is None:
        source_dims = [tuple(s.dims) for s in sims]

    # global output dimensions: c/t as index dims, spatial in meters;
    # a stored NGFF time calibration is declared on the t dimension so the
    # viewer shows real time; a bare time dimension stays uncalibrated
    # ([1, ""])
    from multiview_stitcher_torch.io import ngff_utils as _ngff

    time_tf = _ngff.get_ngff_time_transform(sims[0]) if sims else None
    dimensions = {}
    for d in dims:
        if d == "t":
            if time_tf and time_tf.get("unit"):
                dimensions["t"] = _dimension_spec(
                    time_tf["scale"], time_tf["unit"]
                )
            else:
                dimensions["t"] = [1, ""]
        elif d == "c":
            dimensions["c'"] = [1, ""]
        elif d in sdims:
            dimensions[d] = _dimension_spec(spacing[d], "micrometer")

    # channel selection: a layer-local c' dimension pinned to the index of
    # channel_coord
    channel_index = 0
    if channel_coord is not None:
        if "c" not in dims:
            raise ValueError(
                "channel_coord was provided, but the image has no channels."
            )
        c_coords = [str(c) for c in np.asarray(sim0.coords["c"])]
        try:
            channel_index = c_coords.index(str(channel_coord))
        except ValueError:
            raise ValueError(
                f"Channel {channel_coord!r} not found in {c_coords}."
            ) from None

    # positional colors: greedy graph coloring so overlapping/adjacent
    # tiles render in different solid colors, one shader a layer
    layer_shaders = None
    if use_positional_colors:
        if single_layer:
            raise ValueError(
                "use_positional_colors needs one shader per view; a "
                "single merged layer has a single shader. Pass "
                "single_layer=False (or drop use_positional_colors)."
            )
        if transform_key is None:
            raise ValueError(
                "use_positional_colors requires a transform_key."
            )
        from multiview_stitcher_torch import mv_graph

        greedy = mv_graph.get_greedy_colors(
            sims, n_colors=n_positional_colors, transform_key=transform_key
        )
        layer_shaders = []
        for i in range(len(sims)):
            rgb = _POSITIONAL_COLORS[
                greedy[i] % len(_POSITIONAL_COLORS)
            ]
            vec = ", ".join(f"{v:.3f}" for v in rgb)
            layer_shaders.append(
                "#uicontrol invlerp normalized\n"
                "void main() {"
                f" emitRGB(vec3({vec}) * normalized()); "
                "}"
            )

    layers = []
    for i, (url, sim, sdim_list) in enumerate(
        zip(ome_zarr_urls, sims, source_dims)
    ):
        if transform_key is not None and transform_key in sim.transforms:
            aff = _select_affine_sample(
                sim.transforms[transform_key], time_index
            )
            aff = np.array(aff, dtype=float)
            nd = aff.shape[-1] - 1
            aff_sdims = sdims[-nd:]
            if zarr_geometry is not None:
                spacing_zarr, origin_zarr = zarr_geometry[i]
            else:
                spacing_zarr, origin_zarr = sim.spacing, sim.origin
            # zarr-physical -> mem-physical correction (identity when the
            # store geometry matches the sim)
            correction = np.eye(nd + 1)
            for a, d in enumerate(aff_sdims):
                sc = sim.spacing[d] / spacing_zarr[d]
                correction[a, a] = sc
                correction[a, nd] = sim.origin[d] - origin_zarr[d] * sc
            aff = aff @ correction
            aff_full = np.eye(len(dims) + 1)
            spatial_idx = [dims.index(d) for d in aff_sdims]
            for a, ia in enumerate(spatial_idx):
                for b, ib in enumerate(spatial_idx):
                    aff_full[ia, ib] = aff[a, b]
                aff_full[ia, -1] = aff[a, nd]
            spacing_all = {
                d: spacing_zarr.get(d, 1.0) if d in sdims else 1.0
                for d in dims
            }
            aff_full = _affine_to_source_transform(
                aff_full, dims, spacing_all
            )
            matrix = _project_source_transform(
                aff_full, dims, list(sdim_list)
            )[:-1].tolist()
        else:
            n = len(sdim_list)
            matrix = np.eye(n + 1)[:-1].tolist()

        source = {
            "url": f"zarr://{url}",
            "transform": {
                "matrix": matrix,
                "outputDimensions": {
                    ("c'" if d == "c" else d): dimensions.get(
                        "c'" if d == "c" else d, [1, ""]
                    )
                    for d in sdim_list
                },
            },
        }
        layer = {
            "type": "image",
            "source": source,
            "name": f"view {i}",
            "shaderControls": {},
        }
        if "c" in sdim_list:
            layer["localDimensions"] = {"c'": [1, ""]}
            layer["localPosition"] = [channel_index]
        if contrast_limits is not None:
            layer["shaderControls"]["normalized"] = {
                "range": list(contrast_limits)
            }
        if layer_shaders is not None:
            layer["shader"] = layer_shaders[i]
        if layer_dicts is not None and i < len(layer_dicts):
            layer.update(layer_dicts[i])
        layers.append(layer)

    if single_layer:
        # all sources in ONE layer named "Tiles": shared local channel dim,
        # first layer's display settings win
        merged = {
            "type": "image",
            "source": [lyr["source"] for lyr in layers],
            "name": "Tiles",
            "shaderControls": layers[0]["shaderControls"] if layers else {},
        }
        if any("c" in sd for sd in source_dims):
            merged["localDimensions"] = {"c'": [1, ""]}
            merged["localPosition"] = [channel_index]
        if layer_dicts:
            merged.update(layer_dicts[0])
        layers = [merged]

    state = {
        "dimensions": dimensions,
        "layers": layers,
        "layout": layout or _default_layout(sims),
    }
    if global_dict:
        state.update(global_dict)
    return state


def get_neuroglancer_url(ng_json: dict, neuroglancer_url: Optional[str] = None) -> str:
    """Encode a viewer state into a neuroglancer URL."""
    base = neuroglancer_url or DEFAULT_NEUROGLANCER_URL
    encoded = urllib.parse.quote(
        json.dumps(ng_json, separators=(",", ":")), safe=""
    )
    return f"{base}/#!{encoded}"
