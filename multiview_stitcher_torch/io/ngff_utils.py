"""OME-Zarr (NGFF 0.4) levels and metadata, on the port's zarr v2 IO.

A subset of ``multiview_stitcher_tpu.io.ngff_utils`` under the same names:
what ``fuse(output_zarr_url=...)`` writes through (the per-level
coordinate transformations, the block-wise pyramid from a level 0 written
chunk by chunk, the multiscales and omero metadata) and reads its result back
with. The writers for in-memory sims and msims and the virtual NGFF server
wait for ROADMAP.md items 10 and 16. NGFF stores no affines: a sim read back
carries an identity transform.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional

import numpy as np

from multiview_stitcher_torch import msi_utils, si_utils
from multiview_stitcher_torch.io import zarr_backend
from multiview_stitcher_torch.si_utils import Sim

DEFAULT_NGFF_TIME_TRANSFORM = {"scale": 1.0, "translation": 0.0, "unit": None}


def calc_ngff_coordinate_transformations_and_axes(
    stack_properties_res0: dict,
    res_abs_factors: List[dict],
    nsdims: Optional[list] = None,
    time_transform: Optional[dict] = None,
):
    """Per-level scale and translation metadata, and the axes list."""
    nsdims = nsdims or []
    spacing = stack_properties_res0["spacing"]
    origin = stack_properties_res0["origin"]
    sdims = list(spacing.keys())

    time_transform = {**DEFAULT_NGFF_TIME_TRANSFORM, **(time_transform or {})}
    nsdim_scales = [float(time_transform["scale"]) if d == "t" else 1.0 for d in nsdims]
    nsdim_translations = [
        float(time_transform["translation"]) if d == "t" else 0.0 for d in nsdims
    ]

    coordtfs = [
        [
            {"type": "scale", "scale": nsdim_scales + [float(spacing[d] * f[d]) for d in sdims]},
            {
                "type": "translation",
                "translation": nsdim_translations
                + [float(origin[d] + (f[d] - 1) * spacing[d] / 2) for d in sdims],
            },
        ]
        for f in res_abs_factors
    ]

    axes = [
        {
            "name": d,
            "type": "channel" if d == "c" else ("time" if d == "t" else "space"),
            **({"unit": "micrometer"} if d in sdims else {}),
            **(
                {"unit": time_transform["unit"]}
                if d == "t" and time_transform["unit"]
                else {}
            ),
        }
        for d in nsdims + sdims
    ]
    return coordtfs, axes


def finalize_ome_zarr_levels(
    output_zarr_url: str,
    dims,
    stack_properties: dict,
    ngff_version: str = "0.4",
    c_coords=None,
    downscale_factors_per_spatial_dim: Optional[Dict[str, int]] = None,
    block_size: int = 512,
):
    """Complete an OME-Zarr whose level 0 was written chunk by chunk: build
    each pyramid level block by block from the one before (never a whole
    level in memory) and write the multiscales and omero metadata."""
    if ngff_version != "0.4":
        raise NotImplementedError(zarr_backend._V3)
    dims = tuple(dims)
    sdims = [d for d in dims if d in si_utils.SPATIAL_DIMS]
    nsdims = [d for d in dims if d not in si_utils.SPATIAL_DIMS]
    spacing = {d: float(stack_properties["spacing"][d]) for d in sdims}
    origin = {d: float(stack_properties["origin"][d]) for d in sdims}
    spatial_shape = {d: int(stack_properties["shape"][d]) for d in sdims}

    res_shapes, res_rel_factors, res_abs_factors = msi_utils.calc_resolution_levels(
        spatial_shape,
        downscale_factors_per_spatial_dim=downscale_factors_per_spatial_dim,
    )
    n_res = len(res_shapes)

    prev = zarr_backend.open_zarr_array(f"{output_zarr_url}/0")
    prev_shape = prev.shape
    for level in range(1, n_res):
        rel = res_rel_factors[level]
        factors = [rel.get(d, 1) if d in sdims else 1 for d in dims]
        new_shape = tuple(s // f for s, f in zip(prev_shape, factors))
        chunks = [
            1 if d in nsdims else min(block_size, new_shape[i]) for i, d in enumerate(dims)
        ]
        arr = zarr_backend.create_zarr_array(
            f"{output_zarr_url}/{level}",
            shape=new_shape,
            chunks=chunks,
            dtype=prev.dtype,
            overwrite=True,
        )
        # block-wise: read a factor-aligned window of prev, coarsen, write
        n_blocks = [-(-new_shape[i] // chunks[i]) for i in range(len(dims))]
        for bi in itertools.product(*[range(n) for n in n_blocks]):
            out_sl = tuple(
                slice(bi[i] * chunks[i], min((bi[i] + 1) * chunks[i], new_shape[i]))
                for i in range(len(dims))
            )
            in_sl = tuple(
                slice(out_sl[i].start * factors[i], out_sl[i].stop * factors[i])
                for i in range(len(dims))
            )
            arr[out_sl] = msi_utils._coarsen_mean(np.asarray(prev[in_sl]), factors)
        prev = arr
        prev_shape = new_shape

    coordtfs, axes = calc_ngff_coordinate_transformations_and_axes(
        {"spacing": spacing, "origin": origin, "shape": spatial_shape},
        res_abs_factors,
        nsdims=nsdims,
    )
    multiscales = [
        {
            "axes": axes,
            "datasets": [
                {"path": f"{level}", "coordinateTransformations": coordtfs[level]}
                for level in range(n_res)
            ],
            "version": ngff_version,
        }
    ]
    attrs = {"multiscales": multiscales}
    if c_coords is not None:
        attrs["omero"] = {
            "channels": [
                {
                    "color": "ffffff",
                    "label": f"{ch}",
                    "active": True,
                    "window": {"end": 65535, "max": 65535, "min": 0, "start": 0},
                }
                for ch in np.asarray(c_coords)
            ]
        }
    zarr_backend.write_group_metadata(str(output_zarr_url), attrs)


def _parse_multiscales(attrs: dict):
    if "ome" in attrs:
        return attrs["ome"]["multiscales"][0], attrs
    return attrs["multiscales"][0], attrs


def read_sim_from_ome_zarr(
    zarr_path,
    resolution_level: int = 0,
    transform_key: str = si_utils.DEFAULT_TRANSFORM_KEY,
    prior_sim: Optional[Sim] = None,
) -> Sim:
    """One resolution level as a lazy zarr-backed sim, with an identity
    transform under ``transform_key``; ``prior_sim`` may supply transform
    keys to carry over."""
    attrs, zarr_format = zarr_backend.read_group_metadata(str(zarr_path))
    ms, attrs = _parse_multiscales(attrs)
    datasets = ms["datasets"]
    if resolution_level >= len(datasets):
        raise ValueError(f"Resolution level {resolution_level} not found in {zarr_path}")
    ds = datasets[resolution_level]
    axes = [a["name"] for a in ms["axes"]]
    arr = zarr_backend.open_zarr_array(
        os.path.join(str(zarr_path), ds["path"]), zarr_format=zarr_format
    )

    scale = [1.0] * len(axes)
    translation = [0.0] * len(axes)
    for tf in ds.get("coordinateTransformations", []):
        if tf["type"] == "scale":
            scale = tf["scale"]
        elif tf["type"] == "translation":
            translation = tf["translation"]

    sdims = [a for a in axes if a in si_utils.SPATIAL_DIMS]
    c_coords = None
    if "omero" in attrs and "c" in axes:
        c_coords = [ch["label"] for ch in attrs["omero"]["channels"]]

    sim = si_utils.get_sim_from_array(
        arr,
        dims=axes,
        scale={d: float(scale[axes.index(d)]) for d in sdims},
        translation={d: float(translation[axes.index(d)]) for d in sdims},
        transform_key=transform_key,
        c_coords=c_coords,
    )
    if "t" in axes:
        it = axes.index("t")
        unit = next((a.get("unit") for a in ms["axes"] if a["name"] == "t"), None)
        tt = {"scale": float(scale[it]), "translation": float(translation[it]), "unit": unit}
        if tt != DEFAULT_NGFF_TIME_TRANSFORM:
            sim.attrs["ngff_time_transform"] = tt
    if prior_sim is not None:
        for key, xaff in prior_sim.transforms.items():
            sim.transforms[key] = xaff.copy()
    return sim
