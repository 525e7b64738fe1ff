"""OME-Zarr levels and metadata, NGFF 0.4 (zarr v2) and 0.5 (zarr v3, with
shards), on the port's zarr IO.

A subset of ``multiview_stitcher_tpu.io.ngff_utils`` under the same names:
the per-level coordinate transformations, the block-wise pyramid from a
level 0 written chunk by chunk (what ``fuse(output_zarr_url=...)`` writes
through), the writers of sims and msims, and the readers of one level as a
sim and of all levels as an msim. NGFF stores no affines: a sim read back
carries an identity transform, and an msim's named transforms are kept in
the group's attributes under :data:`TRANSFORMS_ATTR_KEY`, as the reference
package keeps them, so that a store written by either package carries its
transforms into the other. NGFF 0.5 nests the multiscales under an ``ome``
attribute with its version, as the reference writes it (its omero channels
stay at the top level, as there). Also the NGFF time calibration of sims and
msims, and the reference's in-memory NGFF containers (:class:`NgffImage`,
:class:`NgffMultiscales`) with their conversions. The virtual OME-Zarr
stores and their server live in ``io.virtual_ngff``; ``serve_virtual_ome_zarrs``
and the ``VirtualOMEZarr*`` names are reached from here too, as in the
reference.
"""

from __future__ import annotations

import itertools
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from multiview_stitcher_torch import msi_utils, param_utils, si_utils
from multiview_stitcher_torch.io import zarr_backend
from multiview_stitcher_torch.msi_utils import Msim
from multiview_stitcher_torch.ops import pyramid as tpyramid
from multiview_stitcher_torch.param_utils import XAffine
from multiview_stitcher_torch.si_utils import Sim
from multiview_stitcher_torch.utils import profiling

# the group attribute that holds an msim's named transforms: the reference
# package's key, so that stores interoperate
TRANSFORMS_ATTR_KEY = "multiview_stitcher_tpu:transforms"

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


def _zarr_format(ngff_version: str) -> int:
    if ngff_version not in ("0.4", "0.5"):
        raise ValueError(f"ngff_version must be '0.4' or '0.5', got {ngff_version!r}")
    return 2 if ngff_version == "0.4" else 3


def _averages_on_card(device, dtype) -> bool:
    """Whether :func:`_build_levels` averages its blocks with the CUDA kernel
    of ``ops.pyramid``: on a CUDA device, for ``uint8`` and ``uint16`` data."""
    return (device is not None and torch.device(device).type == "cuda"
            and np.dtype(dtype) in (np.uint8, np.uint16))


@profiling.stage("fuse.pyramid")
def _build_levels(output_zarr_url, dims, spatial_shape, zarr_format, layout,
                  downscale_factors_per_spatial_dim=None, device=None):
    """Build pyramid levels 1 and up of the OME-Zarr at ``output_zarr_url``
    from its level 0, block by block from the level before (never a whole
    level in memory): ``layout(shape)`` gives a level's (chunks, shards),
    and a block is one shard (or chunk), so that no block shares a file.
    With a CUDA ``device``, ``uint8`` and ``uint16`` blocks are averaged
    there by ``ops.pyramid.coarsen_mean`` (exact integer sums, bit-equal to
    ``msi_utils._coarsen_mean``); other dtypes, and every call on the CPU or
    without a device, take ``msi_utils._coarsen_mean`` on the host.
    Returns the plan's absolute factors."""
    dims = tuple(dims)
    sdims = [d for d in dims if d in si_utils.SPATIAL_DIMS]
    res_shapes, res_rel_factors, res_abs_factors = msi_utils.calc_resolution_levels(
        spatial_shape,
        downscale_factors_per_spatial_dim=downscale_factors_per_spatial_dim,
    )
    prev = zarr_backend.open_zarr_array(f"{output_zarr_url}/0")
    prev_shape = prev.shape
    on_card = _averages_on_card(device, prev.dtype)
    for level in range(1, len(res_shapes)):
        rel = res_rel_factors[level]
        factors = [rel.get(d, 1) if d in sdims else 1 for d in dims]
        new_shape = tuple(s // f for s, f in zip(prev_shape, factors))
        chunks, shards = layout(new_shape)
        arr = zarr_backend.create_zarr_array(
            f"{output_zarr_url}/{level}",
            shape=new_shape,
            chunks=chunks,
            dtype=prev.dtype,
            zarr_format=zarr_format,
            overwrite=True,
            shards=shards,
        )
        # block-wise: read a factor-aligned window of prev, coarsen, write
        blocks = arr.write_chunks
        n_blocks = [-(-new_shape[i] // blocks[i]) for i in range(len(dims))]
        for bi in itertools.product(*[range(n) for n in n_blocks]):
            out_sl = tuple(
                slice(bi[i] * blocks[i], min((bi[i] + 1) * blocks[i], new_shape[i]))
                for i in range(len(dims))
            )
            in_sl = tuple(
                slice(out_sl[i].start * factors[i], out_sl[i].stop * factors[i])
                for i in range(len(dims))
            )
            block = np.asarray(prev[in_sl])
            if on_card:
                arr[out_sl] = tpyramid.coarsen_mean(
                    torch.from_numpy(block).to(device), factors).cpu().numpy()
            else:
                arr[out_sl] = msi_utils._coarsen_mean(block, factors)
        prev = arr
        prev_shape = new_shape
    return res_abs_factors


def _write_ngff_attrs(output_zarr_url, dims, stack_properties, res_abs_factors, ngff_version,
                      c_coords=None, time_transform=None, channel_windows=None):
    """The multiscales (nested under ``ome`` for NGFF 0.5) and omero
    attributes of the store's group."""
    sdims = [d for d in dims if d in si_utils.SPATIAL_DIMS]
    nsdims = [d for d in dims if d not in si_utils.SPATIAL_DIMS]
    coordtfs, axes = calc_ngff_coordinate_transformations_and_axes(
        {
            "spacing": {d: float(stack_properties["spacing"][d]) for d in sdims},
            "origin": {d: float(stack_properties["origin"][d]) for d in sdims},
            "shape": {d: int(stack_properties["shape"][d]) for d in sdims},
        },
        res_abs_factors,
        nsdims=nsdims,
        time_transform=time_transform,
    )
    multiscales = [
        {
            "axes": axes,
            "datasets": [
                {"path": f"{level}", "coordinateTransformations": coordtfs[level]}
                for level in range(len(res_abs_factors))
            ],
            "version": ngff_version,
        }
    ]
    attrs = {"multiscales": multiscales}
    if ngff_version != "0.4":
        attrs = {"ome": {"version": ngff_version, "multiscales": multiscales}}
    if c_coords is not None:
        c_coords = np.asarray(c_coords)
        windows = channel_windows or [(0, 65535)] * len(c_coords)
        attrs["omero"] = {
            "channels": [
                {
                    "color": "ffffff",
                    "label": f"{ch}",
                    "active": True,
                    "window": {"end": int(hi), "max": int(hi), "min": 0, "start": int(lo)},
                }
                for ch, (lo, hi) in zip(c_coords, windows)
            ]
        }
    zarr_backend.write_group_metadata(
        str(output_zarr_url), attrs, zarr_format=_zarr_format(ngff_version)
    )


def finalize_ome_zarr_levels(
    output_zarr_url: str,
    dims,
    stack_properties: dict,
    ngff_version: str = "0.4",
    c_coords=None,
    downscale_factors_per_spatial_dim: Optional[Dict[str, int]] = None,
    block_size: int = 512,
    time_transform: Optional[dict] = None,
    channel_windows: Optional[List[tuple]] = None,
    device=None,
):
    """Complete an OME-Zarr whose level 0 was written chunk by chunk: build
    each pyramid level block by block from the one before (never a whole
    level in memory; chunks of ``block_size``, unsharded, zarr v2 for NGFF
    0.4 and v3 for 0.5) and write the multiscales and omero metadata.
    ``channel_windows``: per channel, the (start, end) of its omero window
    (by default (0, 65535)). ``device``: a CUDA device averages unsigned
    integer levels on the card (:func:`_build_levels`); by default the
    host does."""
    zarr_format = _zarr_format(ngff_version)
    dims = tuple(dims)
    nsdims = [d for d in dims if d not in si_utils.SPATIAL_DIMS]

    def layout(shape):
        return [1 if d in nsdims else min(block_size, shape[i]) for i, d in enumerate(dims)], None

    res_abs_factors = _build_levels(
        output_zarr_url, dims,
        {d: int(stack_properties["shape"][d]) for d in dims if d in si_utils.SPATIAL_DIMS},
        zarr_format, layout, downscale_factors_per_spatial_dim, device=device,
    )
    _write_ngff_attrs(output_zarr_url, dims, stack_properties, res_abs_factors, ngff_version,
                      c_coords=c_coords, time_transform=time_transform,
                      channel_windows=channel_windows)


def _default_chunks(sim: Sim) -> List[int]:
    spatial_cs = si_utils.get_default_spatial_chunksizes(len(sim.spatial_dims))
    return [1 if d in ("t", "c") else min(spatial_cs[d], sim.sizes[d]) for d in sim.dims]


def _first_transform_key(sim: Sim) -> str:
    keys = list(sim.transforms.keys())
    return keys[0] if keys else si_utils.DEFAULT_TRANSFORM_KEY


def write_sim_to_ome_zarr(
    sim: Sim,
    output_zarr_url: str,
    downscale_factors_per_spatial_dim: Optional[Dict[str, int]] = None,
    overwrite: bool = False,
    ngff_version: str = "0.4",
    chunks: Optional[List[int]] = None,
    shards: Optional[List[int]] = None,
) -> Sim:
    """Write a sim as a multiscale OME-Zarr (NGFF 0.4 in zarr v2, or 0.5 in
    zarr v3) and return it read back lazily, with the sim's transforms.
    Every level holds its data in ``chunks`` (by default 1 on t and c, 256
    (3D) or 2048 (2D) pixels on each spatial dim), cut to the level's shape;
    ``shards`` (NGFF 0.5 only) shards each level, the shard cut to the level
    and rounded up to a multiple of its chunks, as the reference does. Level
    0 is written, and each further level built from the one before block by
    block; the metadata carry the sim's NGFF time calibration and, for a
    ``c`` dim, each channel's value range as its omero window. Without
    ``overwrite``, a level 0 of the same shape already in the store is kept
    (the store is the checkpoint)."""
    zarr_format = _zarr_format(ngff_version)
    if shards is not None and zarr_format == 2:
        raise ValueError("shards requires ngff_version >= 0.5 (zarr v3)")
    if overwrite and os.path.exists(output_zarr_url):
        shutil.rmtree(output_zarr_url)
    data = sim.to_numpy()
    chunks = _default_chunks(sim) if chunks is None else list(chunks)

    def layout(shape):
        level_chunks = [min(int(c), int(s)) for c, s in zip(chunks, shape)]
        level_shards = None
        if shards is not None:
            # clamp to the level shape, then round up to an inner-chunk
            # multiple (sharding_indexed requires exact divisibility)
            level_shards = [
                min(int(sh), -(-int(s) // c) * c)
                for sh, s, c in zip(shards, shape, level_chunks)
            ]
            level_shards = [-(-sh // c) * c for sh, c in zip(level_shards, level_chunks)]
        return level_chunks, level_shards

    level0_url = f"{output_zarr_url}/0"
    try:
        keep = tuple(zarr_backend.open_zarr_array(level0_url, zarr_format).shape) == data.shape
    except FileNotFoundError:
        keep = False
    if not keep:
        level_chunks, level_shards = layout(data.shape)
        arr = zarr_backend.create_zarr_array(
            level0_url,
            shape=data.shape,
            chunks=level_chunks,
            dtype=data.dtype,
            zarr_format=zarr_format,
            overwrite=True,
            shards=level_shards,
        )
        arr[...] = data
    windows = None
    if "c" in sim.dims:
        other_axes = tuple(i for i, d in enumerate(sim.dims) if d != "c")
        windows = list(zip(data.min(axis=other_axes), data.max(axis=other_axes)))
    stack_properties = si_utils.get_stack_properties_from_sim(sim)
    res_abs_factors = _build_levels(
        output_zarr_url, sim.dims, {d: int(stack_properties["shape"][d]) for d in sim.spatial_dims},
        zarr_format, layout, downscale_factors_per_spatial_dim,
    )
    _write_ngff_attrs(
        output_zarr_url, sim.dims, stack_properties, res_abs_factors, ngff_version,
        c_coords=sim.coords.get("c"), time_transform=sim.attrs.get("ngff_time_transform"),
        channel_windows=windows,
    )
    return read_sim_from_ome_zarr(
        output_zarr_url, transform_key=_first_transform_key(sim), prior_sim=sim
    )


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


def update_ome_zarr_multiscales_metadata(zarr_path, msim, transform_key):
    """Rewrite the store's per-level scale and translation from an msim's
    levels, every other attribute kept. With ``transform_key``, the
    translation of that key's affine is added to each level's origin; with
    None, the origins alone are written. Raises when the level counts
    differ."""
    zarr_path = str(zarr_path)
    attrs, zarr_format = zarr_backend.read_group_metadata(zarr_path)
    ms, _ = _parse_multiscales(attrs)
    datasets = ms["datasets"]
    scale_keys = msi_utils.get_sorted_scale_keys(msim)
    if len(datasets) != len(scale_keys):
        raise ValueError(
            f"On-disk OME-Zarr has {len(datasets)} resolution levels, msim has "
            f"{len(scale_keys)}."
        )
    axes = [a["name"] for a in ms["axes"]]
    sdims = [a for a in axes if a in si_utils.SPATIAL_DIMS]
    for ds, skey in zip(datasets, scale_keys):
        sim = msim.get_scale(skey)
        origin = dict(sim.origin)
        if transform_key is not None:
            aff = np.asarray(si_utils.get_affine_from_sim(sim, transform_key).squeeze())
            if aff.ndim == 3:
                aff = aff[0]
            for i, d in enumerate(sdims):
                origin[d] = origin[d] + float(aff[:-1, -1][i])
        for tf in ds.get("coordinateTransformations", []):
            if tf["type"] == "scale":
                tf["scale"] = [
                    float(sim.spacing[a]) if a in sdims else v for a, v in zip(axes, tf["scale"])
                ]
            elif tf["type"] == "translation":
                tf["translation"] = [
                    float(origin[a]) if a in sdims else v
                    for a, v in zip(axes, tf["translation"])
                ]
    zarr_backend.write_group_metadata(zarr_path, attrs, zarr_format)


def _transforms_to_json(transforms: dict) -> dict:
    return {
        key: {
            "data": np.asarray(xaff.data).tolist(),
            "t_coords": None if xaff.t_coords is None else np.asarray(xaff.t_coords).tolist(),
        }
        for key, xaff in transforms.items()
    }


def _transforms_from_json(payload: dict) -> dict:
    return {
        key: XAffine(
            np.asarray(entry["data"], dtype=float),
            t_coords=None if entry.get("t_coords") is None else np.asarray(entry["t_coords"]),
        )
        for key, entry in payload.items()
    }


def update_msim_transforms_zarr(msim_or_transforms, zarr_path):
    """Store an msim's named transforms (or a dict of them) in the store's
    group attributes, under :data:`TRANSFORMS_ATTR_KEY`."""
    transforms = getattr(msim_or_transforms, "transforms", msim_or_transforms)
    attrs, zarr_format = zarr_backend.read_group_metadata(str(zarr_path))
    attrs[TRANSFORMS_ATTR_KEY] = _transforms_to_json(transforms)
    zarr_backend.write_group_metadata(str(zarr_path), attrs, zarr_format=zarr_format)


def read_msim_from_ome_zarr(
    zarr_path, transform_key: str = si_utils.DEFAULT_TRANSFORM_KEY
) -> Msim:
    """Every level of an OME-Zarr as a lazy msim: an identity transform under
    ``transform_key``, and the named transforms stored in the group's
    attributes where there are any."""
    attrs, _ = zarr_backend.read_group_metadata(str(zarr_path))
    ms, _ = _parse_multiscales(attrs)
    msim = Msim(sims=[
        read_sim_from_ome_zarr(zarr_path, resolution_level=level, transform_key=transform_key)
        for level in range(len(ms["datasets"]))
    ])
    if TRANSFORMS_ATTR_KEY in attrs:
        msim.transforms.update(_transforms_from_json(attrs[TRANSFORMS_ATTR_KEY]))
    return msim


def write_msim_to_ome_zarr(msim: Msim, output_zarr_url: str, **kwargs) -> Msim:
    """Write an msim's level 0 with :func:`write_sim_to_ome_zarr` (the
    pyramid is built anew), store its named transforms, and return the store
    read back lazily."""
    write_sim_to_ome_zarr(msi_utils.get_sim_from_msim(msim, scale="scale0"), output_zarr_url,
                          **kwargs)
    update_msim_transforms_zarr(msim, output_zarr_url)
    return read_msim_from_ome_zarr(output_zarr_url)


def get_ngff_time_transform(image) -> dict:
    """The NGFF time calibration (scale, translation, unit) of a sim or msim;
    the identity where none is stored."""
    sims = image.sims if msi_utils.is_msim(image) else [image]
    stored = sims[0].attrs.get("ngff_time_transform") if sims else None
    return {**DEFAULT_NGFF_TIME_TRANSFORM, **(stored or {})}


def set_ngff_time_transform(image, time_transform):
    """Attach an NGFF time calibration to a sim or to every level of an
    msim. The identity is stored as the absence of the attribute, so that
    an image never calibrated stays as it was."""
    time_transform = {**DEFAULT_NGFF_TIME_TRANSFORM, **(time_transform or {})}
    sims = image.sims if msi_utils.is_msim(image) else [image]
    for s in sims:
        if time_transform == DEFAULT_NGFF_TIME_TRANSFORM:
            s.attrs.pop("ngff_time_transform", None)
        else:
            s.attrs["ngff_time_transform"] = dict(time_transform)
    return image


def copy_ngff_time_transform(source, target):
    """Give ``target`` the time calibration of ``source``."""
    return set_ngff_time_transform(target, get_ngff_time_transform(source))


def mean_dtype(arr, **kwargs):
    """``np.mean`` cast back to the input's dtype (for coarsening integer
    levels)."""
    return np.mean(arr, **kwargs).astype(arr.dtype)


@dataclass
class NgffImage:
    """An NGFF 0.4 image in memory (the field names of ngff-zarr's
    ``NgffImage``)."""

    data: object
    dims: list
    scale: dict
    translation: dict
    name: str = "image"


@dataclass
class NgffMultiscales:
    """A pyramid of :class:`NgffImage` and its NGFF multiscales metadata (the
    field names of ngff-zarr's ``Multiscales``)."""

    images: list
    metadata: dict = field(default_factory=dict)
    scale_factors: list = field(default_factory=list)


def sim_to_ngff_image(sim: Sim, transform_key: Optional[str]) -> NgffImage:
    """A sim as an NGFF image; the translation of ``transform_key``'s affine
    (its first timepoint) is added to the origin."""
    sdims = si_utils.get_spatial_dims_from_sim(sim)
    origin = dict(si_utils.get_origin_from_sim(sim))
    if transform_key is not None:
        mat = np.asarray(si_utils.get_affine_from_sim(sim, transform_key).squeeze())
        if mat.ndim == 3:
            mat = mat[0]
        shift = param_utils.translation_from_affine(mat)
        for i, d in enumerate(sdims):
            origin[d] = float(origin[d] + shift[i])
    return NgffImage(
        data=sim.data,
        dims=list(sim.dims),
        scale={d: float(v) for d, v in si_utils.get_spacing_from_sim(sim).items()},
        translation=origin,
    )


def msim_to_ngff_multiscales(msim, transform_key: Optional[str]) -> NgffMultiscales:
    """An msim as NGFF multiscales, a dataset a level at ``scale{i}/image``."""
    ngff_ims = [
        sim_to_ngff_image(msi_utils.get_sim_from_msim(msim, scale=sk), transform_key)
        for sk in msi_utils.get_sorted_scale_keys(msim)
    ]
    sim0 = msi_utils.get_sim_from_msim(msim)
    sdims = si_utils.get_spatial_dims_from_sim(sim0)
    nsdims = [d for d in sim0.dims if d not in sdims]
    abs_factors = [{d: im.scale[d] / ngff_ims[0].scale[d] for d in sdims} for im in ngff_ims]
    coordtfs, axes = calc_ngff_coordinate_transformations_and_axes(
        {
            "spacing": ngff_ims[0].scale,
            "origin": ngff_ims[0].translation,
            "shape": {
                d: int(np.shape(ngff_ims[0].data)[ngff_ims[0].dims.index(d)]) for d in sdims
            },
        },
        abs_factors,
        nsdims=nsdims,
        time_transform=sim0.attrs.get("ngff_time_transform"),
    )
    metadata = {
        "axes": axes,
        "datasets": [
            {"path": f"scale{i}/image", "coordinateTransformations": coordtfs[i]}
            for i in range(len(ngff_ims))
        ],
        "version": "0.4",
    }
    return NgffMultiscales(
        images=ngff_ims,
        metadata=metadata,
        scale_factors=[{d: int(round(f[d])) for d in sdims} for f in abs_factors[1:]],
    )


def ngff_image_to_sim(ngff_im, transform_key: str, data=None) -> Sim:
    """An NGFF image (any object with data, dims, scale and translation) as a
    sim with an identity affine under ``transform_key``; ``data`` replaces
    the image's array."""
    sdims = [d for d in ngff_im.dims if d in si_utils.SPATIAL_DIMS]
    return si_utils.get_sim_from_array(
        ngff_im.data if data is None else data,
        dims=list(ngff_im.dims),
        scale={d: float(ngff_im.scale[d]) for d in sdims},
        translation={d: float(ngff_im.translation[d]) for d in sdims},
        transform_key=transform_key,
    )


def ngff_multiscales_to_msim(ngff_multiscales, transform_key: str, data_arrays=None) -> Msim:
    """NGFF multiscales as an msim; ``data_arrays`` replace the levels'
    arrays."""
    if data_arrays is None:
        data_arrays = [None] * len(ngff_multiscales.images)
    return Msim(sims=[
        ngff_image_to_sim(im, transform_key=transform_key, data=da)
        for im, da in zip(ngff_multiscales.images, data_arrays)
    ])


def read_ngff_multiscales(zarr_path) -> NgffMultiscales:
    """An OME-Zarr's multiscales as NGFF multiscales over lazy zarr arrays."""
    attrs, _ = zarr_backend.read_group_metadata(str(zarr_path))
    ms, _ = _parse_multiscales(attrs)
    images = [
        sim_to_ngff_image(read_sim_from_ome_zarr(zarr_path, resolution_level=level), None)
        for level in range(len(ms["datasets"]))
    ]
    return NgffMultiscales(images=images, metadata=ms)


def write_multiscales_metadata(path, axes, datasets, ngff_version: str = "0.4"):
    """Write only the NGFF multiscales metadata of a store whose arrays are
    written apart (block by block, possibly by several workers): at the top
    level of a v2 group (0.4), or nested under ``ome`` in a v3 group
    (0.5)."""
    multiscale = {"axes": list(axes), "datasets": list(datasets)}
    if _zarr_format(ngff_version) == 2:
        attrs = {"multiscales": [dict(multiscale, version="0.4")]}
    else:
        attrs = {"ome": {"version": "0.5", "multiscales": [multiscale]}}
    zarr_backend.write_group_metadata(
        str(path), attrs, zarr_format=_zarr_format(ngff_version)
    )


def serve_virtual_ome_zarrs(*args, **kwargs):
    """:func:`.virtual_ngff.serve_virtual_ome_zarrs`, reached from here as in
    the reference."""
    from multiview_stitcher_torch.io import virtual_ngff

    return virtual_ngff.serve_virtual_ome_zarrs(*args, **kwargs)


# the virtual store classes, reached from here as in the reference; looked up
# at first use, since virtual_ngff imports this module
_VIRTUAL_REEXPORTS = {
    "VirtualOMEZarr": "VirtualOMEZarr",
    "VirtualOMEZarrPlate": "VirtualOMEZarrPlate",
    "VirtualOMEZarrHCSPlate": "VirtualOMEZarrPlate",
    "VirtualOMEZarrServer": "VirtualOMEZarrServer",
}


def __getattr__(name):
    if name in _VIRTUAL_REEXPORTS:
        from multiview_stitcher_torch.io import virtual_ngff

        return getattr(virtual_ngff, _VIRTUAL_REEXPORTS[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
