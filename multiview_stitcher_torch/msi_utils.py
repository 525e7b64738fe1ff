"""Multiscale images ("msims"): pyramids of a view's levels, the named
transforms they share, and the choice of a level for registration and
fusion.

The port's copy of ``multiview_stitcher_tpu.msi_utils``. An :class:`Msim`
holds an ordered list of :class:`~.si_utils.Sim` levels, finest first, and
one transform dict that every level shares. ``get_msim_from_sim`` builds the
default pyramid: 2x block means per dim (boundary trim, truncating cast back
to the input dtype) until a dim would fall below 100 pixels, each level's
origin moved to the centre of its first block. Level choice compares spacing
ratios with a relative tolerance of 1e-6, which spacings read back through
OME-Zarr's JSON keep.
"""

from __future__ import annotations

import copy as _copy
import functools
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from multiview_stitcher_torch import param_utils, si_utils
from multiview_stitcher_torch.param_utils import XAffine
from multiview_stitcher_torch.si_utils import Sim


@dataclass
class Msim:
    """Multiscale image: ``sims[0]`` is level "scale0", the finest;
    ``transforms`` are shared by all levels."""

    sims: List[Sim]
    transforms: Dict[str, XAffine] = field(default_factory=dict)
    attrs: Dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.transforms and self.sims and self.sims[0].transforms:
            self.transforms = {k: v.copy() for k, v in self.sims[0].transforms.items()}

    @property
    def scale_keys(self) -> List[str]:
        return [f"scale{i}" for i in range(len(self.sims))]

    def scale_index(self, scale: str) -> int:
        return int(scale.replace("scale", ""))

    def get_scale(self, scale="scale0") -> Sim:
        """The level as a sim over the same data, carrying the transforms."""
        idx = self.scale_index(scale) if isinstance(scale, str) else int(scale)
        sim = self.sims[idx].copy()
        sim.transforms = {k: v.copy() for k, v in self.transforms.items()}
        return sim


def is_msim(image) -> bool:
    return isinstance(image, Msim)


def _coarsen_mean(data: np.ndarray, factors: Sequence[int]) -> np.ndarray:
    """Block-mean downsample with boundary='trim', cast back to the input
    dtype (truncating for integers)."""
    data = np.asarray(data)
    trimmed = tuple(slice(0, (s // f) * f) for s, f in zip(data.shape, factors))
    data = data[trimmed]
    new_shape = []
    mean_axes = []
    for i, (s, f) in enumerate(zip(data.shape, factors)):
        new_shape.extend([s // f, f])
        mean_axes.append(2 * i + 1)
    out = data.reshape(new_shape).mean(axis=tuple(mean_axes))
    return out.astype(data.dtype)


def _downsample_sim(sim: Sim, scale_factor) -> Sim:
    """The next level of ``sim``: block means over ``scale_factor`` (an int
    for every spatial dim, or a dict per dim), spacing times the factor,
    origin moved by ``(factor - 1) * spacing / 2``."""
    sdims = sim.spatial_dims
    if not isinstance(scale_factor, dict):
        scale_factor = {d: int(scale_factor) for d in sdims}
    scale_factor = {d: int(scale_factor.get(d, 1)) for d in sdims}
    data = _coarsen_mean(sim.to_numpy(), [scale_factor.get(d, 1) for d in sim.dims])
    spacing = si_utils.get_spacing_from_sim(sim)
    origin = si_utils.get_origin_from_sim(sim)
    out = si_utils.to_spatial_image(
        data,
        dims=sim.dims,
        scale={d: spacing[d] * scale_factor[d] for d in sdims},
        translation={d: origin[d] + (scale_factor[d] - 1) * spacing[d] / 2 for d in sdims},
        t_coords=sim.coords.get("t"),
        c_coords=sim.coords.get("c"),
    )
    out.transforms = {k: v.copy() for k, v in sim.transforms.items()}
    out.attrs.update(_copy.deepcopy(sim.attrs))
    return out


def calc_resolution_levels(
    spatial_shape: Dict[str, int],
    downscale_factors_per_spatial_dim: Optional[Dict[str, int]] = None,
    min_shape: int = 100,
):
    """Pyramid plan: 2x per dim until a dim would fall below ``min_shape``.

    Returns (shapes, relative factors, absolute factors), including level 0.
    """
    sdims = list(spatial_shape.keys())
    if downscale_factors_per_spatial_dim is None:
        downscale_factors_per_spatial_dim = {d: 2 for d in sdims}

    res_shapes = [dict(spatial_shape)]
    res_rel_factors = [{d: 1 for d in sdims}]
    res_abs_factors = [{d: 1 for d in sdims}]
    while True:
        new_rel = {
            d: downscale_factors_per_spatial_dim[d]
            if res_shapes[-1][d] // downscale_factors_per_spatial_dim[d] > min_shape
            else 1
            for d in sdims
        }
        if not any(new_rel[d] > 1 for d in sdims):
            break
        res_shapes.append({d: res_shapes[-1][d] // new_rel[d] for d in sdims})
        res_rel_factors.append(new_rel)
        res_abs_factors.append({d: res_abs_factors[-1][d] * new_rel[d] for d in sdims})
    return res_shapes, res_rel_factors, res_abs_factors


def get_msim_from_sim(sim: Sim, scale_factors=None) -> Msim:
    """A pyramid over ``sim``: level 0 is ``sim`` itself, each further level
    the block means of the one before by its entry of ``scale_factors`` (by
    default :func:`calc_resolution_levels`'s plan; ``[]`` gives one level)."""
    if scale_factors is None:
        scale_factors = calc_resolution_levels(si_utils.get_shape_from_sim(sim))[1][1:]
    sims = [sim.copy()]
    for factor in scale_factors:
        sims.append(_downsample_sim(sims[-1], factor))
    return Msim(sims=sims)


def get_msim_from_sims(sims: Sequence[Sim]) -> Msim:
    """An msim of levels computed elsewhere, sorted finest first."""
    sims = list(sims)
    if not sims:
        raise ValueError("sims must contain at least one image.")
    dims = sims[0].dims
    for s in sims[1:]:
        if s.dims != dims:
            raise ValueError("All sims must have the same dimensions.")
    sdims = sims[0].spatial_dims

    def shape_key(s):
        shape = si_utils.get_shape_from_sim(s)
        return tuple(shape[d] for d in sdims)

    return Msim(sims=sorted(sims, key=shape_key, reverse=True))


def get_sim_from_msim(msim, scale="scale0") -> Sim:
    if isinstance(msim, Sim):
        return msim
    return msim.get_scale(scale)


def get_sorted_scale_keys(msim: Msim) -> List[str]:
    return msim.scale_keys


def get_ndim(msim: Msim) -> int:
    return len(msim.sims[0].spatial_dims)


def get_dims(msim: Msim):
    return list(msim.sims[0].dims)


def get_spatial_dims(msim: Msim):
    return msim.sims[0].spatial_dims


def get_transform_from_msim(msim: Msim, transform_key: str) -> XAffine:
    return msim.transforms[transform_key]


def get_transforms_from_dataset_as_dict(dataset):
    """A copy of the named transforms of an msim, a sim or a transform dict
    (the reference reads them off a scale's xarray Dataset)."""
    transforms = dataset.transforms if isinstance(dataset, Msim) else getattr(
        dataset, "transforms", dataset
    )
    if not isinstance(transforms, dict):
        raise TypeError(
            f"expected an Msim, Sim, or transform dict, got {type(dataset).__name__}"
        )
    return {k: v.copy() for k, v in transforms.items()}


def set_affine_transform(msim: Msim, xaffine=None, transform_key=None, base_transform_key=None):
    """Attach ``xaffine`` (composed with ``base_transform_key``'s) under
    ``transform_key``."""
    assert transform_key is not None
    if xaffine is None:
        xaffine = param_utils.identity_transform(get_ndim(msim))
    xaffine = param_utils.to_xaffine(xaffine)
    if base_transform_key is not None:
        xaffine = param_utils.rebase_affine(xaffine, msim.transforms[base_transform_key])
    msim.transforms[transform_key] = xaffine
    return msim


def multiscale_sel_coords(msim: Msim, sel_dict) -> Msim:
    """Select non-spatial coordinates on every level; a time-varying
    transform is narrowed to the selected timepoints."""
    out = Msim(
        sims=[si_utils.sim_sel_coords(s, sel_dict) for s in msim.sims],
        transforms={},
        attrs=dict(msim.attrs),
    )
    for key, xaff in msim.transforms.items():
        if "t" in sel_dict and xaff.has_t:
            tval = sel_dict["t"]
            if np.isscalar(tval):
                out.transforms[key] = xaff.sel_t(tval)
            else:
                idxs = [int(np.where(xaff.t_coords == t)[0][0]) for t in tval]
                out.transforms[key] = XAffine(xaff.data[idxs], t_coords=np.asarray(tval))
        else:
            out.transforms[key] = xaff.copy()
    return out


def correct_multiscale_origins(msim: Msim) -> Msim:
    """Level origins on the pixel-centre convention: readers that give every
    level level 0's origin (Imaris, for one) get each level's origin moved
    by ``(factor - 1) * spacing0 / 2``, so that its pixel centres are the
    centres of the level-0 blocks they average. In place."""
    sim0 = msim.sims[0]
    spacing0 = si_utils.get_spacing_from_sim(sim0)
    origin0 = si_utils.get_origin_from_sim(sim0)
    for sim in msim.sims[1:]:
        spacing = si_utils.get_spacing_from_sim(sim)
        for d in sim0.spatial_dims:
            factor = spacing[d] / spacing0[d]
            sim.origin[d] = origin0[d] + (factor - 1) * spacing0[d] / 2
    return msim


def concat(msims: Sequence[Msim], dim: str) -> Msim:
    """Concatenate msims along a non-spatial dim, level by level (as many
    levels as the shallowest has)."""
    n_scales = min(len(m.sims) for m in msims)
    return Msim(sims=[si_utils.concat([m.sims[i] for m in msims], dim) for i in range(n_scales)])


def stack(msims: Sequence[Msim], dim: str = "t", coords=None) -> Msim:
    """Stack msims along a new dim, level by level; lazy levels stay lazy."""
    n_scales = min(len(m.sims) for m in msims)
    return Msim(sims=[
        si_utils.stack([m.sims[i] for m in msims], dim, coords=coords) for i in range(n_scales)
    ])


def ensure_dim(msim: Msim, dim: str) -> Msim:
    """The msim with ``dim`` on every level (of length 1 when it had none);
    for ``t``, its transforms gain that timepoint."""
    if dim in get_dims(msim):
        return msim
    sims = [si_utils.ensure_dim(s, dim) for s in msim.sims]
    transforms = {k: v.copy() for k, v in msim.transforms.items()}
    if dim == "t":
        transforms = {
            k: v if v.has_t else XAffine(v.data[None], t_coords=sims[0].coords["t"])
            for k, v in transforms.items()
        }
    return Msim(sims=sims, transforms=transforms, attrs=dict(msim.attrs))


def get_store_decorator(store_path, store_overwrite: bool = False):
    """Decorator factory that caches an msim-producing function on disk: the
    function runs only when ``store_path`` is missing (or with
    ``store_overwrite``), its msim is written there as OME-Zarr, and every
    call returns the store read back lazily. ``store_path=None`` leaves the
    function as it is."""
    if store_path is None:
        return lambda func: func
    store_path = Path(store_path)

    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            from multiview_stitcher_torch.io import ngff_utils

            if not store_path.exists() or store_overwrite:
                ngff_utils.write_msim_to_ome_zarr(
                    func(*args, **kwargs), str(store_path), overwrite=True
                )
            return ngff_utils.read_msim_from_ome_zarr(str(store_path))

        return wrapper

    return deco


def get_first_scale_above_target_spacing(msim: Msim, target_spacing: float, dim: str = "y") -> str:
    """The first level, finest first, whose spacing along ``dim`` exceeds
    ``target_spacing``; the coarsest when none does."""
    scale = "scale0"
    for scale in get_sorted_scale_keys(msim):
        if si_utils.get_spacing_from_sim(msim.get_scale(scale))[dim] > target_spacing:
            break
    return scale


def sim_map_blocks(sim: Sim, func, *args, dtype=None, **kwargs) -> Sim:
    """``func`` (shape-preserving) applied to the image data, coordinates and
    transforms kept: lazily, window by window as it is read
    (``zarr_utils.VirtualMap``), for lazy data; at once for numpy data."""
    from multiview_stitcher_torch import zarr_utils

    if si_utils._is_lazy(sim.data):
        data = zarr_utils.map_blocks(sim.data, func, *args, dtype=dtype, **kwargs)
    else:
        data = func(sim.data, *args, **kwargs)
        if dtype is not None:
            data = np.asarray(data).astype(dtype)
        if tuple(np.shape(data)) != tuple(sim.shape):
            raise ValueError(
                "sim_map_blocks requires a shape-preserving func; got "
                f"{np.shape(data)} from {tuple(sim.shape)}"
            )
    return sim.copy(data=data)


def msim_map_blocks(msim: Msim, func, *args, dtype=None, **kwargs) -> Msim:
    """:func:`sim_map_blocks` on every level; transforms kept."""
    return Msim(
        sims=[sim_map_blocks(sim, func, *args, dtype=dtype, **kwargs) for sim in msim.sims],
        transforms={k: v.copy() for k, v in msim.transforms.items()},
        attrs=dict(msim.attrs),
    )


def set_point_set(msim: Msim, points, points_key: str = "beads"):
    """Attach a named point set ((N, ndim) intrinsic physical coordinates)
    to the msim and to each of its levels."""
    msim.attrs.setdefault("point_sets", {})[points_key] = np.asarray(points, dtype=float)
    for sim in msim.sims:
        si_utils.set_point_set(sim, points, points_key=points_key)
    return msim


def get_point_set(msim: Msim, points_key: str = "beads"):
    return msim.attrs["point_sets"][points_key]


def get_res_level_from_spacing(msim: Msim, output_spacing: Dict[str, float]) -> str:
    """The coarsest level whose spacing is at most ``output_spacing`` in
    every dim (relative tolerance 1e-6)."""
    chosen = "scale0"
    for sk in get_sorted_scale_keys(msim):
        spacing = si_utils.get_spacing_from_sim(msim.get_scale(sk))
        if all(spacing[d] <= output_spacing[d] * (1 + 1e-6) for d in spacing):
            chosen = sk
        else:
            break
    return chosen


def get_res_level_from_binning_factors(msim: Msim, binning_factors: Dict[str, int]) -> str:
    """The coarsest level whose spacing over level 0's is at most the
    requested binning in every dim (relative tolerance 1e-6)."""
    base_spacing = si_utils.get_spacing_from_sim(msim.get_scale("scale0"))
    chosen = "scale0"
    for sk in get_sorted_scale_keys(msim):
        spacing = si_utils.get_spacing_from_sim(msim.get_scale(sk))
        if all(
            spacing[d] / base_spacing[d] <= binning_factors.get(d, 1) * (1 + 1e-6)
            for d in spacing
        ):
            chosen = sk
        else:
            break
    return chosen


def multiscale_spatial_image_from_zarr(path, **kwargs) -> Msim:
    """Alias of ``io.ngff_utils.read_msim_from_ome_zarr``."""
    from multiview_stitcher_torch.io import ngff_utils

    return ngff_utils.read_msim_from_ome_zarr(path, **kwargs)


def multiscale_spatial_image_to_zarr(msim: Msim, path, **kwargs):
    """Alias of ``io.ngff_utils.write_msim_to_ome_zarr``."""
    from multiview_stitcher_torch.io import ngff_utils

    return ngff_utils.write_msim_to_ome_zarr(msim, str(path), **kwargs)


def update_msim_transforms_zarr(msim_or_transforms, zarr_path):
    """Alias of ``io.ngff_utils.update_msim_transforms_zarr``."""
    from multiview_stitcher_torch.io import ngff_utils

    return ngff_utils.update_msim_transforms_zarr(msim_or_transforms, zarr_path)
