"""Spatial image data model (copy of ``multiview_stitcher_tpu.si_utils``).

A "sim" is a :class:`Sim` carrying:

- ``data``: a numpy array;
- ``dims``: tuple of dim names, ordered subset of ('t','c','z','y','x');
- ``spacing``/``origin``: physical pixel spacing and origin per spatial dim
  (pixel-center convention: coord = origin + spacing * index);
- ``transforms``: dict transform_key -> :class:`~.param_utils.XAffine`
  mapping intrinsic physical coords into named world coordinate systems;
- ``coords``: explicit coordinates for non-spatial dims (t, c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from multiview_stitcher_torch import param_utils
from multiview_stitcher_torch.param_utils import XAffine

DEFAULT_TRANSFORM_KEY = "affine_metadata"
SPATIAL_DIMS = ["z", "y", "x"]
ALL_DIMS = ["t", "c", "z", "y", "x"]

DEFAULT_SPATIAL_CHUNKSIZES_3D = {dim: 256 for dim in ["z", "y", "x"]}
DEFAULT_SPATIAL_CHUNKSIZES_2D = {dim: 2048 for dim in ["y", "x"]}


@dataclass
class Sim:
    """Spatial image: array + physical metadata + named affine transforms."""

    data: Any
    dims: tuple
    spacing: Dict[str, float] = field(default_factory=dict)
    origin: Dict[str, float] = field(default_factory=dict)
    coords: Dict[str, np.ndarray] = field(default_factory=dict)
    transforms: Dict[str, XAffine] = field(default_factory=dict)
    name: Optional[str] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.dims = tuple(self.dims)
        if len(self.dims) != len(self.data.shape):
            raise ValueError(f"dims {self.dims} vs data shape {self.data.shape}")
        sdims = [d for d in self.dims if d in SPATIAL_DIMS]
        for d in sdims:
            self.spacing.setdefault(d, 1.0)
            self.origin.setdefault(d, 0.0)
        self.spacing = {d: float(self.spacing[d]) for d in sdims}
        self.origin = {d: float(self.origin[d]) for d in sdims}
        for d in self.dims:
            if d not in SPATIAL_DIMS and d not in self.coords:
                self.coords[d] = np.arange(self.data.shape[self.dims.index(d)])

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> Dict[str, int]:
        return {d: s for d, s in zip(self.dims, self.shape)}

    @property
    def spatial_dims(self) -> list:
        return [d for d in self.dims if d in SPATIAL_DIMS]

    @property
    def nsdims(self) -> list:
        return [d for d in self.dims if d not in SPATIAL_DIMS]

    def isel(self, indexers: Dict[str, Any]) -> "Sim":
        """Integer-index along named dims (scalars drop the dim)."""
        slicer = []
        new_dims = []
        for d in self.dims:
            idx = indexers.get(d, slice(None))
            if np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0):
                slicer.append(int(idx))
                continue
            slicer.append(idx)
            new_dims.append(d)
        out = Sim(
            data=self.data[tuple(slicer)],
            dims=tuple(new_dims),
            spacing={d: v for d, v in self.spacing.items() if d in new_dims},
            origin={d: v for d, v in self.origin.items() if d in new_dims},
            name=self.name,
            attrs=dict(self.attrs),
        )
        # spatial slices shift the origin and scale the spacing
        for d in out.spatial_dims:
            if isinstance(indexers.get(d), slice):
                out.origin[d] = self.origin[d] + (indexers[d].start or 0) * self.spacing[d]
                out.spacing[d] = self.spacing[d] * (indexers[d].step or 1)
        for d in self.coords:
            if d in new_dims:
                out.coords[d] = np.atleast_1d(
                    np.asarray(self.coords[d])[indexers.get(d, slice(None))]
                ).copy()
        # transforms: select t if t was indexed
        for key, xaff in self.transforms.items():
            idx = indexers.get("t")
            if idx is not None and xaff.has_t:
                if np.isscalar(idx):
                    out.transforms[key] = XAffine(xaff.data[int(idx)])
                else:
                    out.transforms[key] = XAffine(
                        xaff.data[idx], t_coords=xaff.t_coords[idx]
                    )
            else:
                out.transforms[key] = xaff.copy()
        return out


def to_spatial_image(data, dims=None, scale=None, translation=None,
                     c_coords=None, t_coords=None, name=None) -> Sim:
    if scale is None or translation is None:
        raise ValueError("scale and translation must be provided")
    if dims is None:
        dims = SPATIAL_DIMS[-len(data.shape):]
    dims = tuple(dims)
    coords = {}
    if "c" in dims and c_coords is not None:
        coords["c"] = np.asarray(c_coords)
    if "t" in dims and t_coords is not None:
        coords["t"] = np.asarray(t_coords)
    sdims = [d for d in dims if d in SPATIAL_DIMS]
    return Sim(
        data=data,
        dims=dims,
        spacing={d: scale[d] for d in sdims},
        origin={d: translation[d] for d in sdims},
        coords=coords,
        name=name,
    )


def get_sim_from_array(
    array,
    dims=None,
    scale: Optional[dict] = None,
    translation: Optional[dict] = None,
    affine=None,
    transform_key: str = DEFAULT_TRANSFORM_KEY,
    c_coords=None,
    t_coords=None,
) -> Sim:
    """Construct a sim from a numpy array."""
    if dims is None:
        dims = ALL_DIMS[-len(array.shape):]
    sdims = [d for d in dims if d in SPATIAL_DIMS]
    sim = to_spatial_image(
        array,
        dims=dims,
        scale=scale or {d: 1.0 for d in sdims},
        translation=translation or {d: 0.0 for d in sdims},
        c_coords=c_coords,
        t_coords=t_coords,
    )
    if affine is None:
        affine = param_utils.affine_to_xaffine(
            np.eye(len(sdims) + 1),
            t_coords=sim.coords["t"] if "t" in sim.dims else None,
        )
    set_sim_affine(sim, affine, transform_key=transform_key)
    return sim


def get_spatial_dims_from_sim(sim: Sim):
    return sim.spatial_dims


def get_nonspatial_dims_from_sim(sim: Sim):
    return sim.nsdims


def get_spacing_from_sim(sim: Sim, asarray: bool = False):
    if asarray:
        return np.array([sim.spacing[d] for d in sim.spatial_dims])
    return dict(sim.spacing)


def get_origin_from_sim(sim: Sim, asarray: bool = False):
    if asarray:
        return np.array([sim.origin[d] for d in sim.spatial_dims])
    return dict(sim.origin)


def get_shape_from_sim(sim: Sim, asarray: bool = False):
    sizes = sim.sizes
    if asarray:
        return np.array([sizes[d] for d in sim.spatial_dims])
    return {d: sizes[d] for d in sim.spatial_dims}


def get_stack_properties_from_sim(sim: Sim, transform_key=None, asarray: bool = False):
    """Stack properties: shape/spacing/origin (+ transform if key given)."""
    props = {
        "shape": get_shape_from_sim(sim, asarray=asarray),
        "spacing": get_spacing_from_sim(sim, asarray=asarray),
        "origin": get_origin_from_sim(sim, asarray=asarray),
    }
    if transform_key is not None:
        props["transform"] = get_affine_from_sim(sim, transform_key)
    return props


def get_affine_from_sim(sim: Sim, transform_key: str) -> XAffine:
    if transform_key not in sim.transforms:
        raise KeyError(f"Transform key {transform_key} not found in sim")
    return sim.transforms[transform_key]


def set_sim_affine(sim: Sim, xaffine, transform_key: str = DEFAULT_TRANSFORM_KEY):
    """Attach an affine under ``transform_key``."""
    sim.transforms[transform_key] = param_utils.to_xaffine(xaffine)
    return sim


def sim_sel_coords(sim: Sim, sel_dict: Dict[str, Any]) -> Sim:
    """Select by coordinate value.

    Non-spatial dims select by exact coord value; spatial dims accept
    world-coordinate slices (inclusive bounds, like xarray label slicing).
    """
    indexers = {}
    for dim, value in sel_dict.items():
        if dim in sim.spatial_dims and isinstance(value, slice):
            o, sp = sim.origin[dim], sim.spacing[dim]
            lo = value.start if value.start is not None else -np.inf
            hi = value.stop if value.stop is not None else np.inf
            i0 = max(0, int(np.ceil((lo - o) / sp - 1e-9)))
            i1 = min(sim.sizes[dim] - 1, int(np.floor((hi - o) / sp + 1e-9)))
            indexers[dim] = slice(i0, i1 + 1)
            continue
        coords = np.asarray(sim.coords.get(dim, np.arange(sim.sizes[dim])))
        if np.isscalar(value) or np.asarray(value).ndim == 0:
            matches = np.where(coords == value)[0]
            if not len(matches):
                raise KeyError(f"coord {value!r} not found along {dim!r}")
            indexers[dim] = int(matches[0])
        else:
            indexers[dim] = np.array(
                [int(np.where(coords == v)[0][0]) for v in np.asarray(value)]
            )
    return sim.isel(indexers)


def get_default_spatial_chunksizes(ndim: int):
    if ndim not in (2, 3):
        raise ValueError(f"only 2D and 3D sims are supported, got {ndim}D")
    return dict(
        DEFAULT_SPATIAL_CHUNKSIZES_2D if ndim == 2 else DEFAULT_SPATIAL_CHUNKSIZES_3D
    )
