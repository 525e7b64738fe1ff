"""Spatial image data model (copy of ``multiview_stitcher_tpu.si_utils``).

A "sim" is a :class:`Sim` carrying:

- ``data``: a numpy array, or a lazy array handle exposing ``shape``,
  ``dtype``, ``__getitem__`` and ``__array__`` (a zarr-backed
  ``io.zarr_backend.LazyZarrArray``); slicing a sim keeps a lazy handle lazy;
  ``fuse(..., output_on_backend=True)`` returns a sim over a torch tensor on
  the device;
- ``dims``: tuple of dim names, ordered subset of ('t','c','z','y','x');
- ``spacing``/``origin``: physical pixel spacing and origin per spatial dim
  (pixel-center convention: coord = origin + spacing * index);
- ``transforms``: dict transform_key -> :class:`~.param_utils.XAffine`
  mapping intrinsic physical coords into named world coordinate systems;
- ``coords``: explicit coordinates for non-spatial dims (t, c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from multiview_stitcher_torch import param_utils
from multiview_stitcher_torch.param_utils import XAffine

DEFAULT_TRANSFORM_KEY = "affine_metadata"
SPATIAL_DIMS = ["z", "y", "x"]
ALL_DIMS = ["t", "c", "z", "y", "x"]

DEFAULT_SPATIAL_CHUNKSIZES_3D = {dim: 256 for dim in ["z", "y", "x"]}
DEFAULT_SPATIAL_CHUNKSIZES_2D = {dim: 2048 for dim in ["y", "x"]}


def _is_lazy(data) -> bool:
    """True for array handles that are read only when materialized."""
    return not isinstance(data, np.ndarray)


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

    def to_numpy(self) -> np.ndarray:
        """The data as a numpy array (reads a lazy handle, downloads a
        device tensor)."""
        if isinstance(self.data, torch.Tensor):
            return self.data.cpu().numpy()
        return np.asarray(self.data)

    def copy(self, data=None) -> "Sim":
        """A sim over the same data (or ``data``) with copied metadata."""
        return Sim(
            data=self.data if data is None else data,
            dims=self.dims,
            spacing=dict(self.spacing),
            origin=dict(self.origin),
            coords={k: np.asarray(v).copy() for k, v in self.coords.items()},
            transforms={k: v.copy() for k, v in self.transforms.items()},
            name=self.name,
            attrs=dict(self.attrs),
        )

    @property
    def sizes(self) -> Dict[str, int]:
        return {d: s for d, s in zip(self.dims, self.shape)}

    @property
    def spatial_dims(self) -> list:
        return [d for d in self.dims if d in SPATIAL_DIMS]

    @property
    def nsdims(self) -> list:
        return [d for d in self.dims if d not in SPATIAL_DIMS]

    def dim_index(self, dim: str) -> int:
        return self.dims.index(dim)

    def expand_dims(self, dim: str, coords=None) -> "Sim":
        """The sim with a new non-spatial dim of length 1 at its place in
        ('t', 'c', 'z', 'y', 'x'); lazy data stays lazy
        (``zarr_utils.expand_dims``)."""
        assert dim not in self.dims
        order = [d for d in ALL_DIMS if d == dim or d in self.dims]
        axis = order.index(dim)
        if _is_lazy(self.data):
            from multiview_stitcher_torch import zarr_utils

            data = zarr_utils.expand_dims(self.data, axis=axis)
        else:
            data = np.expand_dims(self.data, axis=axis)
        new_coords = {k: np.asarray(v).copy() for k, v in self.coords.items()}
        new_coords[dim] = np.asarray(coords) if coords is not None else np.arange(1)
        return Sim(
            data=data,
            dims=tuple(order),
            spacing=dict(self.spacing),
            origin=dict(self.origin),
            coords=new_coords,
            transforms={k: v.copy() for k, v in self.transforms.items()},
            name=self.name,
            attrs=dict(self.attrs),
        )

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
    """Construct a sim from a numpy array or a lazy array handle, which the
    sim holds without reading it."""
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


def get_ndim_from_sim(sim: Sim) -> int:
    return len(sim.spatial_dims)


def get_dims_from_sim(sim: Sim):
    return list(sim.dims)


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


def get_extent_from_sim(sim: Sim):
    """Physical extent per spatial dim, between the first and last pixel
    centres."""
    sp = get_stack_properties_from_sim(sim)
    return {d: (sp["shape"][d] - 1) * sp["spacing"][d] for d in sp["shape"]}


def extend_stack_props(stack_props, extend_by):
    """Stack properties extended outward by a physical amount on each side."""
    sdims = [d for d in SPATIAL_DIMS if d in stack_props["spacing"]]
    if not isinstance(extend_by, dict):
        extend_by = {d: extend_by for d in sdims}
    stack_props = {
        "shape": dict(stack_props["shape"]),
        "spacing": dict(stack_props["spacing"]),
        "origin": dict(stack_props["origin"]),
        **{k: v for k, v in stack_props.items() if k not in ("shape", "spacing", "origin")},
    }
    for d, val in extend_by.items():
        stack_props["shape"][d] += int(np.ceil(2 * val / stack_props["spacing"][d]))
        stack_props["origin"][d] -= val
    return stack_props


def get_center_of_sim(sim: Sim, transform_key=None) -> np.ndarray:
    """Physical centre of the sim, mapped through ``transform_key``'s affine
    (its first timepoint) when a key is given."""
    center = np.array([
        sim.origin[d] + sim.spacing[d] * (sim.sizes[d] - 1) / 2 for d in sim.spatial_dims
    ])
    if transform_key is not None:
        aff = get_affine_from_sim(sim, transform_key).squeeze()
        if aff.ndim == 3:
            aff = aff[0]
        center = param_utils.transform_pts([center], aff)[0]
    return center


def get_affine_from_sim(sim: Sim, transform_key: str) -> XAffine:
    if transform_key not in sim.transforms:
        raise KeyError(f"Transform key {transform_key} not found in sim")
    return sim.transforms[transform_key]


def get_tranform_keys_from_sim(sim: Sim):
    """The sim's transform keys (the reference's spelling)."""
    return list(sim.transforms.keys())


def set_sim_affine(sim: Sim, xaffine, transform_key: str = DEFAULT_TRANSFORM_KEY,
                   base_transform_key: Optional[str] = None):
    """Attach an affine under ``transform_key``; with ``base_transform_key``,
    the affine chained after that key's (``xaffine @ base``, over the outer
    join of their timepoints)."""
    xaffine = param_utils.to_xaffine(xaffine)
    if base_transform_key is not None:
        xaffine = param_utils.rebase_affine(xaffine, get_affine_from_sim(sim, base_transform_key))
    sim.transforms[transform_key] = xaffine
    return sim


def sim_sel_coords(sim: Sim, sel_dict: Dict[str, Any]) -> Sim:
    """Select by coordinate value.

    Non-spatial dims select by exact coord value; spatial dims accept
    world-coordinate slices (inclusive bounds, like xarray label slicing),
    which crop the sim's point sets too.
    """
    indexers = {}
    spatial_window = {}
    for dim, value in sel_dict.items():
        if dim in sim.spatial_dims and isinstance(value, slice):
            o, sp = sim.origin[dim], sim.spacing[dim]
            lo = value.start if value.start is not None else -np.inf
            hi = value.stop if value.stop is not None else np.inf
            i0 = max(0, int(np.ceil((lo - o) / sp - 1e-9)))
            i1 = min(sim.sizes[dim] - 1, int(np.floor((hi - o) / sp + 1e-9)))
            indexers[dim] = slice(i0, i1 + 1)
            spatial_window[dim] = (o + i0 * sp, o + i1 * sp)
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
    out = sim.isel(indexers)
    if spatial_window and "point_sets" in out.attrs:
        # a spatial crop crops the point sets to the pixel centres it keeps
        out.attrs = dict(out.attrs)
        out.attrs["point_sets"] = {
            key: point_set_sel_coords(
                pts, {d: slice(*spatial_window[d]) for d in spatial_window},
                sdims=sim.spatial_dims,
            )
            for key, pts in out.attrs["point_sets"].items()
        }
    return out


def point_set_sel_coords(point_set, sel_dict, sdims=("z", "y", "x")):
    """The points of an (N, ndim) set within world-coordinate bounds:
    ``sel_dict`` maps spatial dims to slices (inclusive bounds) or values
    (matched within 1e-9); the columns follow the last ndim of ``sdims``."""
    pts = np.asarray(point_set, dtype=float)
    if pts.ndim != 2:
        raise ValueError(f"point set must be (N, ndim), got {pts.shape}")
    dims = list(sdims)[-pts.shape[1]:]
    keep = np.ones(len(pts), dtype=bool)
    for i, d in enumerate(dims):
        if d not in sel_dict:
            continue
        v = sel_dict[d]
        if isinstance(v, slice):
            lo = v.start if v.start is not None else -np.inf
            hi = v.stop if v.stop is not None else np.inf
            keep &= (pts[:, i] >= lo - 1e-9) & (pts[:, i] <= hi + 1e-9)
        else:
            keep &= np.abs(pts[:, i] - float(v)) <= 1e-9
    return pts[keep]


def process_fields(sim: Sim, func, **func_kwargs) -> Sim:
    """``func`` applied to the spatial array of every non-spatial field
    (every (t, c) pair), reassembled; ``func`` must keep the shape."""
    nsdims = get_nonspatial_dims_from_sim(sim)
    data = sim.to_numpy()
    lead = data.shape[: len(nsdims)]
    flat = data.reshape((-1,) + data.shape[len(nsdims):])
    out = np.stack([np.asarray(func(f, **func_kwargs)) for f in flat])
    if out.shape[1:] != flat.shape[1:]:
        raise ValueError(
            f"func changed the spatial shape {flat.shape[1:]} -> "
            f"{out.shape[1:]}; process_fields requires same-shape output."
        )
    return sim.copy(data=out.reshape(lead + out.shape[1:]))


def get_sim_field(sim: Sim, ns_coords: Optional[Dict[str, Any]] = None) -> Sim:
    """The spatial sim of one field: each non-spatial dim selected at the
    coordinate ``ns_coords`` gives (its first by default)."""
    nsdims = get_nonspatial_dims_from_sim(sim)
    if not nsdims:
        return sim
    ns_coords = ns_coords or {}
    sel = {nd: ns_coords.get(nd, np.asarray(sim.coords[nd])[0]) for nd in nsdims}
    return sim_sel_coords(sim, sel)


def max_project_sim(sim: Sim, dim: str) -> Sim:
    """Maximum-intensity projection along a spatial dim (NaN ignored, as
    ``np.nanmax``); the transforms lose that dim's row and column. A sim
    over a device tensor is projected on its device."""
    axis = sim.dim_index(dim)
    if isinstance(sim.data, torch.Tensor):
        data = _nanmax_tensor(sim.data, axis)
    else:
        data = np.nanmax(sim.to_numpy(), axis=axis)
    out = Sim(
        data=data,
        dims=tuple(d for d in sim.dims if d != dim),
        spacing={d: v for d, v in sim.spacing.items() if d != dim},
        origin={d: v for d, v in sim.origin.items() if d != dim},
        coords={d: v for d, v in sim.coords.items() if d != dim},
        name=sim.name,
        attrs=dict(sim.attrs),
    )
    ndim_in = len(sim.spatial_dims)
    keep = [i for i, d in enumerate(sim.spatial_dims) if d != dim] + [ndim_in]
    for key, xaff in sim.transforms.items():
        data_t = xaff.data[..., keep, :][..., :, keep]
        out.transforms[key] = XAffine(data_t, t_coords=xaff.t_coords)
    return out


def _nanmax_tensor(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.nanmax`` of a tensor along ``axis``, in its dtype. The unsigned
    16 to 64 bit types have no reductions in torch and reduce through a
    wider signed type."""
    if x.is_floating_point():
        isnan = torch.isnan(x)
        m = torch.where(isnan, torch.tensor(-torch.inf, dtype=x.dtype, device=x.device), x)
        m = m.amax(dim=axis)
        return torch.where(isnan.all(dim=axis), torch.tensor(torch.nan, dtype=x.dtype,
                                                             device=x.device), m)
    if x.dtype in (torch.uint16, torch.uint32):
        return x.to(torch.int64).amax(dim=axis).to(x.dtype)
    return x.amax(dim=axis)


def serialize_zarr_backed_sim(sim: Sim) -> dict:
    """A JSON-able payload of a zarr-backed sim, for work spread over
    processes: where its zarr array lies (``zarr_spec``: the array's path
    and, for a view of a larger array, the view's selection), its physical
    metadata and transforms. The data is reopened where the payload is
    read, never shipped."""
    from multiview_stitcher_torch.io.zarr_backend import LazyZarrArray

    data = sim.data
    if not isinstance(data, LazyZarrArray):
        raise ValueError(
            "serialize_zarr_backed_sim requires a zarr-backed sim "
            "(data opened through io.zarr_backend / io.ngff_utils)."
        )
    return {
        "zarr_spec": data.spec(),
        "dims": list(sim.dims),
        "spacing": {d: float(v) for d, v in sim.spacing.items()},
        "origin": {d: float(v) for d, v in sim.origin.items()},
        "c_coords": np.asarray(sim.coords["c"]).tolist() if "c" in sim.dims else None,
        "t_coords": np.asarray(sim.coords["t"]).tolist() if "t" in sim.dims else None,
        "transforms": {
            k: {
                "data": np.asarray(v.data).tolist(),
                "t_coords": np.asarray(v.t_coords).tolist() if v.t_coords is not None else None,
            }
            for k, v in sim.transforms.items()
        },
    }


def deserialize_zarr_backed_sim(payload: dict) -> Sim:
    """The lazy zarr-backed sim of a :func:`serialize_zarr_backed_sim`
    payload."""
    from multiview_stitcher_torch.io.zarr_backend import LazyZarrArray

    sim = get_sim_from_array(
        LazyZarrArray.from_spec(payload["zarr_spec"]),
        dims=tuple(payload["dims"]),
        scale=payload["spacing"],
        translation=payload["origin"],
        c_coords=payload["c_coords"],
        t_coords=payload["t_coords"],
    )
    sim.transforms = {
        k: XAffine(
            np.asarray(v["data"]),
            t_coords=np.asarray(v["t_coords"]) if v["t_coords"] is not None else None,
        )
        for k, v in payload["transforms"].items()
    }
    return sim


def set_point_set(sim: Sim, points, points_key: str = "beads"):
    """Attach a named point set: (N, ndim) intrinsic physical coordinates."""
    sim.attrs.setdefault("point_sets", {})[points_key] = np.asarray(points, dtype=float)
    return sim


def get_point_set(sim: Sim, points_key: str = "beads") -> np.ndarray:
    return sim.attrs["point_sets"][points_key]


def normalize_to_spatial_dict(value, sdims, name="value"):
    """A number for every spatial dim, from one number or a dict per dim."""
    if isinstance(value, dict):
        missing = [d for d in sdims if d not in value]
        if missing:
            raise ValueError(f"{name} is missing values for spatial dimensions {missing}.")
        return {d: float(value[d]) for d in sdims}
    return {d: float(value) for d in sdims}


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a sim's ``dtype``: a sim over a torch tensor has a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def get_default_spatial_chunksizes(ndim: int):
    if ndim not in (2, 3):
        raise ValueError(f"only 2D and 3D sims are supported, got {ndim}D")
    return dict(
        DEFAULT_SPATIAL_CHUNKSIZES_2D if ndim == 2 else DEFAULT_SPATIAL_CHUNKSIZES_3D
    )


def ensure_time_dim(sim: Sim) -> Sim:
    """The sim with a ``t`` dim (of length 1 when it had none); its affines
    gain that timepoint."""
    if "t" in sim.dims:
        return sim
    out = sim.expand_dims("t")
    for key, xaff in list(out.transforms.items()):
        if not xaff.has_t:
            out.transforms[key] = XAffine(xaff.data[None], t_coords=out.coords["t"])
    return out


def ensure_dim(sim: Sim, dim: str) -> Sim:
    """The sim with ``dim`` (of length 1 when it had none)."""
    if dim in sim.dims:
        return sim
    if dim == "t":
        return ensure_time_dim(sim)
    return sim.expand_dims(dim)


def _merge_transforms(sims: Sequence[Sim], dim: str, coords) -> Dict[str, XAffine]:
    """The transforms of a combine: the union of the inputs' keys (a key
    only some inputs carry keeps its first carrier's affine); a key every
    input carries is concatenated over ``t`` when ``dim`` is t (an affine
    without t repeated over its sim's timepoints), else the first input's."""
    out = {}
    keys: list = []
    for s in sims:
        for k in s.transforms:
            if k not in keys:
                keys.append(k)
    for key in keys:
        carriers = [s for s in sims if key in s.transforms]
        if len(carriers) < len(sims) or dim != "t":
            out[key] = carriers[0].transforms[key].copy()
            continue
        datas = []
        for s in sims:
            x = s.transforms[key]
            if x.has_t:
                datas.append(x.data)
            else:
                nt = len(np.asarray(s.coords.get("t", np.arange(1))))
                datas.append(np.broadcast_to(x.data, (nt,) + x.data.shape))
        out[key] = XAffine(np.concatenate(datas), t_coords=np.asarray(coords))
    return out


def concat(sims: Sequence[Sim], dim: str) -> Sim:
    """Concatenate sims along an existing or new non-spatial dim. When every
    input is lazy the result stays lazy (``zarr_utils.concatenate``)."""
    sims = [ensure_dim(s, dim) for s in sims]
    axis = sims[0].dim_index(dim)
    if all(_is_lazy(s.data) for s in sims):
        from multiview_stitcher_torch import zarr_utils

        data = zarr_utils.concatenate([s.data for s in sims], axis=axis)
    else:
        data = np.concatenate([s.to_numpy() for s in sims], axis=axis)
    coords = np.concatenate([np.asarray(s.coords[dim]) for s in sims])
    out = sims[0].copy(data=data)
    out.coords[dim] = coords
    out.transforms = _merge_transforms(sims, dim, coords)
    return out


def stack(sims: Sequence[Sim], dim: str, coords=None) -> Sim:
    """Stack sims along a new non-spatial dim (coordinates ``coords``, by
    default 0, 1, ...)."""
    if dim in sims[0].dims:
        raise ValueError(
            f"stack dim {dim!r} already exists; use concat to join along an existing dim."
        )
    out = concat([s.expand_dims(dim, coords=[i]) for i, s in enumerate(sims)], dim)
    if coords is not None:
        out.coords[dim] = np.asarray(coords)
    return out
