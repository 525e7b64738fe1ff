"""Multiscale images ("msims"), at one level; the pyramid plan and
block-mean downsampling that OME-Zarr output writes its levels with.

:class:`Msim` holds the levels of an image and the named transforms they
share. Registration takes msims of one level, as ``get_msim_from_sim(sim,
scale_factors=[])`` builds them; pyramids of more levels are not ported yet
(ROADMAP.md, queue 1: item 16). An msim is any non-:class:`~.si_utils.Sim`
object with the multiscale interface (a ``sims`` list of scales and
``get_scale``), so that ``fuse`` can refuse one with a clear error.
:func:`calc_resolution_levels` and :func:`_coarsen_mean` are copies of the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from multiview_stitcher_torch import param_utils, si_utils
from multiview_stitcher_torch.param_utils import XAffine
from multiview_stitcher_torch.si_utils import Sim

_MULTISCALE = "multiscale msims are not ported yet (ROADMAP.md, queue 1: item 16)"


@dataclass
class Msim:
    """Multiscale image: ``sims[0]`` is level "scale0"; ``transforms`` are
    shared by all levels."""

    sims: List[Sim]
    transforms: Dict[str, XAffine] = field(default_factory=dict)
    attrs: Dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.transforms and self.sims and self.sims[0].transforms:
            self.transforms = {k: v.copy() for k, v in self.sims[0].transforms.items()}

    @property
    def scale_keys(self) -> List[str]:
        return [f"scale{i}" for i in range(len(self.sims))]

    def get_scale(self, scale="scale0") -> Sim:
        """The level as a sim over the same data, carrying the transforms."""
        idx = int(scale.replace("scale", "")) if isinstance(scale, str) else int(scale)
        sim = self.sims[idx].copy()
        sim.transforms = {k: v.copy() for k, v in self.transforms.items()}
        return sim


def get_msim_from_sim(sim: Sim, scale_factors=None) -> Msim:
    """One-level msim over ``sim`` (``scale_factors=[]``)."""
    if scale_factors is None or len(scale_factors):
        raise NotImplementedError(_MULTISCALE)
    return Msim(sims=[sim.copy()])


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
    """Select non-spatial coordinates on every level."""
    if "t" in sel_dict:
        raise NotImplementedError(
            "selecting t is not ported yet (ROADMAP.md, queue 1: item 23, "
            "registration over t)"
        )
    return Msim(
        sims=[si_utils.sim_sel_coords(s, sel_dict) for s in msim.sims],
        transforms={k: v.copy() for k, v in msim.transforms.items()},
        attrs=dict(msim.attrs),
    )


def get_res_level_from_binning_factors(msim: Msim, binning_factors: Dict[str, int]) -> str:
    """Coarsest level not exceeding the requested binning per dim."""
    if len(msim.sims) != 1:
        raise NotImplementedError(_MULTISCALE)
    return "scale0"


def is_msim(image) -> bool:
    return (
        not isinstance(image, Sim)
        and hasattr(image, "sims")
        and hasattr(image, "get_scale")
    )


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
